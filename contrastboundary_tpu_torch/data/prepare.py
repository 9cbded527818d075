"""One-time S3DIS raw → npy conversion (counterpart of
contrastboundary_tpu/data/prepare.py: the same files, byte for byte).

Reads the Stanford "Aligned_Version" layout
``<root>/Area_<i>/<room>/Annotations/<class>_<k>.txt`` (x y z r g b rows)
and writes ``<out>/Area_<i>_<room>.npy``, float32 [N, 7] (xyz rgb label),
the files data/s3dis.py::S3DISDataset reads. A class name outside
S3DIS_NAMES is labelled clutter.

    python -m contrastboundary_tpu_torch.data.prepare <raw root> <out dir>
"""
from __future__ import annotations

import glob
import os

import numpy as np

from .s3dis import S3DIS_NAMES

_NAME_TO_ID = {n: i for i, n in enumerate(S3DIS_NAMES)}


def room_to_array(room_dir: str) -> np.ndarray:
    parts = []
    ann = os.path.join(room_dir, "Annotations")
    for f in sorted(glob.glob(os.path.join(ann, "*.txt"))):
        cls = os.path.basename(f).split("_")[0]
        label = _NAME_TO_ID.get(cls, _NAME_TO_ID["clutter"])
        data = np.loadtxt(f, dtype=np.float32)
        if data.ndim == 1:
            data = data[None]
        lab = np.full((len(data), 1), label, np.float32)
        parts.append(np.concatenate([data[:, :6], lab], axis=1))
    if not parts:
        raise FileNotFoundError(f"no annotation files under {ann}")
    return np.concatenate(parts)


def prepare_s3dis(raw_root: str, out_dir: str, verbose: bool = True):
    """Convert every room of every area; rooms already converted are
    skipped → the files written."""
    os.makedirs(out_dir, exist_ok=True)
    converted = []
    for area in sorted(glob.glob(os.path.join(raw_root, "Area_*"))):
        area_name = os.path.basename(area)
        for room in sorted(os.listdir(area)):
            room_dir = os.path.join(area, room)
            if not os.path.isdir(room_dir):
                continue
            out = os.path.join(out_dir, f"{area_name}_{room}.npy")
            if os.path.exists(out):
                continue
            arr = room_to_array(room_dir)
            np.save(out, arr)
            converted.append(out)
            if verbose:
                print(f"{out}: {arr.shape}")
    return converted


if __name__ == "__main__":
    import sys

    prepare_s3dis(sys.argv[1], sys.argv[2])
