"""Raw ingest of Semantic3D (ascii) and NPM3D / Paris-Lille-3D (ply)
(counterpart of contrastboundary_tpu/data/ingest.py: the same files, byte
for byte).

Each scan is grid-subsampled (native.py) and written as
``<out>/<split>/<name>.npy``, float32 columns xyz rgb [raw label]; a scan
without labels goes to the test split with ``<name>_proj.npy``, each raw
point's nearest subsampled point (a cKDTree query), so that submissions
carry a prediction for every raw point.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..native import grid_subsample
from ..utils.ply import read_ply


def read_semantic3d_txt(
    txt_path: str, labels_path: Optional[str] = None, chunk_lines: int = 2_000_000
) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Chunked ascii reader of columns x y z intensity r g b (xyz and rgb
    kept) → (points f32 [N, 3], colors f32 [N, 3], labels i32 [N] | None)."""
    pts, cols = [], []
    with open(txt_path) as f:
        while True:
            chunk = f.readlines(chunk_lines * 64)
            if not chunk:
                break
            data = np.loadtxt(chunk, dtype=np.float32, ndmin=2)
            pts.append(data[:, 0:3])
            cols.append(data[:, 4:7] if data.shape[1] >= 7 else data[:, 3:6])
    points = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
    colors = np.concatenate(cols) if cols else np.zeros((0, 3), np.float32)
    labels = None
    if labels_path and os.path.exists(labels_path):
        labels = np.loadtxt(labels_path, dtype=np.int32, ndmin=1)
        if len(labels) != len(points):
            raise ValueError(f"{txt_path}: {len(points)} points vs {len(labels)} labels")
    return points, colors, labels


def read_npm3d_ply(ply_path: str):
    """NPM3D ply, x y z reflectance [class]: the reflectance repeated as 3
    feature channels → (points f32 [N, 3], feats f32 [N, 3], labels i32
    [N] | None)."""
    data = read_ply(ply_path)
    points = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    refl = data.get("reflectance")
    if refl is None:
        refl = np.zeros(len(points), np.float32)
    feats = np.repeat(refl.astype(np.float32)[:, None], 3, axis=1)
    labels = data.get("class")
    if labels is not None:
        labels = labels.astype(np.int32)
    return points, feats, labels


def _save_room(out_dir: str, name: str, points: np.ndarray, feats: np.ndarray,
               labels: Optional[np.ndarray], voxel_size: float, num_raw_classes: int,
               with_proj: bool) -> str:
    """Grid-subsample one scan and save it (and its raw → sub projection)."""
    os.makedirs(out_dir, exist_ok=True)
    sub_p, sub_f, sub_l = grid_subsample(points, feats, labels, cell=voxel_size,
                                         num_classes=num_raw_classes)
    cols = [sub_p, sub_f]
    if sub_l is not None:
        cols.append(sub_l.astype(np.float32)[:, None])
    path = os.path.join(out_dir, name + ".npy")
    np.save(path, np.concatenate(cols, axis=1).astype(np.float32))
    if with_proj:
        from scipy.spatial import cKDTree

        _, proj = cKDTree(sub_p).query(points, k=1)
        np.save(os.path.join(out_dir, name + "_proj.npy"), proj.astype(np.int64))
    return path


def prepare_semantic3d(raw_dir: str, out_dir: str, voxel_size: float = 0.06,
                       num_raw_classes: int = 9, verbose: bool = True) -> dict:
    """Ingest every ``<name>.txt`` of raw_dir: a scan with a ``<name>.labels``
    file goes to ``<out_dir>/train``, the others to ``<out_dir>/test`` with
    their projections."""
    done = {"train": [], "test": []}
    for fn in sorted(os.listdir(raw_dir)):
        if not fn.endswith(".txt"):
            continue
        name = fn[:-4]
        points, colors, labels = read_semantic3d_txt(
            os.path.join(raw_dir, fn), os.path.join(raw_dir, name + ".labels"))
        split = "train" if labels is not None else "test"
        _save_room(os.path.join(out_dir, split), name, points, colors, labels, voxel_size,
                   num_raw_classes, with_proj=split == "test")
        done[split].append(name)
        if verbose:
            print(f"semantic3d {name}: {len(points)} pts → {split}")
    return done


def prepare_npm3d(raw_dir: str, out_dir: str, voxel_size: float = 0.08,
                  num_raw_classes: int = 10, verbose: bool = True) -> dict:
    """Ingest every ``<name>.ply`` of raw_dir: a scan with a 'class' field
    goes to train, the others to test with their projections."""
    done = {"train": [], "test": []}
    for fn in sorted(os.listdir(raw_dir)):
        if not fn.endswith(".ply"):
            continue
        name = fn[:-4]
        points, feats, labels = read_npm3d_ply(os.path.join(raw_dir, fn))
        split = "train" if labels is not None else "test"
        _save_room(os.path.join(out_dir, split), name, points, feats, labels, voxel_size,
                   num_raw_classes, with_proj=split == "test")
        done[split].append(name)
        if verbose:
            print(f"npm3d {name}: {len(points)} pts → {split}")
    return done


def load_test_projection(data_root: str, name: str) -> np.ndarray:
    """The raw → subsampled point index that the ingest saved."""
    return np.load(os.path.join(data_root, name + "_proj.npy"))
