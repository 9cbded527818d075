"""ScanNet, Semantic3D and NPM3D datasets (counterpart of
contrastboundary_tpu/data/datasets.py: the same class lists, label maps,
splits and submission files).

Each reads the common room format, ``<name>.npy`` float32 xyzrgb[raw label]
arrays, and maps raw labels to contiguous training indices with the
ignored classes dropped (``LabelMap``). The raw files are converted by
data/prepare_scannet.py (ScanNet meshes) and data/ingest.py (Semantic3D
ascii, NPM3D ply); their test scans carry ``<name>_proj.npy``, each raw
point's nearest subsampled point, for the benchmarks' submission files.
"""
from __future__ import annotations

import os
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np

SCANNET_NAMES = [
    "wall", "floor", "cabinet", "bed", "chair", "sofa", "table", "door",
    "window", "bookshelf", "picture", "counter", "desk", "curtain",
    "refrigerator", "shower curtain", "toilet", "sink", "bathtub",
    "otherfurniture",
]
# raw ScanNet label ids of the 20-class benchmark (scannetv2-labels tsv)
SCANNET_RAW_IDS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]

SEMANTIC3D_NAMES = [
    "man-made terrain", "natural terrain", "high vegetation",
    "low vegetation", "buildings", "hard scape", "scanning artefacts", "cars",
]

NPM3D_NAMES = [
    "ground", "building", "pole", "bollard", "trash can", "barrier",
    "pedestrian", "car", "natural",
]


class LabelMap:
    """Raw label ↔ training index, ignored raw labels dropped: the valid
    labels get contiguous indices, ignored ones ``ignore_index``."""

    def __init__(self, raw_labels: Sequence[int], ignored: Sequence[int] = (),
                 ignore_index: int = -1):
        self.valid = [l for l in raw_labels if l not in set(ignored)]
        self.ignore_index = ignore_index
        size = max(list(raw_labels) + list(ignored)) + 2
        self.to_idx = np.full(size, ignore_index, np.int32)
        for i, l in enumerate(self.valid):
            self.to_idx[l] = i
        self.to_label = np.asarray(self.valid, np.int32)

    @property
    def num_classes(self):
        return len(self.valid)

    def __call__(self, raw: np.ndarray) -> np.ndarray:
        # raw ids outside the table are clipped into it: negatives map as 0,
        # ids past the largest as the one past it (ignore_index)
        return self.to_idx[np.clip(raw.astype(np.int64), 0, len(self.to_idx) - 1)]

    def inverse(self, idx: np.ndarray) -> np.ndarray:
        return self.to_label[idx]


class _NpyRoomDataset:
    """A directory of ``<room>.npy`` xyzrgb[l] arrays, loaded once each."""

    label_map: Optional[LabelMap] = None

    def __init__(self, data_root: str, names: List[str], loop: int = 1):
        if not names:
            raise FileNotFoundError(f"no rooms found in {data_root}")
        self.data_root = data_root
        self.names = names
        self.loop = loop
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.names) * self.loop

    @property
    def num_rooms(self):
        return len(self.names)

    def room(self, i: int):
        name = self.names[i % len(self.names)]
        if name not in self._cache:
            self._cache[name] = np.load(os.path.join(self.data_root, name + ".npy"))
        d = self._cache[name]
        coord = d[:, 0:3].copy()
        feat = d[:, 3:6].copy() if d.shape[1] >= 6 else np.zeros_like(coord)
        if d.shape[1] >= 7:
            raw = d[:, 6].astype(np.int64)
            label = self.label_map(raw) if self.label_map else raw.astype(np.int64)
        else:
            label = np.full(len(d), -1, np.int64)
        return coord, feat, label


class ScanNetDataset(_NpyRoomDataset):
    """ScanNet v2 scenes (data/prepare_scannet.py's npy files, raw label
    ids): the 20-class benchmark, every other id ignored. ``val_list`` names
    the val scenes; without it every split holds every scene."""

    def __init__(self, data_root: str, split: str = "train", loop: int = 1,
                 val_list: Optional[Sequence[str]] = None):
        self.label_map = LabelMap(
            raw_labels=list(range(41)),
            ignored=[l for l in range(41) if l not in SCANNET_RAW_IDS],
        )
        all_names = sorted(f[:-4] for f in os.listdir(data_root) if f.endswith(".npy"))
        if val_list is not None:
            val = set(val_list)
            names = [n for n in all_names if (n in val) == (split != "train")]
        else:
            names = all_names
        super().__init__(data_root, names, loop)


def _split_dir_names(data_root: str, split: str):
    """(dir, names) of a split: data/ingest.py writes ``<root>/train`` and
    ``<root>/test``; a flat directory of npy files serves every split.
    ``*_proj.npy`` projection files are not rooms."""
    sub = os.path.join(data_root, "test" if split == "test" else "train")
    d = sub if os.path.isdir(sub) else data_root
    names = sorted(f[:-4] for f in os.listdir(d)
                   if f.endswith(".npy") and not f.endswith("_proj.npy"))
    return d, names


def _proj_path(data_root: str, name: str) -> str:
    return os.path.join(data_root, name + "_proj.npy")


def raw_projection(dataset, name: str) -> Optional[np.ndarray]:
    """``dataset.projection(name)``, or None where the dataset has no raw
    projections (ScanNet, S3DIS) or the scan was saved without one."""
    if not hasattr(dataset, "projection") or not os.path.exists(
            _proj_path(dataset.data_root, name)):
        return None
    return dataset.projection(name)


def _write_label_files(out_dir: str, predictions: Dict[str, np.ndarray], label_map: LabelMap,
                       suffix: str) -> list:
    """One ascii file a scan, one raw label a line."""
    os.makedirs(out_dir, exist_ok=True)
    files = []
    for name, pred_idx in predictions.items():
        path = os.path.join(out_dir, f"{name}{suffix}")
        np.savetxt(path, label_map.inverse(pred_idx), fmt="%d")
        files.append(path)
    return files


class Semantic3DDataset(_NpyRoomDataset):
    """Semantic3D outdoor scans: 8 classes, raw label 0 (unlabeled)
    ignored; converted by data/ingest.py::prepare_semantic3d."""

    def __init__(self, data_root: str, split: str = "train", loop: int = 1):
        self.label_map = LabelMap(raw_labels=list(range(9)), ignored=[0])
        self.split = split
        d, names = _split_dir_names(data_root, split)
        super().__init__(d, names, loop)

    def projection(self, name: str) -> np.ndarray:
        """Raw point → subsampled point index (test submissions)."""
        return np.load(_proj_path(self.data_root, name))

    @staticmethod
    def write_submission(out_dir: str, predictions: Dict[str, np.ndarray],
                         zip_name: str = "submission.zip") -> str:
        """The benchmark's submission: ascii ``<name>.labels`` files (raw
        ids, one a line) and a zip of them → the zip's path."""
        files = _write_label_files(out_dir, predictions,
                                   LabelMap(raw_labels=list(range(9)), ignored=[0]), ".labels")
        zpath = os.path.join(out_dir, zip_name)
        with zipfile.ZipFile(zpath, "w", zipfile.ZIP_DEFLATED) as z:
            for f in files:
                z.write(f, os.path.basename(f))
        return zpath


class NPM3DDataset(_NpyRoomDataset):
    """Paris-Lille-3D (NPM3D): 9 coarse classes, raw 0 (unclassified)
    ignored; converted by data/ingest.py::prepare_npm3d."""

    def __init__(self, data_root: str, split: str = "train", loop: int = 1):
        self.label_map = LabelMap(raw_labels=list(range(10)), ignored=[0])
        self.split = split
        d, names = _split_dir_names(data_root, split)
        super().__init__(d, names, loop)

    def projection(self, name: str) -> np.ndarray:
        """Raw point → subsampled point index (test submissions)."""
        return np.load(_proj_path(self.data_root, name))

    @staticmethod
    def write_submission(out_dir: str, predictions: Dict[str, np.ndarray]) -> list:
        """The benchmark's format: one ascii ``<name>.txt`` a scan, one raw
        class id a line → the files."""
        return _write_label_files(out_dir, predictions,
                                  LabelMap(raw_labels=list(range(10)), ignored=[0]), ".txt")
