"""Procedural rooms and voxel-grid dedup (copies of
contrastboundary_tpu/data/s3dis.py::SyntheticSceneDataset and
data/pipeline.py::voxelize that give the same arrays from the same seed).

SyntheticSceneDataset generates rooms with S3DIS's 13-class layout
(floor/ceiling/walls + furniture boxes, rgb = class colour + noise),
deterministic per (seed, room index).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def voxelize(
    coord: np.ndarray,
    voxel_size: float,
    rng: Optional[np.random.Generator] = None,
    mode: str = "train",
):
    """Voxel-grid dedup of a whole cloud.

    mode 'train': returns indices picking one random point per occupied voxel
    (pytorch/util/voxelize.py mode 0).
    mode 'val': returns (sorted_indices, counts_per_voxel) — every point kept,
    grouped by voxel (mode 1), for the enumerate-duplicates eval protocol.
    """
    v = np.floor((coord - coord.min(0)) / voxel_size).astype(np.int64)
    dims = v.max(0) + 1
    key = (v[:, 0] * dims[1] + v[:, 1]) * dims[2] + v[:, 2]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    _, starts, counts = np.unique(key_sorted, return_index=True, return_counts=True)
    if mode == "train":
        if rng is None:
            rng = np.random.default_rng()
        pick = starts + rng.integers(0, counts)
        return order[pick]
    return order, counts


class SyntheticSceneDataset:
    """Procedural rooms with S3DIS-like structure: 13 classes, planar
    surfaces (ceiling/floor/wall) + furniture boxes, rgb = class color +
    noise. Deterministic per (seed, room index)."""

    CLASS_COLORS = (
        np.array(
            [
                [200, 200, 200], [120, 90, 60], [180, 180, 160], [150, 150, 90],
                [160, 120, 120], [100, 150, 200], [140, 90, 40], [170, 120, 70],
                [90, 60, 40], [150, 60, 60], [110, 80, 50], [240, 240, 240],
                [100, 100, 100],
            ],
            np.float32,
        )
    )

    def __init__(
        self,
        num_rooms: int = 16,
        points_per_room: int = 120_000,
        seed: int = 0,
        split: str = "train",
        loop: int = 1,
        ignore_fraction: float = 0.0,
    ):
        self.num_rooms_ = num_rooms
        self.points_per_room = points_per_room
        self.seed = seed if split == "train" else seed + 10_000
        self.loop = loop
        # fraction of points with label -1 (exercises the ignore paths the
        # ScanNet/Semantic3D remaps produce)
        self.ignore_fraction = ignore_fraction
        self._cache: Dict[int, tuple] = {}

    def __len__(self):
        return self.num_rooms_ * self.loop

    @property
    def num_rooms(self):
        return self.num_rooms_

    def _surface(self, rng, n, origin, du, dv, normal_jitter=0.01):
        u = rng.random(n)[:, None]
        v = rng.random(n)[:, None]
        pts = origin + u * du + v * dv
        pts += rng.standard_normal((n, 3)) * normal_jitter
        return pts

    def _box(self, rng, n, center, size):
        # sample the 6 faces of an axis-aligned box
        face = rng.integers(0, 6, n)
        uv = rng.random((n, 2)) - 0.5
        pts = np.zeros((n, 3))
        for f in range(6):
            m = face == f
            ax = f // 2
            sign = 1.0 if f % 2 == 0 else -1.0
            oth = [a for a in range(3) if a != ax]
            pts[m, ax] = sign * size[ax] / 2
            pts[m, oth[0]] = uv[m, 0] * size[oth[0]]
            pts[m, oth[1]] = uv[m, 1] * size[oth[1]]
        return pts + center

    def room(self, i: int):
        i = i % self.num_rooms_
        if i in self._cache:
            c, f, l = self._cache[i]
            return c.copy(), f.copy(), l.copy()
        rng = np.random.default_rng(self.seed * 7919 + i)
        w, d, h = rng.uniform(4, 9), rng.uniform(4, 8), rng.uniform(2.6, 3.4)
        n = self.points_per_room
        parts: List[np.ndarray] = []
        labels: List[np.ndarray] = []

        def add(pts, cls):
            parts.append(pts)
            labels.append(np.full(len(pts), cls, np.int64))

        n_surf = n // 2
        add(self._surface(rng, n_surf // 3, np.zeros(3), [w, 0, 0], [0, d, 0]), 1)  # floor
        add(self._surface(rng, n_surf // 4, [0, 0, h], [w, 0, 0], [0, d, 0]), 0)  # ceiling
        nw = n_surf - n_surf // 3 - n_surf // 4
        for k, (o, du, dv) in enumerate(
            [
                ([0, 0, 0], [w, 0, 0], [0, 0, h]),
                ([0, d, 0], [w, 0, 0], [0, 0, h]),
                ([0, 0, 0], [0, d, 0], [0, 0, h]),
                ([w, 0, 0], [0, d, 0], [0, 0, h]),
            ]
        ):
            add(self._surface(rng, nw // 4, np.array(o, float), du, dv), 2)  # walls

        n_rest = n - sum(len(p) for p in parts)
        n_obj = max(int(rng.integers(6, 14)), 1)
        per = n_rest // n_obj
        for k in range(n_obj):
            cls = int(rng.integers(3, 13))
            size = rng.uniform(0.3, 1.5, 3)
            center = np.array(
                [rng.uniform(1, w - 1), rng.uniform(1, d - 1), size[2] / 2 + rng.uniform(0, 0.8)]
            )
            cnt = per if k < n_obj - 1 else n_rest - per * (n_obj - 1)
            add(self._box(rng, cnt, center, size), cls)

        coord = np.concatenate(parts).astype(np.float64)
        label = np.concatenate(labels)
        color = self.CLASS_COLORS[label] + rng.standard_normal((len(label), 3)) * 12
        color = np.clip(color, 0, 255).astype(np.float32)
        if self.ignore_fraction > 0:
            drop = rng.random(len(label)) < self.ignore_fraction
            label = np.where(drop, -1, label)
        self._cache[i] = (coord, color, label)
        return coord.copy(), color.copy(), label.copy()
