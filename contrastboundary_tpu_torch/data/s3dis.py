"""S3DIS dataset and batch iterator, and a procedural synthetic stand-in
(counterpart of contrastboundary_tpu/data/s3dis.py: the same rooms, sample
order and draws, so a seed gives the same batches bit for bit).

S3DISDataset reads rooms stored as ``Area_<i>_<room>.npy`` files of xyzrgbl
``[N, 7]``: train = every area but ``test_area``, val = that area, ``loop``
passes per epoch. Batches are dense ``[B, n_points, ...]`` (fixed-size crops
padded by repetition, data/pipeline.py).

SyntheticSceneDataset generates procedural rooms (floor/ceiling/walls +
furniture boxes with class-coloured noise) with S3DIS's 13-class layout, so
the whole train/eval stack runs without the (licence-gated) dataset. Room
geometry is deterministic per (seed, index).
"""
from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from .pipeline import PotentialSampler, pad_to_fixed_size, prepare_crop

S3DIS_NAMES = [
    "ceiling", "floor", "wall", "beam", "column", "window", "door",
    "table", "chair", "sofa", "bookcase", "board", "clutter",
]


class S3DISDataset:
    """Rooms from a directory of xyzrgbl .npy files."""

    def __init__(
        self,
        data_root: str,
        split: str = "train",
        test_area: int = 5,
        loop: int = 30,
    ):
        names = sorted(
            f[:-4] for f in os.listdir(data_root) if f.startswith("Area_") and f.endswith(".npy")
        )
        tag = f"Area_{test_area}"
        if split == "train":
            names = [n for n in names if tag not in n]
        else:
            names = [n for n in names if tag in n]
        if not names:
            raise FileNotFoundError(f"no rooms for split={split} in {data_root}")
        self.data_root = data_root
        self.names = names
        self.split = split
        self.loop = loop if split == "train" else 1
        self._cache: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self.names) * self.loop

    def room(self, i: int):
        name = self.names[i % len(self.names)]
        if name not in self._cache:
            self._cache[name] = np.load(os.path.join(self.data_root, name + ".npy"))
        d = self._cache[name]
        return d[:, 0:3].copy(), d[:, 3:6].copy(), d[:, 6].astype(np.int64).copy()

    @property
    def num_rooms(self):
        return len(self.names)


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


def make_batch_iterator(
    dataset,
    batch_size: int,
    n_points: int,
    seed: int = 0,
    epoch: int = 0,
    transform=None,
    voxel_size: float = 0.04,
    voxel_max: Optional[int] = None,
    split: str = "train",
    shard_index: int = 0,
    num_shards: int = 1,
    crop_mode: str = "count",
    in_radius: float = 2.0,
    sampler: str = "random",
    potential_state=None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batches {points, features, labels, src_idx, room_idx}.

    Sample order is a seeded permutation of len(dataset); each host takes a
    strided shard (the per-host input-pipeline pattern replacing the
    reference's per-GPU `iter.get_next()` / DistributedSampler).

    sampler='potential': crop centers come from the stateful
    spatially-regular potential sampler (data/pipeline.py::PotentialSampler,
    the reference ConvNet recipe's tensorflow/datasets/base.py:352-448) —
    pass the same `potential_state` across epochs to keep coverage
    accumulating; augmentation applies to the crop, then fixed-size pad.
    """
    order_rng = np.random.default_rng((seed, epoch))
    order = order_rng.permutation(len(dataset))[shard_index::num_shards]
    voxel_max = voxel_max or n_points

    n_batches = len(order) // batch_size
    if sampler == "potential":
        if potential_state is None:
            potential_state = PotentialSampler(
                dataset, voxel_size, in_radius=in_radius, cap=voxel_max,
                seed=seed + shard_index,
            )
        for b in range(n_batches):
            pts, fts, lbs, srcs, rooms = [], [], [], [], []
            for j in range(batch_size):
                rng = np.random.default_rng(
                    (seed, epoch, shard_index, b * batch_size + j)
                )
                ci, idx = potential_state.next(rng)
                coord, feat, label = potential_state.crop(ci, idx)
                if transform is not None:
                    coord, feat, label = transform(rng, coord, feat, label)
                perm = rng.permutation(len(coord))
                coord, feat, label = coord[perm], feat[perm], label[perm]
                coord = (coord - coord.min(0)).astype(np.float32)
                feat = feat.astype(np.float32) / 255.0
                label = label.astype(np.int32)
                coord, feat, label, src = pad_to_fixed_size(
                    coord, feat, label, n_points, rng
                )
                pts.append(coord)
                fts.append(feat)
                lbs.append(label)
                srcs.append(src)
                rooms.append(ci)
            yield {
                "points": np.stack(pts),
                "features": np.stack(fts),
                "labels": np.stack(lbs),
                "src_idx": np.stack(srcs),
                "room_idx": np.asarray(rooms, np.int32),
            }
        return
    for b in range(n_batches):
        pts, fts, lbs, srcs, rooms = [], [], [], [], []
        for j in range(batch_size):
            idx = int(order[b * batch_size + j])
            rng = np.random.default_rng((seed, epoch, idx))
            coord, feat, label = dataset.room(idx)
            coord, feat, label = prepare_crop(
                coord, feat, label, rng,
                voxel_size=voxel_size, voxel_max=voxel_max,
                transform=transform, split=split,
                crop_mode=crop_mode, in_radius=in_radius,
            )
            coord, feat, label, src = pad_to_fixed_size(
                coord, feat, label, n_points, rng
            )
            pts.append(coord)
            fts.append(feat)
            lbs.append(label)
            srcs.append(src)
            rooms.append(idx % dataset.num_rooms)
        yield {
            "points": np.stack(pts),
            "features": np.stack(fts),
            "labels": np.stack(lbs),
            "src_idx": np.stack(srcs),
            "room_idx": np.asarray(rooms, np.int32),
        }
