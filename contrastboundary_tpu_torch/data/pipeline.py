"""Host-side sample preparation: voxelize → crop → fixed-size pad
(counterpart of contrastboundary_tpu/data/pipeline.py: the same draws from
the caller's generator in the same order, so a seed gives the same crops bit
for bit).

Every crop is padded (by resampling its own points with replacement) to a
static ``n_points``, so the device sees one shape for the whole run. Padding
by repetition keeps every row a real point: KNN, BN and losses need no
validity masks, and the eval accumulators let duplicates vote once.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def crop_around(coord: np.ndarray, center_i: int, voxel_max: int,
                crop_mode: str = "count", in_radius: float = 2.0) -> np.ndarray:
    """Rows of the crop around row ``center_i``: 'count' the ``voxel_max``
    nearest (unordered), 'radius' those within ``in_radius``, the
    ``voxel_max`` nearest of them where more (the centre alone where none)."""
    d2 = np.sum((coord - coord[center_i]) ** 2, axis=1)
    # argpartition, not argsort: the crop is an unordered nearest-set (a
    # shuffle follows), and O(n) selection vs O(n log n) sort is the host
    # pipeline's hot path at 65k-point crops
    if crop_mode == "radius":
        inside = np.flatnonzero(d2 <= in_radius**2)
        if len(inside) > voxel_max:
            inside = inside[np.argpartition(d2[inside], voxel_max - 1)[:voxel_max]]
        return inside if len(inside) else np.array([center_i])
    return np.argpartition(d2, voxel_max - 1)[:voxel_max]


def prepare_crop(
    coord: np.ndarray,
    feat: np.ndarray,
    label: np.ndarray,
    rng: np.random.Generator,
    voxel_size: float = 0.04,
    voxel_max: Optional[int] = 80000,
    transform=None,
    split: str = "train",
    shuffle: bool = True,
    crop_mode: str = "count",
    in_radius: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One training/eval sample from a full room.

    train: augment → voxelize (random point per voxel) → crop → shuffle →
    zero-min coords, colors/255 (pytorch/util/data_util.py:45-90).

    crop_mode 'count' keeps the `voxel_max` nearest points around the center
    (the PT stack); 'radius' keeps points inside an `in_radius` sphere capped
    at voxel_max (the TF stack's in_radius=2.0 spheres,
    tensorflow/config/s3dis.py:57).
    """
    coord = np.asarray(coord, np.float64)
    feat = np.asarray(feat, np.float32)
    label = np.asarray(label)
    if transform is not None:
        coord, feat, label = transform(rng, coord, feat, label)

    if voxel_size:
        coord = coord - coord.min(0)
        idx = voxelize(coord, voxel_size, rng, mode="train")
        coord, feat, label = coord[idx], feat[idx], label[idx]

    n = len(coord)
    if voxel_max and (n > voxel_max or crop_mode == "radius"):
        center_i = int(rng.integers(n)) if "train" in split else n // 2
        crop = crop_around(coord, center_i, voxel_max, crop_mode, in_radius)
        coord, feat, label = coord[crop], feat[crop], label[crop]

    if shuffle:
        perm = rng.permutation(len(coord))
        coord, feat, label = coord[perm], feat[perm], label[perm]

    coord = coord - coord.min(0)
    return (
        coord.astype(np.float32),
        feat.astype(np.float32) / 255.0,
        label.astype(np.int32),
    )


class PotentialSampler:
    """Potential-based spatially-regular TRAIN sampling — the reference's
    `spatially_regular_gen` (tensorflow/datasets/base.py:297-448): pick the
    cloud with the lowest minimum potential, then its min-potential point as
    crop center (+ Gaussian noise of scale in_radius/10), radius-query the
    crop, and bump the covered points' potentials with Tukey weights
    (1 − d²/r²)² — guaranteeing every point of every room is eventually
    trained on. The published ConvNet 69.4 was trained this way; the PT
    stack (and this repo's default sampler='random') uses random centers.

    Rooms are voxelized ONCE with a fixed per-room seed (the reference's
    cached `input_0.040` subsampled clouds) — augmentation applies to the
    crop afterwards, like the reference's in-graph augment of cropped
    batches (datasets/base.py:549-640).
    """

    def __init__(
        self,
        dataset,
        voxel_size: float,
        in_radius: float = 2.0,
        cap: Optional[int] = None,
        seed: int = 0,
    ):
        from scipy.spatial import cKDTree

        self.in_radius = in_radius
        self.cap = cap
        self.rooms = []
        init_rng = np.random.RandomState(seed)
        for i in range(dataset.num_rooms):
            coord, feat, label = dataset.room(i)
            coord = np.asarray(coord, np.float64)
            coord = coord - coord.min(0)
            if voxel_size:
                rng = np.random.default_rng((seed, 1234, i))
                idx = voxelize(coord, voxel_size, rng, mode="train")
                coord, feat, label = coord[idx], feat[idx], label[idx]
            self.rooms.append(
                {
                    "coord": coord.astype(np.float32),
                    "feat": np.asarray(feat, np.float32),
                    "label": np.asarray(label),
                    "tree": cKDTree(coord),
                    "pot": init_rng.rand(len(coord)) * 1e-3,
                }
            )
        self.min_pot = np.array([r["pot"].min() for r in self.rooms])

    def min_potential(self) -> float:
        return float(self.min_pot.min())

    def next(self, rng: np.random.Generator):
        """→ (room_index, crop_row_indices) into the voxelized room."""
        ci = int(np.argmin(self.min_pot))
        room = self.rooms[ci]
        pi = int(np.argmin(room["pot"]))
        center = room["coord"][pi] + rng.normal(
            scale=self.in_radius / 10, size=3
        )
        idx = np.asarray(
            room["tree"].query_ball_point(center, r=self.in_radius),
            dtype=np.int64,
        )
        if len(idx) == 0:
            idx = np.array([pi], np.int64)
        d2 = np.sum((room["coord"][idx] - center) ** 2, axis=1)
        tukey = np.square(1 - d2 / self.in_radius**2)
        tukey[d2 > self.in_radius**2] = 0
        room["pot"][idx] += tukey
        self.min_pot[ci] = room["pot"].min()
        if self.cap and len(idx) > self.cap:
            # reference caps dense crops at batch_limit−1 by uniform choice
            # (datasets/base.py:400-402)
            idx = rng.choice(idx, size=int(self.cap) - 1, replace=False)
        return ci, idx

    def crop(self, ci: int, idx: np.ndarray):
        room = self.rooms[ci]
        return (
            room["coord"][idx].astype(np.float64),
            room["feat"][idx].copy(),
            room["label"][idx].copy(),
        )


def pad_to_fixed_size(
    coord: np.ndarray,
    feat: np.ndarray,
    label: np.ndarray,
    n_points: int,
    rng: np.random.Generator,
):
    """Pad (by resampling with replacement) or crop (random subset) to exactly
    `n_points`. Returns (coord, feat, label, src_idx) where src_idx maps each
    output row to its source row — eval accumulates by src_idx."""
    n = len(coord)
    if n == n_points:
        idx = np.arange(n)
    elif n > n_points:
        idx = rng.choice(n, n_points, replace=False)
    else:
        extra = rng.integers(0, n, n_points - n)
        idx = np.concatenate([np.arange(n), extra])
    return coord[idx], feat[idx], label[idx], idx.astype(np.int32)
