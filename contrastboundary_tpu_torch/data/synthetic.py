"""Training crops of procedural rooms without augmentation: ``train_batch``,
the batches of every train phase before the data pipeline was ported, kept
as they were (data/pipeline.py does the voxelization and the crop).
``SyntheticSceneDataset`` and ``voxelize`` are re-exported from
data/s3dis.py and data/pipeline.py.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .pipeline import crop_around, voxelize
from .s3dis import SyntheticSceneDataset

__all__ = ["SyntheticSceneDataset", "train_batch", "voxelize"]


def train_batch(dataset: SyntheticSceneDataset, batch_size: int, n_points: int,
                rng: np.random.Generator, voxel_size: float = 0.04,
                voxel_max: int = 80_000) -> Dict[str, np.ndarray]:
    """``batch_size`` training crops of random rooms: voxelize (a random
    point per voxel), keep the ``voxel_max`` points nearest a random centre,
    then exactly ``n_points`` rows (a random permutation's first n_points,
    or all rows permuted and padded by repeating random rows), zero-min
    coordinates, colours/255 → points [B, N, 3] f32, features [B, N, 3] f32,
    labels [B, N] int32."""
    out = {"points": [], "features": [], "labels": []}
    for _ in range(batch_size):
        coord, feat, label = dataset.room(int(rng.integers(dataset.num_rooms)))
        coord = coord - coord.min(0)
        pick = voxelize(coord, voxel_size, rng)
        coord, feat, label = coord[pick], feat[pick], label[pick]
        if len(coord) > voxel_max:
            crop = crop_around(coord, int(rng.integers(len(coord))), voxel_max)
            coord, feat, label = coord[crop], feat[crop], label[crop]
        n = len(coord)
        if n >= n_points:
            idx = rng.permutation(n)[:n_points]
        else:
            idx = np.concatenate([rng.permutation(n), rng.integers(0, n, n_points - n)])
        coord = coord[idx]
        out["points"].append((coord - coord.min(0)).astype(np.float32))
        out["features"].append(feat[idx].astype(np.float32) / 255.0)
        out["labels"].append(label[idx].astype(np.int32))
    return {k: np.stack(v) for k, v in out.items()}
