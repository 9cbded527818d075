"""Inputs shared by the port's parity tests (tests/test_torch_*.py)."""
import numpy as np

from contrastboundary_tpu_torch.data.synthetic import SyntheticSceneDataset, voxelize


def synthetic_crops(b, n, grid=1.0 / 64, seed=0):
    """b crops of the n points nearest to distinct centres of synthetic val
    room 0 (voxel 0.04), coordinates rounded to multiples of ``grid`` metres
    so every squared distance is exact in float32 → (points, features,
    labels) as float32, float32, int32 arrays."""
    ds = SyntheticSceneDataset(num_rooms=1, points_per_room=40_000, seed=0, split="val")
    coord, feat, label = ds.room(0)
    coord = coord - coord.min(0)
    sub = voxelize(coord, 0.04, np.random.default_rng(seed))
    coord, feat, label = coord[sub], feat[sub] / 255.0, label[sub]
    rng = np.random.default_rng(seed)
    pts, fts, lbs = [], [], []
    for _ in range(b):
        c = coord[rng.integers(len(coord))]
        idx = np.argsort(((coord - c) ** 2).sum(-1), kind="stable")[:n]
        p = np.round((coord[idx] - coord[idx].min(0)) / grid) * grid
        pts.append(p)
        fts.append(feat[idx])
        lbs.append(label[idx])
    return (
        np.stack(pts).astype(np.float32),
        np.stack(fts).astype(np.float32),
        np.stack(lbs).astype(np.int32),
    )
