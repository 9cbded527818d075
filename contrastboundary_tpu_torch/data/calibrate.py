"""Static-cap calibration (counterpart of
contrastboundary_tpu/data/calibrate.py: the same integers from the same
clouds).

The reference measures its ragged pipeline before training: the batch size
whose mean stacked-point count hits a target, and per level the neighbour
cap that leaves ``keep_ratio`` of the radius-neighbour slots untouched.
Under static shapes the same measurements, taken once on the host over
sample clouds (the grid subsample of native.py and a cKDTree), give the
values to put in the config: ``data.n_points`` and
``model.neighborhood_limits``.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import numpy as np

from ..native import grid_subsample


def _subsample(points: np.ndarray, cell: float) -> np.ndarray:
    """Voxel barycentres on the ``cell`` grid (a pyramid level's points)."""
    sub, _, _ = grid_subsample(points.astype(np.float32), None, None, cell)
    return sub


def calibrate_neighborhood_limits(
    clouds: Iterable[np.ndarray],
    radii: Sequence[float],
    voxel_sizes: Sequence[float],
    keep_ratio: float = 0.8,
    max_clouds: int = 10,
    hist_max: int = 256,
) -> Tuple[int, ...]:
    """Per-level neighbour caps from measured radius-neighbour histograms.

    Level l subsamples the clouds to ``voxel_sizes[l]`` (level 0 keeps the
    raw cloud), counts each point's neighbours within ``radii[l]``, and
    takes the smallest cap whose cumulative histogram reaches ``keep_ratio``
    of the points → a tuple for ``ModelConfig.neighborhood_limits``.
    """
    from scipy.spatial import cKDTree

    clouds = [np.asarray(c, np.float32) for _, c in zip(range(max_clouds), clouds)]
    if not clouds:
        raise ValueError("need at least one sample cloud")
    limits = []
    for l, r in enumerate(radii):
        hist = np.zeros(hist_max + 1, np.int64)
        for pts in clouds:
            sub = pts if l == 0 or voxel_sizes[l] <= 0 else _subsample(pts, voxel_sizes[l])
            if len(sub) < 2:
                continue
            counts = cKDTree(sub).query_ball_point(sub, r, return_length=True)
            np.add.at(hist, np.minimum(counts, hist_max), 1)
        total = hist.sum()
        if total == 0:
            limits.append(hist_max)
            continue
        # smallest count whose cumulative histogram reaches the keep ratio
        limits.append(int(np.sum(np.cumsum(hist) < keep_ratio * total)))
    return tuple(limits)


def calibrate_crop_points(
    clouds: Iterable[np.ndarray],
    in_radius: float,
    voxel_size: float,
    percentile: float = 0.9,
    samples_per_cloud: int = 8,
    max_clouds: int = 10,
    seed: int = 0,
) -> int:
    """Static crop size for the radius crop: sphere crops of ``in_radius``
    around random points of the grid-subsampled clouds; the ``percentile``
    point count rounded up to a power of two → ``data.n_points``."""
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(seed)
    counts = []
    for _, pts in zip(range(max_clouds), clouds):
        sub = _subsample(np.asarray(pts, np.float32), voxel_size)
        if len(sub) < 2:
            continue
        tree = cKDTree(sub)
        centers = sub[rng.randint(0, len(sub), samples_per_cloud)]
        counts.extend(tree.query_ball_point(c, in_radius, return_length=True) for c in centers)
    if not counts:
        raise ValueError("need at least one non-trivial sample cloud")
    target = float(np.percentile(counts, percentile * 100))
    return int(2 ** np.ceil(np.log2(max(target, 1.0))))
