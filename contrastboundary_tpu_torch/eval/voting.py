"""Voting inference: the request loop of the served model (counterpart of
contrastboundary_tpu/eval/voting.py).

Potential-driven crop coverage, smoothed probability (and per-stage
feature) accumulation and nearest-point reprojection to the full cloud run
on the host in numpy; each request (one batch of fixed-size crops, padded
by repetition) goes to ``predict_fn``, which runs the eval step on the
device. Across the ranks of a process group every rank builds the same
requests from the same seed, and ``predict_fn`` returns every rank's rows
of each (eval/run.py::predict_request), so every rank accumulates the same
votes.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
from scipy.spatial import cKDTree

from ..data.pipeline import voxelize
from .metrics import metrics_from_confusion


class CloudVoteState:
    """Per-room accumulator over the voxel-subsampled eval cloud."""

    def __init__(self, coord, feat, label, num_classes: int):
        self.coord = coord
        self.feat = feat
        self.label = label
        self.num_classes = num_classes
        n = len(coord)
        self.probs = np.zeros((n, num_classes), np.float32)
        self.counts = np.zeros((n,), np.int64)
        # per-stage feature accumulators {name: [n, d]}, smoothed as probs
        self.features: Dict[str, np.ndarray] = {}
        self.potentials = np.random.RandomState(42).rand(n).astype(np.float64) * 1e-3
        self.tree = cKDTree(coord)

    def min_potential(self) -> float:
        return float(self.potentials.min())

    def reset_potentials(self):
        """A new vote round: fresh coverage potentials, the accumulated
        probs and features kept (the running vote across rounds)."""
        self.potentials = np.random.RandomState(42).rand(len(self.coord)).astype(np.float64) * 1e-3

    def next_crop(self, n_points: int, crop_mode: str = "count",
                  in_radius: float = 2.0, rng=None):
        """Crop around the min-potential point and bump potentials with
        Tukey weights (1 − d²/r²)². 'count': the n_points nearest; 'radius':
        every point inside ``in_radius``, capped at n_points keeping the
        center."""
        center_i = int(np.argmin(self.potentials))
        n = len(self.coord)
        if crop_mode == "radius":
            idx = np.asarray(
                self.tree.query_ball_point(self.coord[center_i], in_radius),
                dtype=np.int64,
            )
            if idx.size == 0:
                idx = np.array([center_i], np.int64)
            d2 = np.square(self.coord[idx] - self.coord[center_i]).sum(-1)
            r2 = in_radius * in_radius
            self.potentials[idx] += np.square(1 - d2 / r2)
            if len(idx) > n_points:
                rng = rng or np.random.default_rng(center_i)
                keep = rng.choice(len(idx), n_points - 1, replace=False)
                idx = np.concatenate(
                    [np.array([center_i], np.int64), idx[keep]]
                )[:n_points]
            return idx
        k = min(n_points, n)
        d, idx = self.tree.query(self.coord[center_i], k=k)
        d, idx = np.atleast_1d(d), np.atleast_1d(idx)
        r2 = max(float(d.max()) ** 2, 1e-9)
        self.potentials[idx] += np.square(1 - np.square(d) / r2)
        return idx

    def accumulate(self, src_idx, probs, smooth: float, feats=None):
        """probs [n_points, C] for crop rows mapping to src_idx; duplicate
        (padded) rows vote once per crop (the first occurrence). ``feats``:
        optional {name: [n_points, d]} per-stage features, smoothed as
        probs."""
        uniq, first = np.unique(src_idx, return_index=True)
        p = probs[first]
        self.probs[uniq] = smooth * self.probs[uniq] + (1 - smooth) * p
        self.counts[uniq] += 1
        for k, v in (feats or {}).items():
            acc = self.features.setdefault(k, np.zeros((len(self.coord), v.shape[-1]), np.float32))
            acc[uniq] = smooth * acc[uniq] + (1 - smooth) * v[first]

    def predictions(self):
        return self.probs.argmax(-1)


class VotingEvaluator:
    """Drives eval over all rooms of a dataset until every point has been
    voted on ≥ num_votes times (via potentials)."""

    def __init__(
        self,
        dataset,
        predict_fn: Callable[[Dict[str, np.ndarray]], np.ndarray],
        num_classes: int,
        n_points: int,
        batch_size: int = 4,
        voxel_size: float = 0.04,
        num_votes: float = 1.0,
        smooth: float = 0.95,
        seed: int = 0,
        crop_mode: str = "count",
        in_radius: float = 2.0,
    ):
        """predict_fn: batch {points, features, labels} [B, N, ...] → probs
        [B, N, C], or (probs, {name: [B, N, d]}) with per-stage features
        (numpy, or anything np.asarray takes)."""
        self.dataset = dataset
        self.predict_fn = predict_fn
        self.num_classes = num_classes
        self.n_points = n_points
        self.batch_size = batch_size
        self.num_votes = num_votes
        self.smooth = smooth
        self.seed = seed
        self.crop_mode = crop_mode
        self.in_radius = in_radius

        self.requests = 0  # predict_fn calls over every run
        self.clouds: List[CloudVoteState] = []
        self.full_labels: List[np.ndarray] = []
        self.proj: List[np.ndarray] = []
        for r in range(dataset.num_rooms):
            coord, feat, label = dataset.room(r)
            coord = coord - coord.min(0)
            rng = np.random.default_rng((seed, r))
            if voxel_size:
                sub = voxelize(coord, voxel_size, rng, mode="train")
            else:
                sub = np.arange(len(coord))
            cs = CloudVoteState(
                coord[sub].astype(np.float32),
                (feat[sub] / 255.0).astype(np.float32),
                label[sub].astype(np.int32),
                num_classes,
            )
            self.clouds.append(cs)
            self.full_labels.append(label.astype(np.int32))
            # full-cloud reprojection: nearest subsampled point per full point
            _, proj = cs.tree.query(coord, k=1)
            self.proj.append(proj.astype(np.int64))

    def next_batch(self, rng: np.random.Generator, pending: List[CloudVoteState]):
        """One request: batch_size crops from the pending clouds, padded to
        n_points by repetition → (crops [(cloud, rows)], batch dict with
        points (zero-min per crop), features and labels)."""
        crops = []
        for _ in range(self.batch_size):
            c = pending[int(rng.integers(len(pending)))]
            idx = c.next_crop(
                self.n_points, crop_mode=self.crop_mode,
                in_radius=self.in_radius, rng=rng,
            )
            if len(idx) < self.n_points:
                extra = rng.integers(0, len(idx), self.n_points - len(idx))
                idx = np.concatenate([idx, idx[extra]])
            crops.append((c, idx))
        pts = np.stack([c.coord[i] for c, i in crops])
        batch = {
            "points": pts - pts.min(axis=1, keepdims=True),
            "features": np.stack([c.feat[i] for c, i in crops]),
            "labels": np.stack([c.label[i] for c, i in crops]),
        }
        return crops, batch

    def reset_potentials(self):
        for c in self.clouds:
            c.reset_potentials()

    def run(self, max_steps: int = 10_000, progress: Optional[Callable] = None):
        """Vote until min potential > num_votes everywhere (or max_steps
        requests). Returns metrics of the sub-sampled and the reprojected
        full clouds."""
        rng = np.random.default_rng(self.seed)
        step = 0
        while step < max_steps:
            pending = [c for c in self.clouds if c.min_potential() < self.num_votes]
            if not pending:
                break
            crops, batch = self.next_batch(rng, pending)
            out = self.predict_fn(batch)
            feats = {}
            if isinstance(out, tuple):
                out, feats = out
                feats = {k: np.asarray(v) for k, v in feats.items()}
            probs = np.asarray(out)
            for j, ((c, idx), p) in enumerate(zip(crops, probs)):
                c.accumulate(idx, p, self.smooth, feats={k: v[j] for k, v in feats.items()})
            step += 1
            self.requests += 1
            if progress and step % 20 == 0:
                progress(step, min(c.min_potential() for c in self.clouds))
        return self.metrics()

    def metrics(self):
        c = self.num_classes
        conf_sub = np.zeros((c, c), np.float64)
        conf_full = np.zeros((c, c), np.float64)
        props = np.zeros(c, np.float64)
        for cs, full_label, proj in zip(self.clouds, self.full_labels, self.proj):
            pred = cs.predictions()
            vs = cs.label >= 0  # ignore-labeled points excluded (label -1)
            np.add.at(conf_sub, (cs.label[vs], pred[vs]), 1)
            vf = full_label >= 0
            np.add.at(conf_full, (full_label[vf], pred[proj][vf]), 1)
            props += np.bincount(full_label[vf], minlength=c)
        return {
            # sub-cloud metrics rebalanced to the full clouds' class counts
            "sub": metrics_from_confusion(conf_sub, proportions=props),
            "full": metrics_from_confusion(conf_full),
        }
