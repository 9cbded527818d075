"""Whole-scene voxel-duplicate enumeration inference, the point-transformer
test protocol behind the published 71.6 mIoU (counterpart of
contrastboundary_tpu/eval/enumerate.py).

Per room:
  1. val-mode voxelize keeps every point grouped by voxel; pass i takes
     duplicate ``i % count`` of each voxel, so over max(count) passes every
     point is taken;
  2. a pass larger than ``min(voxel_max, n_points)`` goes through the
     potential-min crop loop until all its points are covered;
  3. parts are padded by repetition to the static ``n_points``, batched, and
     the network's logits (not probs) accumulate into a full-cloud array,
     once per unique row of a part.

Crops, padding and accumulation run on the host in numpy; ``predict_fn``
runs the eval step on the device.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np

from ..data.pipeline import voxelize
from .metrics import metrics_from_confusion


class EnumerateEvaluator:
    """Runs the enumeration protocol over all rooms of a dataset."""

    def __init__(self, dataset, predict_fn: Callable, num_classes: int, n_points: int,
                 batch_size: int = 4, voxel_size: float = 0.04, voxel_max: int = 0,
                 seed: int = 0):
        """predict_fn: {points, features} [B, N, ...] → logits [B, N, C]
        (numpy, or anything np.asarray takes)."""
        self.dataset = dataset
        self.predict_fn = predict_fn
        self.num_classes = num_classes
        self.n_points = n_points
        self.batch_size = batch_size
        self.voxel_size = voxel_size
        self.voxel_max = voxel_max or n_points
        self.seed = seed
        self.logits: List[np.ndarray] = []  # per-room accumulated logits
        self.labels: List[np.ndarray] = []
        self.coords: List[np.ndarray] = []
        self.pred_counts: List[np.ndarray] = []
        self.passes: List[int] = []
        self.parts: List[int] = []
        self.requests = 0

    def _make_parts(self, coord: np.ndarray, rng) -> List[np.ndarray]:
        n = len(coord)
        if not self.voxel_size:
            passes = [np.arange(n)]
        else:
            order, counts = voxelize(coord, self.voxel_size, mode="val")
            starts = np.cumsum(np.insert(counts, 0, 0))[:-1]
            passes = [order[starts + i % counts] for i in range(int(counts.max()))]
        self.passes.append(len(passes))
        # a part must fit the static device shape n_points as well as the
        # protocol's voxel_max, or its tail would be dropped
        cap = min(self.voxel_max, self.n_points)
        parts: List[np.ndarray] = []
        for part in passes:
            if len(part) <= cap:
                parts.append(part)
                continue
            # potential-min crop loop
            cp = coord[part]
            pot = rng.random(len(part)) * 1e-3
            covered = np.zeros(len(part), bool)
            while not covered.all():
                center = int(np.argmin(pot))
                d2 = np.sum((cp - cp[center]) ** 2, axis=1)
                crop = np.argsort(d2)[:cap]
                d2c = d2[crop]
                pot[crop] += np.square(1 - d2c / max(d2c.max(), 1e-9))
                covered[crop] = True
                parts.append(part[crop])
        return parts

    def _run_parts(self, coord, feat, parts, logits_acc, counts, rng):
        for s in range(0, len(parts), self.batch_size):
            pts, fts, srcs = [], [], []
            for src in parts[s: s + self.batch_size]:
                if len(src) > self.n_points:
                    raise ValueError(f"a part of {len(src)} rows exceeds n_points {self.n_points}")
                if len(src) < self.n_points:
                    extra = rng.integers(0, len(src), self.n_points - len(src))
                    src = np.concatenate([src, src[extra]])
                c = coord[src]
                pts.append(c - c.min(0))
                fts.append(feat[src] / 255.0)
                srcs.append(src)
            while len(pts) < self.batch_size:  # the static batch shape
                pts.append(pts[-1])
                fts.append(fts[-1])
                srcs.append(None)
            logits = np.asarray(self.predict_fn({
                "points": np.stack(pts).astype(np.float32),
                "features": np.stack(fts).astype(np.float32),
            }))
            self.requests += 1
            for src, lg in zip(srcs, logits):
                if src is None:
                    continue
                uniq, first = np.unique(src, return_index=True)
                logits_acc[uniq] += lg[first]
                counts[uniq] += 1

    def run(self, progress=None) -> dict:
        rng = np.random.default_rng(self.seed)
        for r in range(self.dataset.num_rooms):
            coord, feat, label = self.dataset.room(r)
            coord = (coord - coord.min(0)).astype(np.float32)
            logits_acc = np.zeros((len(coord), self.num_classes), np.float32)
            counts = np.zeros(len(coord), np.int64)
            parts = self._make_parts(coord, rng)
            self.parts.append(len(parts))
            self._run_parts(coord, feat, parts, logits_acc, counts, rng)
            if not (counts > 0).all():
                raise RuntimeError(f"enumeration missed {int((counts == 0).sum())} points of room {r}")
            self.logits.append(logits_acc)
            self.labels.append(label.astype(np.int64))
            self.coords.append(coord)
            self.pred_counts.append(counts)
            if progress:
                progress(r, len(parts))
        return self.metrics()

    def metrics(self) -> dict:
        c = self.num_classes
        conf = np.zeros((c, c), np.float64)
        for lg, lab in zip(self.logits, self.labels):
            pred = lg.argmax(-1)
            v = lab >= 0
            np.add.at(conf, (lab[v], pred[v]), 1)
        return {"full": metrics_from_confusion(conf)}
