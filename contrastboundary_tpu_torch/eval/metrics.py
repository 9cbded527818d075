"""Confusion-matrix metrics (counterpart of
contrastboundary_tpu/eval/metrics.py:20-126): the confusion on the device,
the metric reduction in numpy on the host."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     ignore_label: int = -1) -> torch.Tensor:
    """[C, C] float32 confusion, rows = true label, cols = prediction;
    ignored labels and labels outside [0, C) excluded (as the JAX one-hot
    contraction drops them: the binary labels of a one-class sigmoid head),
    predictions clipped into [0, C)."""
    valid = (label != ignore_label) & (label >= 0) & (label < num_classes)
    p = pred.long().clamp(0, num_classes - 1)
    flat = label.long()[valid] * num_classes + p[valid]
    counts = torch.bincount(flat, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).float()


def metrics_from_confusion(conf, proportions: Optional[np.ndarray] = None) -> dict:
    """mIoU / OA / mACC (+ per-class IoU) from a confusion matrix.
    ``proportions``: true per-class point counts of the full clouds; each row
    is rescaled to them (validation-proportion rebalancing)."""
    conf = np.asarray(conf, np.float64)
    if proportions is not None:
        row = conf.sum(axis=1, keepdims=True)
        scale = np.asarray(proportions, np.float64)[:, None] / np.maximum(row, 1e-6)
        conf = conf * scale

    tp = np.diag(conf)
    fn = conf.sum(1) - tp
    fp = conf.sum(0) - tp
    iou = tp / np.maximum(tp + fp + fn, 1e-6)
    present = conf.sum(1) > 0
    acc_per_class = tp / np.maximum(conf.sum(1), 1e-6)
    return {
        "mIoU": float(iou[present].mean()) if present.any() else 0.0,
        "OA": float(tp.sum() / np.maximum(conf.sum(), 1e-6)),
        "mACC": float(acc_per_class[present].mean()) if present.any() else 0.0,
        "IoUs": iou,
        "confusion": conf,
    }


class Metrics(dict):
    """Metric dict with ordered comparison: by the ``order`` keys in
    sequence (mIoU, then OA, then mACC by default), as the best snapshot is
    picked."""

    ORDER = ("mIoU", "OA", "mACC")

    def __init__(self, *args, order=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.order = tuple(order) if order else Metrics.ORDER

    def _key(self):
        return tuple(float(self.get(k, float("-inf"))) for k in self.order)

    def __lt__(self, other):
        return self._key() < other._key()

    def __gt__(self, other):
        return self._key() > other._key()

    def __ge__(self, other):
        return not self < other

    def __le__(self, other):
        return not self > other

    def scalar_str(self) -> str:
        return " ".join(f"{k}={float(v):.4f}" for k, v in self.items()
                        if isinstance(v, (int, float)))


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
