"""Segmentation cross-entropy with ignore-label masking (counterpart of
contrastboundary_tpu/losses/segmentation.py::cross_entropy)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.mesh import global_mean


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = -1,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over points whose label != ignore_label, optionally weighted
    per point. logits [..., C] float, labels [...] int. Across ranks, this
    rank's share of the mean over the global batch (the weight summed over
    every rank)."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = valid.float()
    if weight is not None:
        w = w * weight
    return global_mean((nll * w).sum(), w.sum())
