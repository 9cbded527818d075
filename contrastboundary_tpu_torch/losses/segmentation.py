"""Segmentation cross-entropy with ignore-label masking (counterpart of
contrastboundary_tpu/losses/segmentation.py::cross_entropy)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = -1,
                  weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over points whose label != ignore_label, optionally weighted
    per point. logits [..., C] float, labels [...] int."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    logp = F.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    w = valid.float()
    if weight is not None:
        w = w * weight
    return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)
