"""Segmentation losses with ignore-label masking (counterpart of
contrastboundary_tpu/losses/segmentation.py): the cross-entropy (with
per-point weights), the plain head's binary sigmoid cross-entropy and the
inverse-frequency class weights of its 'class' token."""
from __future__ import annotations

from typing import Optional

import numpy as np
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


def sigmoid_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_label: int = -1) -> torch.Tensor:
    """Binary cross-entropy of one logit channel against the labels as 0/1
    targets (the plain head's 'sigmoid' loss), the mean over points whose
    label != ignore_label (global across ranks, as cross_entropy's). The
    numerically stable form max(x, 0) − x·y + log1p(e^−|x|). Raises unless
    logits have one channel."""
    if logits.shape[-1] != 1:
        raise ValueError(
            "the 'sigmoid' mlp-head loss is element-wise binary CE; logits must have 1 "
            f"channel (got {logits.shape[-1]})")
    valid = labels != ignore_label
    y = torch.where(valid, labels, 0).float()
    x = logits[..., 0].float()
    bce = torch.clamp_min(x, 0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    w = valid.float()
    return global_mean((bce * w).sum(), w.sum())


def inverse_frequency_weights(counts, power: float = 0.5) -> tuple:
    """Per-class loss weights from the train split's label counts: w_c ∝
    1 / freq_c^power (inverse square root at the default), scaled to mean 1
    over the classes present; an absent class weighs 1. → a tuple of
    floats."""
    counts = np.asarray(counts, np.float64)
    present = counts > 0
    if not present.any():
        return tuple(float(x) for x in np.ones_like(counts))
    freq = counts / counts[present].sum()
    w = np.ones_like(counts)
    w[present] = 1.0 / np.power(freq[present], power)
    w[present] /= w[present].mean()
    return tuple(float(x) for x in w)
