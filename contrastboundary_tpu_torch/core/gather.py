"""Batched gathers with shadow-row semantics (counterpart of
contrastboundary_tpu/core/gather.py): an index equal to N marks an invalid
slot, which reads as ``fill``."""
from __future__ import annotations

import torch


def batch_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, ...] in [0, N) → [B, *idx.shape[1:], *x.shape[2:]]."""
    b = x.shape[0]
    bidx = torch.arange(b, device=x.device).reshape((b,) + (1,) * (idx.ndim - 1))
    return x[bidx, idx.long()]


def clamped_gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """batch_gather as the reference's ``x[idx]`` computes it at a shadow
    index N: XLA clamps an out-of-range gather, so the slot reads row
    N − 1, and drops an out-of-range update of its transpose (a scatter-add),
    so the slot's cotangent reaches no row."""
    n = x.shape[1]
    out = batch_gather(x, idx.clamp_max(n - 1))
    if not out.requires_grad:
        return out
    valid = (idx < n).reshape(idx.shape + (1,) * (out.ndim - idx.ndim))
    return torch.where(valid, out, out.detach())


def shadow_gather(x: torch.Tensor, idx: torch.Tensor, fill: float = 0.0):
    """Gather where idx == N (or beyond) reads ``fill``. Returns (gathered,
    valid) with valid shaped like idx."""
    n = x.shape[1]
    valid = idx < n
    out = batch_gather(x, torch.where(valid, idx, torch.zeros_like(idx)))
    mask = valid.reshape(valid.shape + (1,) * (out.ndim - valid.ndim))
    return out.masked_fill(~mask, fill), valid
