"""Masked reductions (a copy of what the port needs from
contrastboundary_tpu/core/masking.py): the reference's constants
``INF = 1e9`` and ``EPS = 1e-12``, the masked softmax and the masked
mean, and the masked mean over the global batch of the ranks."""
from __future__ import annotations

import torch

from ..parallel.mesh import global_mean

INF = 1e9
EPS = 1e-12


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the entries where ``mask`` is true; 0 when the
    mask is empty."""
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp_min(m.sum(), 1.0)


def masked_global_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the masked entries of
    every rank (parallel/mesh.py::global_mean): the ranks' shares sum to
    the global masked mean. World size 1: ``masked_mean``, bit for bit."""
    m = mask.to(x.dtype)
    return global_mean((x * m).sum(), m.sum())


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax over ``dim`` with the entries where ``mask`` is false zeroed;
    a row without a true entry gives zeros, not NaN. The max subtracted for
    stability carries no gradient."""
    mask = mask.to(torch.bool)
    z = torch.where(mask, logits, torch.full_like(logits, -INF))
    z = z - z.amax(dim, keepdim=True).detach()
    e = torch.exp(z) * mask.to(logits.dtype)
    return e / torch.clamp_min(e.sum(dim, keepdim=True), EPS)
