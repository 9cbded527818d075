"""Masked reductions (a copy of what the port needs from
contrastboundary_tpu/core/masking.py): the reference's constants
``INF = 1e9`` and ``EPS = 1e-12`` and the masked mean."""
from __future__ import annotations

import torch

INF = 1e9
EPS = 1e-12


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``x`` over the entries where ``mask`` is true; 0 when the
    mask is empty."""
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp_min(m.sum(), 1.0)
