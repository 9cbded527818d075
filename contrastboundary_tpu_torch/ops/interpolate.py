"""Inverse-squared-distance interpolation weights (counterpart of
contrastboundary_tpu/ops/interpolate.py::interpolation_weights)."""
from __future__ import annotations

import torch


def interpolation_weights(d2: torch.Tensor) -> torch.Tensor:
    """Squared distances [..., k] → weights 1/(d2 + 1e-8), normalized over k."""
    recip = 1.0 / (d2 + 1e-8)
    return recip / recip.sum(-1, keepdim=True)
