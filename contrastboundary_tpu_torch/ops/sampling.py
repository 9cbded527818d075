"""Morton (Z-order) serialization (counterpart of
contrastboundary_tpu/ops/sampling.py:22-45 and ``serialized_order``)."""
from __future__ import annotations

import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_code(points: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """points [..., N, 3] → [..., N] int64 codes; coordinates normalized per
    cloud to the unit cube (f32, as the JAX version) and truncated to
    ``bits`` bits per axis."""
    p = points.float()
    mn = p.amin(-2, keepdim=True)
    mx = p.amax(-2, keepdim=True)
    scale = torch.clamp_min(mx - mn, 1e-6)
    g = (p - mn) / scale * float(2**bits - 1)
    g = torch.clamp(g, 0, 2**bits - 1).to(torch.int64)
    return (
        _part1by2(g[..., 0])
        | (_part1by2(g[..., 1]) << 1)
        | (_part1by2(g[..., 2]) << 2)
    )


def serialized_order(points: torch.Tensor) -> torch.Tensor:
    """Morton-sort order of a batch of clouds [B, N, 3] → [B, N] int64
    (stable, like ``jnp.argsort``)."""
    return torch.argsort(morton_code(points), dim=-1, stable=True)
