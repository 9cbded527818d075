"""Morton (Z-order) serialization and the voxel sampler (counterpart of
contrastboundary_tpu/ops/sampling.py:22-45, ``serialized_order`` and
``voxel_sample``)."""
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


def voxel_sample(points: torch.Tensor, m: int, voxel_size: float) -> torch.Tensor:
    """One representative row per occupied voxel, thinned or padded to a
    fixed m: the first row of each voxel in the stable hash order, then a
    pick (j·count)//m over those first occurrences (repeating rows when
    there are fewer than m voxels). points [B, N, 3] → idx [B, m] int32.

    The reference packs the first occurrences to the front by a scatter
    that sends every other row to slot n − 1 (never read); here they go to
    an extra slot n that is dropped, so no duplicate write can land in a
    slot that is read."""
    from .voxel import voxelize_indices

    b, n, _ = points.shape
    h = voxelize_indices(points, voxel_size)
    order = torch.argsort(h, dim=-1, stable=True)
    hs = torch.gather(h, 1, order)
    first = torch.ones_like(hs, dtype=torch.bool)
    first[:, 1:] = hs[:, 1:] != hs[:, :-1]
    count = first.sum(1, dtype=torch.int64)
    rank = torch.cumsum(first.to(torch.int64), 1) - 1
    slot = torch.where(first, rank, n)
    pos = torch.arange(n, device=points.device).expand(b, n)
    first_pos = torch.zeros((b, n + 1), dtype=torch.int64, device=points.device)
    first_pos.scatter_(1, slot, pos)
    j = (torch.arange(m, device=points.device)[None] * count[:, None]) // m
    return torch.gather(order, 1, torch.gather(first_pos, 1, j)).to(torch.int32)
