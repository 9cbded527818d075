"""Morton (Z-order) serialization and the samplers (counterpart of
contrastboundary_tpu/ops/sampling.py:22-148): ``serialized_order``, exact
``fps``, ``bucket_fps``, ``serialized_sample``, ``voxel_sample`` and the
pyramid's ``random_sample`` (contrastboundary_tpu/ops/pyramid.py:178-186).

The FPS chains run in ops/cuda/fps.py (the CUDA kernel for CUDA tensors,
the plain version for CPU tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import threefry
from .cuda import fps as fps_cuda

# (level, n, m, device) → the random sampler's picks on that device
_RANDOM_PICKS: dict = {}


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


def strided_pick(n_prev: int, m: int) -> np.ndarray:
    """Row pick ``jnp.linspace(0, n_prev − 1, m).round()`` with the bits XLA
    gives it: its simplifier folds (n_prev − 1)·(i/div) into
    i·((n_prev − 1)·(1/div)) in float32 (checked against JAX on the CPU by
    tests/test_torch_pyramid.py); the last entry is exactly n_prev − 1, and
    rounding is half to even."""
    if m == 1:
        return np.zeros(1, np.int32)
    div = m - 1
    stop = np.float32(n_prev - 1)
    out = np.arange(div, dtype=np.float32) * (stop * (np.float32(1) / np.float32(div)))
    out = np.concatenate([out, np.array([stop], np.float32)])
    return np.round(out).astype(np.int32)


def fps(points: torch.Tensor, m: int) -> torch.Tensor:
    """Exact batched FPS (the reference's ``_fps_single`` on each cloud):
    points [B, N, 3] → idx [B, m] int32."""
    return fps_cuda.fps_chains(points.float().contiguous(), m)


def bucket_fps(points: torch.Tensor, m: int, num_buckets: int = 64) -> torch.Tensor:
    """Bucketed FPS: Morton-sort, split into ``num_buckets`` contiguous
    groups, run the FPS chain in each, and map the picks back through the
    order. points [B, N, 3] → idx [B, m] int32 in the caller's rows; needs
    N % num_buckets == 0 and m % num_buckets == 0."""
    b, n, _ = points.shape
    g = num_buckets
    if n % g or m % g:
        raise ValueError(f"N={n} and m={m} must be divisible by num_buckets={g}")
    order = serialized_order(points)
    grouped = torch.gather(points.float(), 1, order[..., None].expand(b, n, 3))
    local = fps_cuda.fps_chains(grouped.reshape(b * g, n // g, 3), m // g)
    picked = torch.gather(order.reshape(b, g, n // g), 2, local.reshape(b, g, m // g).long())
    return picked.reshape(b, m).to(torch.int32)


def serialized_sample(points: torch.Tensor, m: int) -> torch.Tensor:
    """Strided pick along the Morton curve, the reference's
    ``order[:, linspace(0, n − 1, m).round()]`` with XLA's linspace bits
    (``strided_pick``). points [B, N, 3] → idx [B, m] int32."""
    pick = torch.as_tensor(strided_pick(points.shape[1], m), device=points.device)
    return serialized_order(points)[:, pick.long()].to(torch.int32)


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


def random_sample(points: torch.Tensor, m: int, level: int) -> torch.Tensor:
    """RandLA-style uniform decimation, as the reference's pyramid draws it:
    the first m rows of ``jax.random.permutation(PRNGKey(level), N)``, the
    same for every cloud of the batch. points [B, N, 3] → idx [B, m] int32.
    The picks are a constant of (level, N, m): computed once on the host
    (utils/threefry.py) and copied once to each device."""
    b, n, _ = points.shape
    key = (level, n, m, points.device)
    if key not in _RANDOM_PICKS:
        pick = threefry.permutation(threefry.prng_key(level), n)[:m].astype(np.int32)
        _RANDOM_PICKS[key] = torch.as_tensor(pick, device=points.device)
    return _RANDOM_PICKS[key][None].expand(b, m)
