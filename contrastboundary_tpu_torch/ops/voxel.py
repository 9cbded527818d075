"""Voxel hashing and the fixed-shape voxel-grid subsample (counterpart of
contrastboundary_tpu/ops/voxel.py:25-105).

Each point's voxel is floor((p − min)/voxel_size) per axis, clipped to a
2048-cell grid and hashed as (x·2048 + y)·2048 + z in int32, wrapping as
the reference's int32 arithmetic does. The division takes the voxel size
as a float32 tensor on the points' device: a Python scalar divisor makes
CUDA multiply by its reciprocal, which moves points across cell edges.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

GRID = 2048  # per-axis hash grid; clouds spanning > GRID·voxel_size alias


def _wrap_int32(h: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 that two's-complement int32 arithmetic gives."""
    return (((h + 2**31) % 2**32) - 2**31).to(torch.int32)


def voxelize_indices(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """Integer voxel hash per point: points [..., N, 3] → [..., N] int32."""
    p = points.float()
    mn = p.amin(-2, keepdim=True)
    size = torch.tensor(voxel_size, dtype=torch.float32, device=p.device)
    v = torch.floor((p - mn) / size).to(torch.int64).clamp(0, GRID - 1)
    return _wrap_int32((v[..., 0] * GRID + v[..., 1]) * GRID + v[..., 2])


def _segments(h: torch.Tensor, max_voxels: int):
    """Stable sort of the hashes [B, N] → (order, segment id per sorted row
    with overflow voxels sent to slot max_voxels)."""
    order = torch.argsort(h, dim=-1, stable=True)
    hs = torch.gather(h, 1, order)
    first = torch.ones_like(hs, dtype=torch.bool)
    first[:, 1:] = hs[:, 1:] != hs[:, :-1]
    seg = torch.cumsum(first.to(torch.int64), 1) - 1
    return order, seg.clamp_max(max_voxels)


def _segment_sum(x: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """x [B, N, C] summed into num segments per cloud → [B, num, C]."""
    out = x.new_zeros((x.shape[0], num, x.shape[2]))
    return out.scatter_add_(1, seg[..., None].expand_as(x), x)


def voxel_grid_subsample(points: torch.Tensor, features=None, labels=None, *,
                         voxel_size: float, max_voxels: int, num_classes: int = 0):
    """Batched voxel-grid subsample: per occupied voxel (in hash order, the
    first ``max_voxels`` kept) the barycenter of its points, the mean of
    their features and the majority label (first class on ties; −1 for an
    empty slot or a voxel whose points are all ignored, label < 0).

    points [B, N, 3], features [B, N, C] or None, labels [B, N] or None →
    (points [B, M, 3], features [B, M, C] | None, labels [B, M] int32 |
    None, mask [B, M] bool, True for occupied slots)."""
    p = points.float()
    order, seg = _segments(voxelize_indices(p, voxel_size), max_voxels)
    num = max_voxels + 1

    def gathered(x):
        return torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))

    ones = torch.ones(p.shape[:2] + (1,), dtype=torch.float32, device=p.device)
    cnt = _segment_sum(ones, seg, num)[:, :max_voxels, 0]
    denom = torch.clamp_min(cnt, 1.0)[..., None]
    out_p = _segment_sum(gathered(p), seg, num)[:, :max_voxels] / denom
    out_f = None
    if features is not None:
        out_f = _segment_sum(gathered(features.float()), seg, num)[:, :max_voxels] / denom
    out_l = None
    if labels is not None:
        ls = torch.gather(labels.long(), 1, order)
        oh = F.one_hot(ls.clamp_min(0), num_classes).float() * (ls >= 0)[..., None]
        votes = _segment_sum(oh, seg, num)[:, :max_voxels]
        out_l = torch.where(votes.sum(-1) > 0, votes.argmax(-1), -1).to(torch.int32)
    return out_p, out_f, out_l, cnt > 0
