"""Tile-window KNN on Morton-sorted clouds (counterpart of
contrastboundary_tpu/ops/knn.py::tile_self_knn and ::tile_cross_knn).

Every search goes through ops/cuda/win_topk.py::window_topk: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors. The JAX
module's dispatch heuristics between bit-identical paths (kernel budget,
batched argmax, lax.map + top_k, grid split) have no counterpart here.
Results are exact: first-index ties, and a slot without a candidate
(k > W) is the shadow index.
"""
from __future__ import annotations

import torch

from ..core.gather import batch_gather
from .cuda import win_topk
from .sampling import serialized_order


def self_width(num_tiles: int, window: int) -> int:
    """Window width in tiles of the self geometry."""
    return min(2 * window + 1, num_tiles)


def cross_width(gq: int, gs: int, window: int) -> int:
    """Window width in tiles of the cross geometry: the ceil(gs/gq) support
    tiles a query tile spans, ± window."""
    return min(-(-gs // gq) + 2 * window, gs)


def tile_self_knn(points: torch.Tensor, k: int, *, tile: int = 256,
                  window: int = 1, exclude_self: bool = True,
                  assume_sorted: bool = False, ensure_self: bool = False):
    """Self-KNN inside a Morton tile window, in sorted space.

    Returns (order [B, M] or None if assume_sorted, local_idx [B, M, k]
    int32 window-relative with shadow W = width·tile, width)."""
    b, m, _ = points.shape
    if m % tile:
        raise ValueError(f"M={m} is not a multiple of tile={tile}")
    if exclude_self and ensure_self:
        raise ValueError("exclude_self and ensure_self are exclusive")
    width = self_width(m // tile, window)
    if assume_sorted:
        order, pts = None, points
    else:
        order = serialized_order(points)
        pts = batch_gather(points, order)
    mode = (
        "exclude_self" if exclude_self
        else ("ensure_self" if ensure_self else "plain")
    )
    local_idx, _ = win_topk.window_topk(
        pts, pts, k, tile=tile, width=width, window=window, mode=mode
    )
    return order, local_idx, width


def tile_cross_knn(query: torch.Tensor, support: torch.Tensor, k: int, *,
                   tile: int = 256, window: int = 1):
    """Cross-level KNN for clouds sorted on the same Morton curve.

    Returns (idx [B, M, k] int32 global support rows, shadow N; d2 [B, M, k]
    ascending squared distances, +inf at shadows)."""
    m, n = query.shape[1], support.shape[1]
    if m % tile or n % tile:
        raise ValueError(f"M={m}, N={n} are not multiples of tile={tile}")
    gq, gs = m // tile, n // tile
    width = cross_width(gq, gs, window)
    local, neg = win_topk.window_topk(
        query, support, k, tile=tile, width=width, window=window
    )
    starts = win_topk.window_start_tiles(gq, gs, width, window) * tile
    row0 = torch.as_tensor(starts, device=query.device).repeat_interleave(tile)
    idx = torch.where(local < width * tile, row0[None, :, None] + local, n)
    return idx.to(torch.int32), -neg
