"""Tile-window KNN on Morton-sorted clouds (counterpart of
contrastboundary_tpu/ops/knn.py::tile_self_knn and ::tile_cross_knn).

The search follows the reference's width rule (``_EXACT_TOPK_WIDTH``,
ops/knn.py:29 and :490 there): a window of W ≤ 2048 rows goes through
ops/cuda/win_topk.py::window_topk (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors); a wider one (the deep sub-scene searches,
kr = 4^l over level 0) is a plain PyTorch search on either device, as the
reference computes those windows in XLA and not in its kernel. That is a
dispatch by shape, not a fallback. Both are exact, with first-index ties
(the reference's TPU route takes ``lax.approx_max_k`` at recall 0.95 for
the wide windows; on the CPU that call is exact). A slot without a
candidate (k > W) is the shadow index. The JAX module's dispatch heuristics
between bit-identical paths (kernel budget, batched argmax, grid split)
have no counterpart here.
"""
from __future__ import annotations

import torch

from ..core.gather import batch_gather
from .cuda import win_topk
from .sampling import serialized_order

EXACT_TOPK_WIDTH = 2048
# searches whose window was wider than EXACT_TOPK_WIDTH (plain PyTorch)
wide_calls = 0


def window_topk_wide(query, support, k: int, *, tile: int, width: int,
                     window: int, mode: str = "plain"):
    """Exact window top-k in plain PyTorch for any width, on any device: the
    kernel's distances, then a stable descending sort (ties to the lower
    window index, as ``lax.top_k``). Same contract as
    ops/cuda/win_topk.py::window_topk."""
    b, m, _ = query.shape
    w_sz = width * tile
    neg, self_pos = win_topk.window_neg_d2(
        query, support, tile=tile, width=width, window=window, mode=mode
    )
    kk = min(k, w_sz)
    val, idx = torch.sort(neg, dim=-1, descending=True, stable=True)
    val, idx = val[..., :kk], idx[..., :kk].to(torch.int32)
    if kk < k:
        pad = (0, k - kk)
        val = torch.nn.functional.pad(val, pad, value=float("-inf"))
        idx = torch.nn.functional.pad(idx, pad, value=w_sz)
    idx = torch.where(torch.isinf(val), w_sz, idx).to(torch.int32)
    if mode == "ensure_self":
        idx[..., 0] = self_pos
        val[..., 0] = 0.0
    return idx.reshape(b, m, k), val.reshape(b, m, k)


def _window_topk(query, support, k, *, tile, width, window, mode="plain"):
    global wide_calls
    if width * tile > EXACT_TOPK_WIDTH:
        wide_calls += 1
        return window_topk_wide(
            query, support, k, tile=tile, width=width, window=window, mode=mode
        )
    return win_topk.window_topk(
        query, support, k, tile=tile, width=width, window=window, mode=mode
    )


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
    local_idx, _ = _window_topk(
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
    local, neg = _window_topk(
        query, support, k, tile=tile, width=width, window=window
    )
    starts = win_topk.window_start_tiles(gq, gs, width, window) * tile
    row0 = torch.as_tensor(starts, device=query.device).repeat_interleave(tile)
    idx = torch.where(local < width * tile, row0[None, :, None] + local, n)
    return idx.to(torch.int32), -neg
