"""Tile-window gathers in Morton-sorted space (counterpart of
contrastboundary_tpu/ops/tile_gather.py): out[b, q, k] = x[b, starts[q //
tile]·tile + idx] for a window-relative idx < W, zeros for the shadow index
W. Both geometries are one autograd Function: its forward is
ops/cuda/tile_gather.py::window_gather, its backward ::window_gather_bwd
(each slot's gradient row added onto its support row, summed in float32 and
returned in g's dtype, which autograd makes x's, float32 or bfloat16, as
the reference's backward casts its float32 sum to x's dtype)."""
from __future__ import annotations

import numpy as np
import torch

from .cuda import tile_gather as _tg
from .cuda.win_topk import window_start_tiles


def window_starts(num_tiles: int, width: int) -> np.ndarray:
    """Per-tile window starts (tiles) of the self geometry, edge-clipped so
    every window has exactly ``width`` tiles."""
    return window_start_tiles(num_tiles, num_tiles, width, (width - 1) // 2)


def cross_window_starts(gq: int, gs: int, width: int, window: int) -> np.ndarray:
    """Support-window starts (tiles) of the cross geometry: query tile g
    spans support tiles around (g·gs)//gq."""
    return window_start_tiles(gq, gs, width, window)


class _WindowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, local_idx, starts, tile, width):
        ctx.save_for_backward(local_idx, starts)
        ctx.geometry = (tile, width, x.shape[1])
        return _tg.window_gather(x, local_idx, starts, tile, width)

    @staticmethod
    def backward(ctx, g):
        local_idx, starts = ctx.saved_tensors
        tile, width, n_support = ctx.geometry
        dx = _tg.window_gather_bwd(g, local_idx, starts, tile, width, n_support)
        return dx, None, None, None, None


def _gather(x, local_idx, starts, tile, width):
    st = torch.as_tensor(starts, dtype=torch.int32, device=x.device)
    return _WindowGather.apply(x, local_idx, st, tile, width)


def tile_window_gather(x: torch.Tensor, local_idx: torch.Tensor, tile: int,
                       width: int) -> torch.Tensor:
    """x [B, M, C] sorted rows, local_idx [B, M, K] in the self geometry →
    [B, M, K, C]."""
    return _gather(x, local_idx, window_starts(x.shape[1] // tile, width), tile, width)


def cross_window_gather(x: torch.Tensor, local_idx: torch.Tensor, n_support: int,
                        tile: int, width: int, window: int) -> torch.Tensor:
    """x [B, N, C] support rows, local_idx [B, Mq, K] in the tile_cross_knn
    geometry → [B, Mq, K, C]."""
    gq = local_idx.shape[1] // tile
    starts = cross_window_starts(gq, n_support // tile, width, window)
    return _gather(x, local_idx, starts, tile, width)
