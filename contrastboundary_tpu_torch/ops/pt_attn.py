"""Fused point-transformer attention under stale BatchNorm (counterpart of
contrastboundary_tpu/ops/pallas/pt_attn.py::pt_attn and its custom VJP).

One autograd Function: its forward is ops/cuda/pt_attn.py::pt_attn_fwd, its
backward ::pt_attn_bwd; the plain PyTorch versions of both
(``pt_attn_plain``, the forward written from the TPU module's
``pt_attn_reference``, and ``pt_attn_bwd_plain``, the analytic backward) are
the CPU path and the on-card reference. The backward keeps only (q, kv, rel,
li, params) and recomputes every per-slot activation, as the TPU kernel's
VJP does.
"""
from __future__ import annotations

import functools
from typing import Sequence

import torch

from .cuda import pt_attn as _pa
from .cuda.pt_attn import pt_attn_bwd_plain, pt_attn_plain
from .tile_gather import window_starts

__all__ = ["pt_attn", "pt_attn_plain", "pt_attn_bwd_plain"]


class _PtAttn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, kv, rel, li, starts, tile, width, *params):
        out, s1, s2 = _pa.pt_attn_fwd(q, kv, rel, li, starts, tile, width, params)
        ctx.save_for_backward(q, kv, rel, li, starts, *params)
        ctx.geometry = (tile, width)
        ctx.mark_non_differentiable(s1, s2)
        return out, s1, s2

    @staticmethod
    def backward(ctx, g_out, _g_s1, _g_s2):
        q, kv, rel, li, starts, *params = ctx.saved_tensors
        dq, dkv, dparams = _pa.pt_attn_bwd(q, kv, rel, li, starts, *ctx.geometry, params, g_out)
        return (dq, dkv, None, None, None, None, None, *dparams)


@functools.lru_cache(maxsize=None)
def _starts(num_tiles: int, width: int, device: torch.device) -> torch.Tensor:
    """The self geometry's window starts on ``device``, copied there once per
    (tiles, width); the kernels only read them."""
    return torch.as_tensor(window_starts(num_tiles, width), dtype=torch.int32, device=device)


def pt_attn(q: torch.Tensor, kv: torch.Tensor, rel: torch.Tensor, li: torch.Tensor,
            tile: int, width: int, params: Sequence[torch.Tensor]):
    """q [B, M, C], kv [B, M, 2C], rel [B, M, K, 3], li [B, M, K] in the self
    geometry (window (width − 1) // 2, shadow width·tile), and the 12 folded
    tower arrays (ops/cuda/pt_attn.py) → (out [B, M, C], s1 [2, C], s2
    [2, Cs]): s1 and s2 are the batch mean and mean of squares of the bn1 and
    bn2 inputs over every slot, without gradient. Gradients flow to q, kv and
    the 12 arrays."""
    return _PtAttn.apply(q, kv, rel, li, _starts(q.shape[1] // tile, width, q.device), tile,
                         width, *params)
