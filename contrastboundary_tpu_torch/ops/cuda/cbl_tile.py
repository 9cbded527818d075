"""The flagship CBL stage loss over listed window slots, v1 (two passes over
fused [soft labels | features] rows): kernel wrappers, plain PyTorch
versions, launch counters and the autograd Function.

Replaces contrastboundary_tpu/ops/pallas/cbl_tile.py::cbl_tile_softnn
(forward _fwd_call over _tile_stats, backward _bwd_call). It computes the
function of v2 (ops/cuda/cbl_tile2.py), whose device code and plain
versions it shares (``csrc/cbl_tile2.cu``): a slot's class is the first
maximum of its ncls label columns and it is valid when they sum above 0;
the forward takes the max of −d over valid slots, then the sums; the label
columns get no gradient. As in the reference, no path of the system calls
it.
"""
from __future__ import annotations

import torch

from ...kernels import build
from .cbl_tile2 import (
    MAX_CHANNELS, check_geometry, cuda_args, grad_plain, stats_plain,
)

# kernel launches made by the wrappers below (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0

MAX_CLASSES = 32  # one label column a lane


def _split(fused, ncls: int):
    """(features, label argmax as float, validity) of fused rows."""
    lab = fused[..., :ncls]
    return fused[..., ncls:], lab.argmax(-1).float(), (lab.sum(-1) > 0).float()


def cbl_tile_fwd_plain(fused, li, ncls: int, temperature: float, tile: int,
                       width: int, window: int):
    """Plain PyTorch version of the forward → stats [B, M, 8]."""
    check_geometry(fused, li, tile, width)
    return stats_plain(*_split(fused, ncls), li, temperature, tile, width, window,
                       online=False)


def cbl_tile_bwd_plain(fused, li, stats, g_loss, ncls: int, temperature: float,
                       tile: int, width: int, window: int):
    """Plain PyTorch version of the backward → dfused [B, M, ncls + C], zero
    in the label columns."""
    check_geometry(fused, li, tile, width)
    dfeat = grad_plain(*_split(fused, ncls), li, stats, g_loss, temperature, tile,
                       width, window)
    return torch.cat([torch.zeros_like(fused[..., :ncls]), dfeat], -1)


def _check_widths(cl: int, ncls: int):
    if not 1 <= ncls <= MAX_CLASSES or not 0 < cl - ncls <= MAX_CHANNELS:
        raise ValueError(f"ncls={ncls} of {cl} columns (at most {MAX_CLASSES} label "
                         f"and {MAX_CHANNELS} feature columns)")


def cbl_tile_fwd(fused, li, ncls: int, temperature: float, tile: int, width: int,
                 window: int):
    """Stats forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global fwd_launches
    if fused.device.type == "cpu":
        return cbl_tile_fwd_plain(fused, li, ncls, temperature, tile, width, window)
    x, lii, starts = cuda_args(fused, li, tile, width, window)
    b, m, cl = x.shape
    _check_widths(cl, ncls)
    stats = torch.empty((b, m, 8), dtype=torch.float32, device=x.device)
    if stats.numel() == 0:
        return stats
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().cbl_tile_fwd(
        x.data_ptr(), lii.data_ptr(), starts.data_ptr(), stats.data_ptr(),
        b, m, lii.shape[-1], cl - ncls, ncls, tile, width, float(temperature), stream,
    )
    fwd_launches += 1
    build.check(rc, "cbl_tile_fwd")
    return stats


def cbl_tile_bwd(fused, li, stats, g_loss, ncls: int, temperature: float, tile: int,
                 width: int, window: int):
    """Fused-row gradient: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global bwd_launches
    if fused.device.type == "cpu":
        return cbl_tile_bwd_plain(fused, li, stats, g_loss, ncls, temperature, tile, width,
                                  window)
    x, lii, starts, st, gl = cuda_args(fused, li, tile, width, window, stats, g_loss)
    b, m, cl = x.shape
    _check_widths(cl, ncls)
    if st.shape != (b, m, 8) or gl.shape != (b,):
        raise ValueError(f"stats {tuple(st.shape)}, g_loss {tuple(gl.shape)} for rows "
                         f"{tuple(x.shape)}")
    dx = torch.zeros_like(x)
    if dx.numel() == 0:
        return dx
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().cbl_tile_bwd(
        x.data_ptr(), lii.data_ptr(), starts.data_ptr(), st.data_ptr(), gl.data_ptr(),
        dx.data_ptr(), b, m, lii.shape[-1], cl - ncls, ncls, tile, width,
        float(temperature), stream,
    )
    bwd_launches += 1
    build.check(rc, "cbl_tile_bwd")
    return dx


class _CblTile(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fused, li, ncls, temperature, tile, width, window):
        stats = cbl_tile_fwd(fused, li, ncls, temperature, tile, width, window)
        ctx.save_for_backward(fused, li, stats)
        ctx.args = (ncls, temperature, tile, width, window)
        loss_sum, mask_sum = stats[..., 5].sum(-1), stats[..., 6].sum(-1)
        ctx.mark_non_differentiable(mask_sum)  # labels only
        return loss_sum, mask_sum

    @staticmethod
    def backward(ctx, g_loss, _g_mask):
        fused, li, stats = ctx.saved_tensors
        dx = cbl_tile_bwd(fused, li, stats, g_loss.contiguous(), *ctx.args)
        return dx, None, None, None, None, None, None


def cbl_tile_softnn(fused, li, ncls: int, temperature: float, tile: int, width: int,
                    window: int):
    """Flagship CBL stage loss, v1: fused [B, M, ncls + C] f32 sorted rows
    ([soft labels | features]), li [B, M, K] window-relative (shadow
    width·tile) → (loss_sum [B], mask_sum [B]), as
    ops/cuda/cbl_tile2.py::cbl_tile_softnn2."""
    return _CblTile.apply(fused, li, int(ncls), float(temperature), tile, width, window)
