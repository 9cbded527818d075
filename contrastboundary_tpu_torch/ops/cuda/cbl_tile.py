"""The flagship CBL stage loss over listed window slots, v1 (fused [soft
labels | features] rows, the max of −d first): kernel wrappers, the launch
plan, plain PyTorch versions, launch counters and the autograd Function.

Replaces contrastboundary_tpu/ops/pallas/cbl_tile.py::cbl_tile_softnn
(forward _fwd_call over _tile_stats, backward _bwd_call). It computes the
function of v2 (ops/cuda/cbl_tile2.py), whose device code, launch plans and
plain versions it shares (``csrc/cbl_tile2.cu``): a slot's class is the
first maximum of its ncls label columns and it is valid when they sum above
0; the forward takes the max of −d over valid slots, then the sums; the
label columns get no gradient. The kernels split the fused rows into v2's
operands once a call (``split_plain`` is that split: meta as
ops/cuda/cbl_dense.py::row_meta writes it, the features padded with zero
channels to 32, 64 or 128), run v2's kernels on them (the forward combining
a row's slots as v1 does) and, in the backward, write the gradient back
into fused rows with zero label columns. As in v2, the forward computes
lanes 0-2 only on the rows of the loss mask and writes the fill (0, 0, 0)
elsewhere. As in the reference, no path of the system calls it.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ...kernels import build
from .cbl_tile2 import (
    BwdPlan, _check_card, bwd_plan, check_geometry, grad_plain, padded_channels, stats_plain,
)

MAX_CHANNELS = 128  # feature columns the split takes (padded to 32, 64 or 128)

# kernel launches made by the wrappers below (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0


def split_plain(fused, ncls: int):
    """The kernels' split of fused rows [B, M, ncls + C] → (features [B, M,
    C'] with zero channels to C' = 32, 64 or 128, meta [B, M, 8]): the label
    columns walked in order, the first maximum kept by a strict compare and
    the columns summed in turn; meta lane 0 that argmax as a float, lane 1
    1 where the sum is above 0, the rest 0."""
    if not 1 <= ncls < fused.shape[-1]:
        raise ValueError(f"ncls={ncls} of {fused.shape[-1]} columns")
    lab = fused[..., :ncls]
    best = total = lab[..., 0]
    arg = torch.zeros_like(best)
    for j in range(1, ncls):
        v = lab[..., j]
        up = v > best
        best, arg = torch.where(up, v, best), torch.where(up, float(j), arg)
        total = total + v
    meta = torch.zeros(fused.shape[:-1] + (8,), dtype=torch.float32, device=fused.device)
    meta[..., 0] = arg
    meta[..., 1] = (total > 0).float()
    c = fused.shape[-1] - ncls
    return F.pad(fused[..., ncls:], (0, padded_channels(c, MAX_CHANNELS) - c)), meta


def _split(fused, ncls: int):
    """(features, label argmax as float, validity) of fused rows."""
    features, meta = split_plain(fused, ncls)
    return features[..., :fused.shape[-1] - ncls], meta[..., 0], meta[..., 1]


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


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, m: int, k: int, columns: int, ncls: int, tile: int) -> BwdPlan:
    """The kernels' launch geometry for fused rows of ``columns`` columns:
    v2's (ops/cuda/cbl_tile2.py::bwd_plan, the forward's in its pass1) on
    the C = columns − ncls feature channels; raises on the widths the
    kernels do not take (ncls < 1, C outside 1 to 128). Cached: the
    wrappers ask for it on every call."""
    if ncls < 1:
        raise ValueError(f"ncls={ncls}: the label columns are at least one")
    padded_channels(columns - ncls, MAX_CHANNELS)
    return bwd_plan(b, m, k, columns - ncls, tile)


def _operands(fused, li, ncls: int, tile: int, width: int, *others):
    """The kernels' operands on fused's card: fused and ``others`` float32
    and contiguous, li int32 (the kernels read them a float or an int at a
    time); and the launch plan. Raises on other devices, types and widths."""
    _check_card(fused, li, tile, width, others)
    b, m, columns = fused.shape
    plan = launch_plan(b, m, li.shape[-1], columns, ncls, tile)
    return (plan, fused.contiguous(), li.to(torch.int32).contiguous(),
            *(t.contiguous() for t in others))


def cbl_tile_fwd(fused, li, ncls: int, temperature: float, tile: int, width: int,
                 window: int):
    """Stats forward: the CUDA kernels for CUDA tensors, the plain version
    for CPU tensors."""
    global fwd_launches
    if fused.device.type == "cpu":
        return cbl_tile_fwd_plain(fused, li, ncls, temperature, tile, width, window)
    plan, x, lii = _operands(fused, li, ncls, tile, width)
    p1 = plan.pass1
    b, m, columns = x.shape
    stats = torch.empty((b, m, 8), dtype=torch.float32, device=x.device)
    if stats.numel() == 0:
        return stats
    # the split's features and meta in one allocation
    flat = torch.empty(b * m * (p1.channels + 8), dtype=torch.float32, device=x.device)
    f, meta = torch.split(flat, (b * m * p1.channels, b * m * 8))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().cbl_tile_fwd(
        x.data_ptr(), lii.data_ptr(), f.data_ptr(), meta.data_ptr(), stats.data_ptr(), b, m,
        lii.shape[-1], columns - ncls, ncls, tile, width, window, float(temperature),
        p1.label_rows, p1.row_rows, stream,
    )
    fwd_launches += 1
    build.check(rc, "cbl_tile_fwd")
    return stats


def cbl_tile_bwd(fused, li, stats, g_loss, ncls: int, temperature: float, tile: int,
                 width: int, window: int):
    """Fused-row gradient: the CUDA kernels for CUDA tensors, the plain
    version for CPU tensors."""
    global bwd_launches
    if fused.device.type == "cpu":
        return cbl_tile_bwd_plain(fused, li, stats, g_loss, ncls, temperature, tile, width,
                                  window)
    plan, x, lii, st, gl = _operands(fused, li, ncls, tile, width, stats, g_loss)
    b, m, columns = x.shape
    k = lii.shape[-1]
    if st.shape != (b, m, 8) or gl.shape != (b,):
        raise ValueError(f"stats {tuple(st.shape)}, g_loss {tuple(gl.shape)} for rows "
                         f"{tuple(x.shape)}")
    dfused = torch.empty_like(x)
    if dfused.numel() == 0:
        return dfused
    # the split's features and meta, the padded gradient and the slot
    # coefficients in one allocation (each part 16-byte aligned but the
    # last), the slots' landing rows in another
    ch = plan.pass1.channels
    flat = torch.empty(b * m * (2 * ch + 8 + k), dtype=torch.float32, device=x.device)
    f, dx, meta, coef = torch.split(flat, (b * m * ch, b * m * ch, b * m * 8, b * m * k))
    lands = torch.empty(b * m * k, dtype=torch.int32, device=x.device)
    scratch = (f, meta, coef, lands, dx)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().cbl_tile_bwd(
        x.data_ptr(), lii.data_ptr(), st.data_ptr(), gl.data_ptr(),
        *(t.data_ptr() for t in scratch), dfused.data_ptr(), b, m, k, columns - ncls, ncls,
        tile, width, window, float(temperature), plan.pass1.row_rows, plan.scatter_rows,
        stream,
    )
    bwd_launches += 1
    build.check(rc, "cbl_tile_bwd")
    return dfused


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
