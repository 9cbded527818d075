"""The flagship CBL stage loss over listed window slots, v2 (running
accumulator over label metadata): kernel wrappers, their launch plans,
plain PyTorch versions, launch counters and the autograd Function.

Replaces contrastboundary_tpu/ops/pallas/cbl_tile2.py::cbl_tile_softnn2
(forward _stats_call, backward _bwd_call and its overlap-add) and mirrors
its _row_meta (ops/cuda/cbl_dense.py::row_meta, the same function). The
CUDA kernels are ``csrc/cbl_tile2.cu`` (and the scatter they share with the
dense route, ``csrc/slot_scatter.cuh``); the contract, the design and the
bound are noted there. The forward keeps its per-row statistics [B, M, 8]
for the backward, which so makes one pass where the TPU kernel recomputes
the statistics first: one forward and one backward launch a stage. The
kernel's forward writes lanes 0-2 only on the rows of the loss mask and
the fill (0, 0, 0) elsewhere; no output reads them there.

The kernels take rows of 32, 64, 128, 256 or 512 channels: other widths
up to 512 are padded with zero channels (``cbl_dense.padded_channels``), which leaves
every distance's bits unchanged, and the gradient is cut back. Up to 128
channels a lane holds the query row in registers; wider rows are read where
they are used. ``fwd_plan`` and ``bwd_plan`` give the launch geometry;
every shape the plain versions take (C <= 512) has one.

The plain versions walk the K slots in a loop of [B, M] and [B, M, C] ops
in the kernel's order: distances summed per lane of 32 channels, then by a
halving tree (the kernel's shuffle butterfly); the running max and the
rescaled sums of _chunk_update; the backward's neighbour terms added onto
their rows by one index_add_ in ascending slot order (q, then k), the
order of CPU index_add_ and of the kernel's scatter. ops/cuda/cbl_tile.py
(v1) shares them, the plans and the kernels.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ...core.masking import EPS, INF
from ...kernels import build
from . import tile_gather as _tg
from .cbl_dense import padded_channels, row_meta, self_window_starts

# kernel launches made by the wrappers below (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0

LOG_EPS = 1e-12
LANES = 8  # lanes a query row
THREADS = 256  # threads a block: 32 row groups
MAX_LABEL_ROWS = 128  # flat rows a block of the forward's label pass
MIN_ROWS = 32  # flat rows a block at least (label pass: halved down to it)
MAX_ROW_ROWS = 1024  # rows dealt to a block of the kernels over the mask's rows
DEAL = 8  # consecutive rows dealt together
SM_COUNT = 132  # H100 SXM
MAX_K = (1 << 23) - 1  # slots a row (the scatter's quotient)
# the scatter (csrc/slot_scatter.cuh): rows a block, at most 256 and 16384
# floats of accumulator; halved while a call has fewer than 256 blocks, down
# to 64 rows, then while it has fewer than 128, down to 16 (the fastest at
# each flagship level on an H100, rows a block swept from 16 to 256)
MAX_SCATTER_ROWS = 256
SCATTER_FLOATS = 16384
SCATTER_STEPS = ((256, 64), (128, 16))  # (blocks at least, rows at least)
SCATTER_SUPER = 4096  # slots a chunk of the scatter's scan (window_sort.cuh)


def check_geometry(x, li, tile: int, width: int):
    b, m = x.shape[:2]
    if x.dtype != torch.float32:
        raise TypeError(f"the CBL tile kernels take float32, got {x.dtype}")
    if li.shape[:2] != (b, m) or li.dim() != 3:
        raise ValueError(f"rows {tuple(x.shape)} vs li {tuple(li.shape)}")
    if m % tile or width > m // tile:
        raise ValueError(f"M={m} vs tile={tile}, width={width}")


def lane_slots(k: int, channels: int):
    """The split of a row's K slots → (slots a lane a chunk S, chunks):
    chunk c, lane l holds slots c·8·S + 8·j + l (j < S, those below K).
    S = 3, 5 or 8 by ⌈K / 8⌉ at 32 channels, 4 at wider rows (the kernel's
    instantiations)."""
    spl = -(-k // LANES)
    s = 4 if channels > 32 else 3 if spl <= 3 else 5 if spl <= 5 else 8
    return s, -(-k // (LANES * s))


class RowPlan(NamedTuple):
    """Launch geometry of the forward and of the backward's first pass."""
    channels: int  # the row width the kernels read (C padded)
    slots: int  # slots a lane a chunk
    chunks: int  # chunks a row
    label_rows: int  # flat rows a block of the forward's label pass
    label_blocks: int
    row_rows: int  # rows dealt to a block of the kernels over the mask's rows
    row_blocks: int


def fwd_plan(b: int, m: int, k: int, c: int) -> RowPlan:
    """The forward's geometry (blocks of 256 threads, 8 lanes a row): the
    label pass over the B·M flat rows, MAX_LABEL_ROWS consecutive rows a
    block, halved (down to MIN_ROWS) while a call has fewer blocks than the
    card's SMs; the rows of the mask (in the backward, those with g != 0)
    by two blocks an SM (the most that are resident at once), the B·M rows
    dealt round them in chunks of DEAL consecutive rows, at least MIN_ROWS
    (a row a row group where every row is in the mask) and at most
    MAX_ROW_ROWS a block."""
    channels = padded_channels(c)
    if k > MAX_K:
        raise ValueError(f"K = {k} slots a row (limit {MAX_K})")
    if b * m >= 1 << 30:
        raise ValueError(f"{b * m} rows (limit 2^30)")
    rows = MAX_LABEL_ROWS
    while rows > MIN_ROWS and -(-b * m // rows) < SM_COUNT:
        rows //= 2
    row_rows = min(max(-(-b * m // (2 * SM_COUNT * DEAL)) * DEAL, MIN_ROWS), MAX_ROW_ROWS)
    return RowPlan(channels, *lane_slots(k, channels), rows, -(-b * m // rows), row_rows,
                   -(-b * m // row_rows))


class BwdPlan(NamedTuple):
    """Launch geometry of the backward: pass 1 as the forward, then the
    scatter."""
    pass1: RowPlan
    scatter_rows: int  # support rows a scatter block (a divisor of the tile)
    scatter_grid: tuple  # (blocks, clouds)
    scatter_smem: int  # dynamic shared bytes a scatter block


def scatter_max_rows(channels: int) -> int:
    return min(MAX_SCATTER_ROWS, SCATTER_FLOATS // channels)


def bwd_plan(b: int, m: int, k: int, c: int, tile: int) -> BwdPlan:
    """The backward's geometry: pass 1 as ``fwd_plan``; the scatter's rows a
    block the largest power-of-two divisor of the tile up to
    ``scatter_max_rows``, halved as SCATTER_STEPS says."""
    pass1 = fwd_plan(b, m, k, c)
    rows = min(tile & -tile, scatter_max_rows(pass1.channels))
    for min_blocks, min_rows in SCATTER_STEPS:
        while rows > min_rows and (m // rows) * b < min_blocks:
            rows //= 2
    smem = (2 * rows * pass1.channels + 2 * SCATTER_SUPER) * 4
    return BwdPlan(pass1, rows, ((m // tile) * (tile // rows), b), smem)


def _lane_sum(x):
    """Σ over the last axis in the kernel's order: per lane l the channels
    l, l + 32, ... in turn, then the 32 lanes by a halving tree."""
    c = x.shape[-1]
    cpl = -(-c // 32)
    x = F.pad(x, (0, 32 * cpl - c)).reshape(*x.shape[:-1], cpl, 32)
    acc = torch.zeros_like(x[..., 0, :])
    for j in range(cpl):
        acc = acc + x[..., j, :]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _slots(feat, amax, valid, li, tile, width, window):
    """slot(kk) → (v [B, M], d [B, M], pos [B, M], diff [B, M, C], rows
    [B, M]) of slot kk: v = 1 for a slot in the window whose label is valid."""
    b, m, c = feat.shape
    starts = torch.as_tensor(self_window_starts(m, tile, width, window), device=feat.device)
    rows, member = _tg._rows(li, starts, tile, width, m)
    f, a, v = feat.reshape(b * m, c), amax.reshape(-1), valid.reshape(-1)

    def slot(kk):
        rk = rows[..., kk]
        vk = member[..., kk].float() * v[rk]
        diff = feat - f[rk]
        d = torch.sqrt(_lane_sum(diff * diff) + LOG_EPS)
        pos = ((a[rk] - amax).abs() < 0.5).float() * vk
        return vk, d, pos, diff, rk

    return slot


def stats_plain(feat, amax, valid, li, temperature: float, tile: int, width: int,
                window: int, online: bool):
    """Per-row statistics [B, M, 8] = (m, Σe·pos, Σe, pos count, valid count,
    loss·mask, mask, 0) of rows feat [B, M, C] with label argmax and
    validity [B, M]; online (v2): running max with rescaled sums, else (v1)
    the max first."""
    slot = _slots(feat, amax, valid, li, tile, width, window)
    k = li.shape[-1]
    mr = torch.full(amax.shape, -INF, dtype=torch.float32, device=feat.device)
    p, n, pc, vc = (torch.zeros_like(mr) for _ in range(4))
    if not online:
        for kk in range(k):
            vk, d = slot(kk)[:2]
            mr = torch.where(vk > 0, torch.maximum(mr, -d), mr)
    for kk in range(k):
        vk, d, pos = slot(kk)[:3]
        ok = vk > 0
        if online:
            m_new = torch.where(ok, torch.maximum(mr, -d), mr)
            scale = torch.exp((mr - m_new) / temperature)
            e = torch.exp(torch.where(ok, (-d - m_new) / temperature, -50.0)) * vk
            p = p * scale + e * pos
            n = n * scale + e
            mr = m_new
        else:
            e = torch.exp(torch.where(ok, (-d - mr) / temperature, -50.0)) * vk
            p = p + e * pos
            n = n + e
        pc = pc + pos
        vc = vc + vk
    loss = -torch.log(p / torch.clamp_min(n, EPS) + EPS)
    mask = ((pc > 0) & (pc < vc) & (valid > 0)).float()
    return torch.stack([mr, p, n, pc, vc, loss * mask, mask, torch.zeros_like(mr)], -1)


def grad_coefs_plain(feat, amax, valid, li, stats, g_loss, temperature: float,
                     tile: int, width: int, window: int):
    """Each slot's gradient coefficient and row → (coef [B, M, K], rows
    [B, M, K]): coef = dd / d (0 where the slot adds nothing) from the
    forward's statistics (the running max held constant), rows the flat row
    b·M + s it names (0 for a shadow slot)."""
    slot = _slots(feat, amax, valid, li, tile, width, window)
    mr, p, n, mask = stats[..., 0], stats[..., 1], stats[..., 2], stats[..., 6]
    gl = g_loss.float()[:, None]
    n_safe = torch.clamp_min(n, EPS)
    inv = -1.0 / (p / n_safe + EPS)  # dL/dratio
    dP = inv / n_safe
    dN = -inv * p / (n_safe * n_safe)
    coefs, rows = [], []
    for kk in range(li.shape[-1]):
        vk, d, pos, _, rk = slot(kk)
        e = torch.exp(torch.where(vk > 0, (-d - mr) / temperature, -50.0)) * vk
        dd = (dP * pos + dN) * (-e / temperature) * mask * gl
        coefs.append(dd / d)
        rows.append(rk)
    b, m = amax.shape
    if not coefs:
        return (torch.zeros((b, m, 0), device=feat.device),
                torch.zeros((b, m, 0), dtype=torch.long, device=feat.device))
    return torch.stack(coefs, -1), torch.stack(rows, -1)


def grad_plain(feat, amax, valid, li, stats, g_loss, temperature: float,
               tile: int, width: int, window: int):
    """d(Σ_b g_loss[b] · loss_sum[b]) / d feat [B, M, C] from the forward's
    statistics (the running max held constant): the query's own part Σₖ gk
    in slot order, gk = coef·(q − s), plus each slot's −gk added onto its
    row by one index_add_ in ascending slot order."""
    coef, rows = grad_coefs_plain(feat, amax, valid, li, stats, g_loss, temperature, tile,
                                  width, window)
    b, m, c = feat.shape
    gk = coef[..., None] * (feat[:, :, None, :] - feat.reshape(b * m, c)[rows])
    dfq = torch.zeros_like(feat)
    for kk in range(coef.shape[-1]):
        dfq = dfq + gk[:, :, kk]
    dx = torch.zeros((b * m, c), dtype=torch.float32, device=feat.device)
    dx.index_add_(0, rows.reshape(-1), -gk.reshape(-1, c))
    return dx.reshape(b, m, c) + dfq


def cbl_tile2_fwd_plain(features, meta, li, temperature: float, tile: int,
                        width: int, window: int):
    """Plain PyTorch version of the forward → stats [B, M, 8]."""
    check_geometry(features, li, tile, width)
    return stats_plain(features, meta[..., 0], meta[..., 1], li, temperature, tile,
                       width, window, online=True)


def cbl_tile2_bwd_plain(features, meta, li, stats, g_loss, temperature: float,
                        tile: int, width: int, window: int):
    """Plain PyTorch version of the backward → dfeatures [B, M, C]."""
    check_geometry(features, li, tile, width)
    return grad_plain(features, meta[..., 0], meta[..., 1], li, stats, g_loss,
                      temperature, tile, width, window)


def _check_card(x, li, tile: int, width: int, others):
    if not (x.is_cuda and li.device == x.device and all(t.device == x.device for t in others)):
        raise ValueError(f"CBL tile kernel: tensors on {x.device}, {li.device}, "
                         f"{[t.device for t in others]}")
    check_geometry(x, li, tile, width)
    for t in others:
        if t.dtype != torch.float32:
            raise TypeError(f"the CBL tile kernels take float32, got {t.dtype}")


def _aligned(t):
    """t contiguous at a 16-byte address (the kernels read float4s)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def v2_operands(features, meta, li, tile: int, width: int, *others):
    """The v2 kernels' operands on the features' card: features padded with
    zero channels to the kernel's width, meta and ``others`` float32, li
    int32, each contiguous and 16-byte aligned; raises on other devices,
    types and shapes."""
    _check_card(features, li, tile, width, (meta,) + others)
    b, m, c = features.shape
    channels = padded_channels(c)
    if meta.shape != (b, m, 8):
        raise ValueError(f"meta {tuple(meta.shape)} for rows {tuple(features.shape)}")
    f = features if channels == c else F.pad(features, (0, channels - c))
    return (_aligned(f), _aligned(meta), _aligned(li.to(torch.int32)),
            *(_aligned(t) for t in others))


def cbl_tile2_fwd(features, meta, li, temperature: float, tile: int, width: int,
                  window: int):
    """Stats forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global fwd_launches
    if features.device.type == "cpu":
        return cbl_tile2_fwd_plain(features, meta, li, temperature, tile, width, window)
    f, mt, lii = v2_operands(features, meta, li, tile, width)
    b, m, c = features.shape
    k = lii.shape[-1]
    plan = fwd_plan(b, m, k, c)
    stats = torch.empty((b, m, 8), dtype=torch.float32, device=f.device)
    if stats.numel() == 0:
        return stats
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_tile2_fwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), stats.data_ptr(), b, m, k,
        plan.channels, tile, width, window, float(temperature), plan.label_rows,
        plan.row_rows, stream,
    )
    fwd_launches += 1
    build.check(rc, "cbl_tile2_fwd")
    return stats


def cbl_tile2_bwd_passes(features, meta, li, stats, g_loss, temperature: float,
                         tile: int, width: int, window: int):
    """The backward kernel on CUDA tensors → (dfeatures, coef): pass 1's
    slot coefficients come back from their scratch tensor, written on the
    rows of the mask with g != 0 only."""
    global bwd_launches
    f, mt, lii, st, gl = v2_operands(features, meta, li, tile, width, stats, g_loss)
    b, m, c = features.shape
    k = lii.shape[-1]
    if st.shape != (b, m, 8) or gl.shape != (b,):
        raise ValueError(f"stats {tuple(st.shape)}, g_loss {tuple(gl.shape)} for rows "
                         f"{tuple(features.shape)}")
    plan = bwd_plan(b, m, k, c, tile)
    coef = torch.empty((b, m, k), dtype=torch.float32, device=f.device)
    lands = torch.empty((b, m, k), dtype=torch.int32, device=f.device)
    dx = torch.empty_like(f)
    if dx.numel() == 0:
        return dx[..., :c], coef
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_tile2_bwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), st.data_ptr(), gl.data_ptr(),
        coef.data_ptr(), lands.data_ptr(), dx.data_ptr(), b, m, k, plan.pass1.channels,
        tile, width, window, float(temperature), plan.pass1.row_rows, plan.scatter_rows,
        stream,
    )
    bwd_launches += 1
    build.check(rc, "cbl_tile2_bwd")
    return (dx if plan.pass1.channels == c else dx[..., :c].contiguous()), coef


def cbl_tile2_bwd(features, meta, li, stats, g_loss, temperature: float, tile: int,
                  width: int, window: int):
    """Feature gradient: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if features.device.type == "cpu":
        return cbl_tile2_bwd_plain(features, meta, li, stats, g_loss, temperature, tile,
                                   width, window)
    return cbl_tile2_bwd_passes(features, meta, li, stats, g_loss, temperature, tile, width,
                                window)[0]


class _CblTile2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, meta, li, temperature, tile, width, window):
        stats = cbl_tile2_fwd(features, meta, li, temperature, tile, width, window)
        ctx.save_for_backward(features, meta, li, stats)
        ctx.args = (temperature, tile, width, window)
        loss_sum, mask_sum = stats[..., 5].sum(-1), stats[..., 6].sum(-1)
        ctx.mark_non_differentiable(mask_sum)  # labels only
        return loss_sum, mask_sum

    @staticmethod
    def backward(ctx, g_loss, _g_mask):
        features, meta, li, stats = ctx.saved_tensors
        dx = cbl_tile2_bwd(features, meta, li, stats, g_loss.contiguous(), *ctx.args)
        return dx, None, None, None, None, None, None


def cbl_tile_softnn2(features, label_soft, li, temperature: float, tile: int,
                     width: int, window: int):
    """Flagship CBL stage loss (softnn · l2 · cnt), v2: features [B, M, C]
    f32 sorted rows (pre-normalised for norml2), label_soft [B, M, ncls]
    (no gradient), li [B, M, K] window-relative (shadow width·tile) →
    (loss_sum [B], mask_sum [B]); the caller takes Σ loss_sum / max(Σ
    mask_sum, 1)."""
    return _CblTile2.apply(features, row_meta(label_soft.float()), li, float(temperature),
                           tile, width, window)
