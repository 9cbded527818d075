"""The flagship CBL stage loss over listed window slots, v2 (running
accumulator over label metadata): kernel wrappers, plain PyTorch versions,
launch counters and the autograd Function.

Replaces contrastboundary_tpu/ops/pallas/cbl_tile2.py::cbl_tile_softnn2
(forward _stats_call, backward _bwd_call and its overlap-add) and mirrors
its _row_meta (ops/cuda/cbl_dense.py::row_meta, the same function). The
CUDA kernels are ``csrc/cbl_tile2.cu``; the contract, the design and the
bound are noted there. The forward keeps its per-row statistics [B, M, 8]
for the backward, which so makes one pass where the TPU kernel recomputes
the statistics first: one forward and one backward launch a stage.

The plain versions walk the K slots in a loop of [B, M] and [B, M, C] ops
in the kernel's order: distances summed per lane of 32 channels, then by a
halving tree (the kernel's shuffle butterfly); the running max and the
rescaled sums of _chunk_update. ops/cuda/cbl_tile.py (v1) shares them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.masking import EPS, INF
from ...kernels import build
from . import tile_gather as _tg
from .cbl_dense import row_meta, self_window_starts

# kernel launches made by the wrappers below (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0

LOG_EPS = 1e-12
MAX_CHANNELS = 128  # a warp holds a row, at most 4 channels a lane


def check_geometry(x, li, tile: int, width: int):
    b, m = x.shape[:2]
    if x.dtype != torch.float32:
        raise TypeError(f"the CBL tile kernels take float32, got {x.dtype}")
    if li.shape[:2] != (b, m) or li.dim() != 3:
        raise ValueError(f"rows {tuple(x.shape)} vs li {tuple(li.shape)}")
    if m % tile or width > m // tile:
        raise ValueError(f"M={m} vs tile={tile}, width={width}")


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


def grad_plain(feat, amax, valid, li, stats, g_loss, temperature: float,
               tile: int, width: int, window: int):
    """d(Σ_b g_loss[b] · loss_sum[b]) / d feat [B, M, C] from the forward's
    statistics (the running max held constant)."""
    slot = _slots(feat, amax, valid, li, tile, width, window)
    b, m, c = feat.shape
    mr, p, n, mask = stats[..., 0], stats[..., 1], stats[..., 2], stats[..., 6]
    gl = g_loss.float()[:, None]
    n_safe = torch.clamp_min(n, EPS)
    inv = -1.0 / (p / n_safe + EPS)  # dL/dratio
    dP = inv / n_safe
    dN = -inv * p / (n_safe * n_safe)
    dfq = torch.zeros_like(feat)
    dx = torch.zeros((b * m, c), dtype=torch.float32, device=feat.device)
    for kk in range(li.shape[-1]):
        vk, d, pos, diff, rk = slot(kk)
        e = torch.exp(torch.where(vk > 0, (-d - mr) / temperature, -50.0)) * vk
        dd = (dP * pos + dN) * (-e / temperature) * mask * gl
        gk = (dd / d)[..., None] * diff
        dfq = dfq + gk
        dx.index_add_(0, rk.reshape(-1), -gk.reshape(-1, c))
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


def cuda_args(x, li, tile: int, width: int, window: int, *others):
    """Contiguous kernel operands on x's card (li as int32, the window
    starts appended); raises on other devices and widths."""
    if not (x.is_cuda and li.device == x.device and all(t.device == x.device for t in others)):
        raise ValueError(f"CBL tile kernel: tensors on {x.device}, {li.device}, "
                         f"{[t.device for t in others]}")
    check_geometry(x, li, tile, width)
    for t in others:
        if t.dtype != torch.float32:
            raise TypeError(f"the CBL tile kernels take float32, got {t.dtype}")
    starts = torch.as_tensor(self_window_starts(x.shape[1], tile, width, window),
                             dtype=torch.int32, device=x.device)
    return (x.contiguous(), li.to(torch.int32).contiguous(), starts,
            *(t.contiguous() for t in others))


def _check_width(c: int):
    if c > MAX_CHANNELS:
        raise ValueError(f"feature width {c} > {MAX_CHANNELS}")


def cbl_tile2_fwd(features, meta, li, temperature: float, tile: int, width: int,
                  window: int):
    """Stats forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global fwd_launches
    if features.device.type == "cpu":
        return cbl_tile2_fwd_plain(features, meta, li, temperature, tile, width, window)
    f, lii, starts, mt = cuda_args(features, li, tile, width, window, meta)
    b, m, c = f.shape
    _check_width(c)
    if mt.shape != (b, m, 8):
        raise ValueError(f"meta {tuple(mt.shape)} for rows {tuple(f.shape)}")
    stats = torch.empty((b, m, 8), dtype=torch.float32, device=f.device)
    if stats.numel() == 0:
        return stats
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_tile2_fwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), starts.data_ptr(), stats.data_ptr(),
        b, m, lii.shape[-1], c, tile, width, float(temperature), stream,
    )
    fwd_launches += 1
    build.check(rc, "cbl_tile2_fwd")
    return stats


def cbl_tile2_bwd(features, meta, li, stats, g_loss, temperature: float, tile: int,
                  width: int, window: int):
    """Feature gradient: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    global bwd_launches
    if features.device.type == "cpu":
        return cbl_tile2_bwd_plain(features, meta, li, stats, g_loss, temperature, tile,
                                   width, window)
    f, lii, starts, mt, st, gl = cuda_args(features, li, tile, width, window, meta, stats,
                                           g_loss)
    b, m, c = f.shape
    _check_width(c)
    if mt.shape != (b, m, 8) or st.shape != (b, m, 8) or gl.shape != (b,):
        raise ValueError(f"meta {tuple(mt.shape)}, stats {tuple(st.shape)}, "
                         f"g_loss {tuple(gl.shape)} for rows {tuple(f.shape)}")
    dx = torch.zeros_like(f)
    if dx.numel() == 0:
        return dx
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_tile2_bwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), starts.data_ptr(), st.data_ptr(),
        gl.data_ptr(), dx.data_ptr(), b, m, lii.shape[-1], c, tile, width,
        float(temperature), stream,
    )
    bwd_launches += 1
    build.check(rc, "cbl_tile2_bwd")
    return dx


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
