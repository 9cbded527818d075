"""CBL softnn statistics over window slots: kernel wrappers, plain PyTorch
versions, launch counters, and the stage loss assembled from them.

Replaces contrastboundary_tpu/ops/pallas/cbl_dense.py::cbl_dense_stats
(forward _fwd_call, backward _bwd_call) and mirrors its ::cbl_dense_loss and
::_row_meta. The CUDA kernels are ``csrc/cbl_dense.cu``; the contract, the
design and the bound are noted there. The function is that of the TPU
kernel (d² by the clamped expansion |q|² + |s|² − 2q·s, the max-shift over
valid members, the −50 fill, the cancellation floor of the backward), but it
is evaluated on the K listed slots only: the slots of a row are distinct by
construction (window top-k), which the TPU kernel's membership mask also
assumes. The plain versions round every product and sum of the distances in
the kernel's order.
"""
from __future__ import annotations

import numpy as np
import torch

from ...core.masking import EPS, INF, masked_mean
from ...kernels import build
from . import tile_gather as _tg
from .win_topk import window_start_tiles

# kernel launches made by the wrappers below (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0

CHANNELS = 32  # the feature width the kernels are built for (base_fdim)


def _inv_t(temperature: float) -> float:
    return float(np.float32(1.0) / np.float32(temperature))


def self_window_starts(m: int, tile: int, width: int, window: int) -> np.ndarray:
    """Window start tiles of the self geometry over M rows."""
    g = m // tile
    return window_start_tiles(g, g, width, window)


def _check(features, meta, li, tile, width):
    b, m, c = features.shape
    if meta.shape != (b, m, 8) or li.shape[:2] != (b, m):
        raise ValueError(
            f"bad shapes features {tuple(features.shape)}, meta {tuple(meta.shape)}, "
            f"li {tuple(li.shape)}"
        )
    if m % tile or width > m // tile:
        raise ValueError(f"M={m} vs tile={tile}, width={width}")


def _seq_dot(a, b):
    """Σ_c a·b over the last axis, added in channel order (the kernel's)."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = acc + a[..., i] * b[..., i]
    return acc


def _slot_terms(features, meta, li, temperature, tile, width, window):
    """Per-slot terms of the plain versions ([B, M, K] unless noted)."""
    _check(features, meta, li, tile, width)
    b, m, c = features.shape
    starts = torch.as_tensor(self_window_starts(m, tile, width, window), device=features.device)
    rows, member = _tg._rows(li, starts, tile, width, m)
    q = features.float()
    s = q.reshape(b * m, c)[rows]  # [B, M, K, C]
    s_meta = meta.float().reshape(b * m, 8)[rows]
    mv = member.float() * s_meta[..., 1]
    posmv = ((meta[:, :, None, 0] - s_meta[..., 0]).abs() < 0.5).float() * mv
    q2 = _seq_dot(q, q)[..., None]
    scale2 = q2 + _seq_dot(s, s)
    qe = q[:, :, None, :].expand_as(s)
    d2 = torch.clamp_min(scale2 - 2.0 * _seq_dot(qe, s), 0.0)
    dist = torch.sqrt(d2 + 1e-12)
    valid = mv > 0
    m_hat = torch.where(valid, -dist, -INF).amax(-1, keepdim=True)
    arg = torch.where(valid, (-dist - m_hat) * _inv_t(temperature), -50.0)
    e = torch.exp(arg) * mv
    return dict(q=q, s=s, mv=mv, posmv=posmv, d2=d2, scale2=scale2, dist=dist,
                m_hat=m_hat[..., 0], e=e, starts=starts)


def cbl_stats_fwd_plain(features, meta, li, temperature: float, tile: int,
                        width: int, window: int):
    """Plain PyTorch version of the forward → stats [B, M, 8] = (m̂, Σpos·e,
    Σe, pos count, valid count, 0, 0, 0)."""
    t = _slot_terms(features, meta, li, temperature, tile, width, window)
    e, posmv, mv = t["e"], t["posmv"], t["mv"]
    zero = torch.zeros_like(t["m_hat"])
    return torch.stack([
        t["m_hat"], (e * posmv).sum(-1), e.sum(-1), posmv.sum(-1), mv.sum(-1),
        zero, zero, zero,
    ], -1)


def cbl_stats_bwd_plain(features, meta, li, g_stats, temperature: float,
                        tile: int, width: int, window: int):
    """Plain PyTorch version of the backward → dfeatures [B, M, C] from the
    stats cotangent's lanes 1 (pos) and 2 (under); m̂ is held constant."""
    t = _slot_terms(features, meta, li, temperature, tile, width, window)
    g = g_stats.float()
    coef = (g[..., 1:2] * t["posmv"] + g[..., 2:3]) * t["e"] * -_inv_t(temperature)
    cd = torch.where(t["d2"] > 1e-5 * t["scale2"], coef / t["dist"], 0.0)
    q, s = t["q"], t["s"]
    dq = cd.sum(-1, keepdim=True) * q - (cd[..., None] * s).sum(2)
    ds = cd[..., None] * (s - q[:, :, None, :])
    m = q.shape[1]
    return dq + _tg.window_gather_bwd_plain(ds, li, t["starts"], tile, width, m)


def _cuda_args(features, meta, li, tile, width):
    if not (features.is_cuda and meta.device == features.device
            and li.device == features.device):
        raise ValueError(
            f"cbl_stats: tensors on {features.device}, {meta.device}, {li.device}"
        )
    if features.dtype != torch.float32 or meta.dtype != torch.float32:
        raise TypeError("cbl_stats takes float32 features and meta")
    _check(features, meta, li, tile, width)
    if features.shape[-1] != CHANNELS:
        raise ValueError(f"feature width {features.shape[-1]} != {CHANNELS}")
    return (features.contiguous(), meta.contiguous(),
            li.to(torch.int32).contiguous())


def cbl_stats_fwd(features, meta, li, temperature: float, tile: int,
                  width: int, window: int):
    """Stats forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global fwd_launches
    if features.device.type == "cpu":
        return cbl_stats_fwd_plain(features, meta, li, temperature, tile, width, window)
    f, mt, lii = _cuda_args(features, meta, li, tile, width)
    b, m, c = f.shape
    stats = torch.empty((b, m, 8), dtype=torch.float32, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_stats_fwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), stats.data_ptr(),
        b, m, lii.shape[-1], c, tile, width, window, _inv_t(temperature), stream,
    )
    fwd_launches += 1
    build.check(rc, "cbl_stats_fwd")
    return stats


def cbl_stats_bwd(features, meta, li, g_stats, temperature: float, tile: int,
                  width: int, window: int):
    """Stats backward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    global bwd_launches
    if features.device.type == "cpu":
        return cbl_stats_bwd_plain(
            features, meta, li, g_stats, temperature, tile, width, window
        )
    f, mt, lii = _cuda_args(features, meta, li, tile, width)
    if g_stats.shape != mt.shape or g_stats.device != f.device:
        raise ValueError(f"stats cotangent {tuple(g_stats.shape)} on {g_stats.device}")
    gs = g_stats.float().contiguous()
    b, m, c = f.shape
    dx = torch.zeros_like(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_stats_bwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), gs.data_ptr(), dx.data_ptr(),
        b, m, lii.shape[-1], c, tile, width, window, _inv_t(temperature), stream,
    )
    bwd_launches += 1
    build.check(rc, "cbl_stats_bwd")
    return dx


class _CblDenseStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, meta, li, temperature, tile, width, window):
        ctx.save_for_backward(features, meta, li)
        ctx.args = (temperature, tile, width, window)
        return cbl_stats_fwd(features, meta, li, temperature, tile, width, window)

    @staticmethod
    def backward(ctx, g_stats):
        features, meta, li = ctx.saved_tensors
        dx = cbl_stats_bwd(features, meta, li, g_stats, *ctx.args)
        return dx, None, None, None, None, None, None


def cbl_dense_stats(features, meta, li, temperature: float, tile: int,
                    width: int, window: int):
    """Per-row softnn stats [B, M, 8], differentiable in ``features``.
    features [B, M, C] f32 sorted rows, meta = row_meta(label_soft), li
    [B, M, K] window-relative (shadow width·tile)."""
    return _CblDenseStats.apply(features, meta, li, temperature, tile, width, window)


def row_meta(label_soft):
    """[B, M, 8] f32: lane 0 the argmax of the soft label (as a float),
    lane 1 its validity (any mass), the rest 0."""
    amax = label_soft.argmax(-1).float()
    valid = (label_soft.sum(-1) > 0).float()
    pad = torch.zeros(label_soft.shape[:2] + (6,), device=label_soft.device)
    return torch.cat([amax[..., None], valid[..., None], pad], -1)


def cbl_dense_loss(features, label_soft, li, temperature: float, tile: int,
                   width: int, window: int, weight: float = 1.0):
    """Flagship CBL stage loss (softnn, l2, cnt) from the stats: the masked
    mean of −log(Σpos / max(Σall, EPS) + EPS) over rows with a valid label,
    at least one valid positive and at least one valid negative."""
    stats = cbl_dense_stats(
        features.float(), row_meta(label_soft), li, temperature, tile, width, window
    )
    pos, under, pos_cnt, valid_cnt = stats.unbind(-1)[1:5]
    loss = -torch.log(pos / torch.clamp_min(under, EPS) + EPS)
    center_valid = label_soft.sum(-1) > 0
    point_mask = (pos_cnt > 0) & (pos_cnt < valid_cnt) & center_valid
    return masked_mean(loss, point_mask) * weight
