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
the kernel's order. The backward takes the forward's max-shift m̂ (stats lane
0), held constant, and runs as two passes: the per-row slot coefficients cd
and the row-local part dq (``cbl_bwd_cd_plain``), then the transposed sum of
cd·(s − q) onto the support rows in ascending slot order.

The kernels take rows of 32, 64, 128, 256 or 512 floats: the wrappers pad
any other width up to 512 with zero channels (``padded_channels``; +0 in
every sum, the bits of the distances stay) and cut the gradient back. The
plain versions take every width as it is.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.masking import EPS, INF, masked_global_mean
from ...kernels import build
from . import tile_gather as _tg
from .win_topk import window_start_tiles

# kernel launches made by the wrappers below (plain-version calls not counted)
fwd_launches = 0
bwd_launches = 0

CHANNELS = 32  # the flagship's feature width (base_fdim), the plans' default
# the row widths the dense and v2 CBL kernels are built for: other widths up
# to 512 are padded with zero channels to the next one (padded_channels)
WIDTHS = (32, 64, 128, 256, 512)
MAX_CHANNELS = WIDTHS[-1]  # the widest row they take
MAX_SCATTER_ROWS = 256  # rows a block of the backward's scatter (8-bit row)
SCATTER_FLOATS = 16384  # accumulator floats a scatter block (csrc/slot_scatter.cuh)
MIN_SCATTER_ROWS = 16
# blocks the scatter splits a level's rows into, at least where the tile
# allows: the fastest split of each flagship level on an H100 (rows a block
# swept from 16 to 256)
MIN_SCATTER_BLOCKS = 256
MAX_K = 256  # slots a row the backward's first pass holds in shared memory
FWD_LANES = 8  # lanes a query row in the forward
FWD_MAX_THREADS = 512
FWD_MAX_ROWS = 256  # query rows a forward block (at most a tile)
FWD_MIN_ROWS = 32
SM_COUNT = 132  # H100 SXM
SMEM_LIMIT = 232448  # dynamic shared memory a block can have on the H100


def _inv_t(temperature: float) -> float:
    return float(np.float32(1.0) / np.float32(temperature))


def self_window_starts(m: int, tile: int, width: int, window: int) -> np.ndarray:
    """Window start tiles of the self geometry over M rows."""
    g = m // tile
    return window_start_tiles(g, g, width, window)


def padded_channels(c: int, widest: int = MAX_CHANNELS) -> int:
    """The row width the CBL kernels read for C feature channels: the least
    of WIDTHS that holds C, up to ``widest``. The extra channels are zeros,
    which add +0 to every sum of the distances and leave their bits as they
    are."""
    if not 0 < c <= widest:
        raise ValueError(f"feature width {c}: the CBL kernels take 1 to {widest}")
    return next(w for w in WIDTHS if c <= w)


def scatter_max_rows(channels: int) -> int:
    """Rows a block of the backward's scatter holds at this row width."""
    return min(MAX_SCATTER_ROWS, SCATTER_FLOATS // channels)


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


def _slot_terms(features, meta, li, temperature, tile, width, window, m_hat=None):
    """Per-slot terms of the plain versions ([B, M, K] unless noted); the
    max-shift m̂ [B, M] is computed unless given."""
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
    if m_hat is None:
        m_hat = torch.where(valid, -dist, -INF).amax(-1)
    m_hat = m_hat[..., None]
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


def cbl_bwd_cd_plain(features, meta, li, stats, g_stats, temperature: float,
                     tile: int, width: int, window: int):
    """Plain version of the backward's first pass → (cd [B, M, K], dq
    [B, M, C], the slot terms): each slot's coefficient cd (0 for a
    non-member or shadow slot and below the cancellation floor) from the
    stats cotangent's lanes 1 (pos) and 2 (under) with the forward's m̂
    (stats lane 0) held constant, and the row-local part dq = Σₖ cd·q −
    Σₖ cd·s."""
    t = _slot_terms(features, meta, li, temperature, tile, width, window, stats[..., 0])
    g = g_stats.float()
    coef = (g[..., 1:2] * t["posmv"] + g[..., 2:3]) * t["e"] * -_inv_t(temperature)
    cd = torch.where(t["d2"] > 1e-5 * t["scale2"], coef / t["dist"], 0.0)
    q, s = t["q"], t["s"]
    dq = cd.sum(-1, keepdim=True) * q - (cd[..., None] * s).sum(2)
    return cd, dq, t


def cbl_stats_bwd_plain(features, meta, li, stats, g_stats, temperature: float,
                        tile: int, width: int, window: int):
    """Plain PyTorch version of the backward → dfeatures [B, M, C] =
    dq + the window-gather transpose of cd·(s − q) (``cbl_bwd_cd_plain``)."""
    cd, dq, t = cbl_bwd_cd_plain(features, meta, li, stats, g_stats, temperature,
                                 tile, width, window)
    q, s = t["q"], t["s"]
    ds = cd[..., None] * (s - q[:, :, None, :])
    m = q.shape[1]
    return dq + _tg.window_gather_bwd_plain(ds, li, t["starts"], tile, width, m)


def scatter_slot_ranges(m: int, k: int, tile: int, width: int, window: int) -> np.ndarray:
    """[M / tile, 2] slot ranges [lo, hi) of the backward's scatter: the
    flat (q, k) slots of the query tiles whose windows hold each support
    tile, as the kernel finds them (two binary searches over the self
    geometry's non-decreasing window starts)."""
    starts = self_window_starts(m, tile, width, window)
    s = np.arange(m // tile)
    lo = np.searchsorted(starts, s - width + 1, side="left")
    hi = np.searchsorted(starts, s + 1, side="left")
    return np.stack([lo, hi], 1) * (k * tile)


def bwd_plan(b: int, m: int, tile: int, c: int = CHANNELS):
    """Launch geometry of the backward at C feature channels → (pass-1
    blocks of 256 threads, 8 lanes a row; scatter rows a block; scatter
    grid (blocks, clouds)). The scatter's rows are a power-of-two divisor
    of the tile, at most ``scatter_max_rows`` of the kernel's row width
    (256 up to 64 channels, 16384 floats wider), halved (down to 16) while
    it would have fewer than MIN_SCATTER_BLOCKS blocks."""
    rows = min(tile & -tile, scatter_max_rows(padded_channels(c)))
    while rows > MIN_SCATTER_ROWS and (m // rows) * b < MIN_SCATTER_BLOCKS:
        rows //= 2
    return -(-b * m * 8 // 256), rows, ((m // tile) * (tile // rows), b)


def fwd_smem(width: int, tile: int, c: int = CHANNELS) -> int:
    """Dynamic shared bytes of a forward block: the window's rows (the
    kernel's row width for C channels), their (argmax, validity) and |s|²."""
    return width * tile * (4 * padded_channels(c) + 8 + 4)


def fwd_plan(b: int, m: int, k: int, tile: int, width: int, c: int = CHANNELS):
    """Launch geometry of the forward at C feature channels → (blocks a
    cloud, threads a block, dynamic shared bytes). A block serves M /
    blocks query rows of one tile
    (a power-of-two divisor of it, at most 256), 8 lanes a row, 64 rows at
    a time; the rows are halved (down to 32) while a level has fewer blocks
    than half the card's SMs (the split a sweep of 32–256 rows timed
    fastest at the flagship's levels on an H100). Every row's K slots are
    split among its 8 lanes. The window is staged in shared memory where it
    fits (``fwd_smem``); a wider one (at 32 channels, over 1,660 rows; at
    512, over 112) is read through L2, with 0 dynamic shared bytes, and
    gives the same bits. Both paths stay: forced through L2, the flagship's
    five launches take 1.72x the staged path's time on an H100
    (scripts/ab_torch_kernels.py)."""
    smem = fwd_smem(width, tile, c)
    if smem > SMEM_LIMIT:
        smem = 0
    rows = min(tile & -tile, FWD_MAX_ROWS)
    while rows > FWD_MIN_ROWS and (m // rows) * b < SM_COUNT // 2:
        rows //= 2
    threads = max(32, FWD_LANES * min(rows, FWD_MAX_THREADS // FWD_LANES))
    return m // rows, threads, smem


def fwd_lane_slots(k: int):
    """The forward's split of a row's K slots → (slots a lane a chunk,
    chunks): chunk c, lane l holds slots c·8·spl + l·spl + j for j < spl
    (those below K), spl = ⌈K / 8⌉ capped at 8 (the kernel's largest
    register run; longer rows go in chunks)."""
    spl = min(-(-k // FWD_LANES), 8)
    return spl, -(-k // (FWD_LANES * spl))


def _cuda_args(features, meta, li, tile, width):
    if not (features.is_cuda and meta.device == features.device
            and li.device == features.device):
        raise ValueError(
            f"cbl_stats: tensors on {features.device}, {meta.device}, {li.device}"
        )
    if features.dtype != torch.float32 or meta.dtype != torch.float32:
        raise TypeError("cbl_stats takes float32 features and meta")
    _check(features, meta, li, tile, width)
    c = features.shape[-1]
    channels = padded_channels(c)
    f = features if channels == c else F.pad(features, (0, channels - c))
    return f.contiguous(), meta.contiguous(), li.to(torch.int32).contiguous()


def cbl_stats_fwd(features, meta, li, temperature: float, tile: int,
                  width: int, window: int):
    """Stats forward: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global fwd_launches
    if features.device.type == "cpu":
        return cbl_stats_fwd_plain(features, meta, li, temperature, tile, width, window)
    f, mt, lii = _cuda_args(features, meta, li, tile, width)
    if window >= width:
        raise ValueError(f"window={window} >= width={width}: the query tile must lie in its window")
    b, m, c = f.shape
    k = lii.shape[-1]
    blocks, threads, smem = fwd_plan(b, m, k, tile, width, c)
    stats = torch.empty((b, m, 8), dtype=torch.float32, device=f.device)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_stats_fwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), stats.data_ptr(),
        b, m, k, c, tile, width, window, _inv_t(temperature), blocks, threads, smem, stream,
    )
    fwd_launches += 1
    build.check(rc, "cbl_stats_fwd")
    return stats


def cbl_stats_bwd_passes(features, meta, li, stats, g_stats, temperature: float,
                         tile: int, width: int, window: int):
    """The backward kernel on CUDA tensors → (dfeatures, cd): the pass-1
    coefficients come back from their scratch tensor; the gradient is cut
    back to the features' width."""
    global bwd_launches
    f, mt, lii = _cuda_args(features, meta, li, tile, width)
    for name, x in (("stats", stats), ("stats cotangent", g_stats)):
        if x.shape != mt.shape or x.device != f.device:
            raise ValueError(f"{name} {tuple(x.shape)} on {x.device}")
    b, m, c = f.shape
    k = lii.shape[-1]
    if m * k >= 1 << 23 or k > MAX_K:
        raise ValueError(f"M·K = {m * k} slots a cloud (limit 2^23), K = {k} (limit {MAX_K})")
    st = stats.float().contiguous()
    gs = g_stats.float().contiguous()
    _, rows, _ = bwd_plan(b, m, tile, c)
    cd = torch.empty((b, m, k), dtype=torch.float32, device=f.device)
    lands = torch.empty((b, m, k), dtype=torch.int32, device=f.device)
    dx = torch.empty_like(f)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    rc = build.library().cbl_stats_bwd(
        f.data_ptr(), mt.data_ptr(), lii.data_ptr(), st.data_ptr(), gs.data_ptr(),
        cd.data_ptr(), lands.data_ptr(), dx.data_ptr(), b, m, k, c, tile, width, window,
        _inv_t(temperature), rows, stream,
    )
    bwd_launches += 1
    build.check(rc, "cbl_stats_bwd")
    c_in = features.shape[-1]
    return (dx if c == c_in else dx[..., :c_in].contiguous()), cd


def cbl_stats_bwd(features, meta, li, stats, g_stats, temperature: float, tile: int,
                  width: int, window: int):
    """Stats backward: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. ``stats`` is the forward's output (its m̂ is used)."""
    if features.device.type == "cpu":
        return cbl_stats_bwd_plain(
            features, meta, li, stats, g_stats, temperature, tile, width, window
        )
    return cbl_stats_bwd_passes(
        features, meta, li, stats, g_stats, temperature, tile, width, window
    )[0]


class _CblDenseStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, meta, li, temperature, tile, width, window):
        stats = cbl_stats_fwd(features, meta, li, temperature, tile, width, window)
        ctx.save_for_backward(features, meta, li, stats)
        ctx.args = (temperature, tile, width, window)
        return stats

    @staticmethod
    def backward(ctx, g_stats):
        features, meta, li, stats = ctx.saved_tensors
        dx = cbl_stats_bwd(features, meta, li, stats, g_stats, *ctx.args)
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
    at least one valid positive and at least one valid negative (this
    rank's share of the global batch's mean, core/masking.py::
    masked_global_mean)."""
    stats = cbl_dense_stats(
        features.float(), row_meta(label_soft), li, temperature, tile, width, window
    )
    pos, under, pos_cnt, valid_cnt = stats.unbind(-1)[1:5]
    loss = -torch.log(pos / torch.clamp_min(under, EPS) + EPS)
    center_valid = label_soft.sum(-1) > 0
    point_mask = (pos_cnt > 0) & (pos_cnt < valid_cnt) & center_valid
    return masked_global_mean(loss, point_mask) * weight
