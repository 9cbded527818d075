"""Tile-window KNN on Morton-sorted clouds (counterpart of
contrastboundary_tpu/ops/knn.py::tile_self_knn and ::tile_cross_knn), the
windowed KNN of the natural layout (::windowed_knn: each cloud sorted on its
own Morton curve, then a tile window search) and the dense exact search
(::knn, ::pairwise_sqdist).

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

from typing import Optional

import numpy as np
import torch

from ..core.gather import batch_gather
from .cuda import win_topk
from .sampling import serialized_order

EXACT_TOPK_WIDTH = 2048
# elements of one [B, chunk, N] distance block of the dense search
KNN_BLOCK_ELEMS = 1 << 27
# searches whose window was wider than EXACT_TOPK_WIDTH (plain PyTorch)
wide_calls = 0


def window_topk_wide(query, support, k: int, *, tile: int, width: int,
                     window: int, mode: str = "plain", last_ties: bool = False):
    """Exact window top-k in plain PyTorch for any width, on any device: the
    kernel's distances, then a stable descending sort (ties to the lower
    window index, as ``lax.top_k``; to the higher with ``last_ties``, k = 1).
    Same contract as ops/cuda/win_topk.py::window_topk."""
    win_topk.check_last_ties(k, last_ties)
    b, m, _ = query.shape
    w_sz = width * tile
    neg, self_pos = win_topk.window_neg_d2(
        query, support, tile=tile, width=width, window=window, mode=mode
    )
    kk = min(k, w_sz)
    if last_ties:
        val, idx = torch.sort(neg.flip(-1), dim=-1, descending=True, stable=True)
        idx = w_sz - 1 - idx
    else:
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


def _window_topk(query, support, k, *, tile, width, window, mode="plain",
                 last_ties=False):
    global wide_calls
    kw = dict(tile=tile, width=width, window=window, mode=mode, last_ties=last_ties)
    if width * tile > EXACT_TOPK_WIDTH:
        wide_calls += 1
        return window_topk_wide(query, support, k, **kw)
    return win_topk.window_topk(query, support, k, **kw)


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


@torch.no_grad()
def windowed_knn(query: torch.Tensor, support: torch.Tensor, k: int, *,
                 tile: int = 256, window: int = 4, exclude_self: bool = False,
                 radius: Optional[float] = None, recall: Optional[float] = 0.95,
                 ensure_self: bool = False):
    """KNN inside a Morton tile window (JAX ``windowed_knn``), with the
    contract of ``knn``: (idx [B, M, k] int32 original support rows, shadow
    N; d2 [B, M, k] f32 ascending).

    Query and support are each sorted by their own ``serialized_order``
    (one sort when query is support); sorted query tile g of T = ``tile``
    rows scores the W = width·T sorted support rows from tile
    clip(g·gs // gq − window, 0, gs − width), width = min(2·window + 1, gs)
    (the self width, also across levels: ops/cuda/win_topk.py's start rule).
    The window-relative slots go through the support's order to original
    rows and are scattered back to the query's original rows; then
    ``ensure_self`` (slot 0 the query itself, d2 0), ``radius`` (d2 >
    float32(radius)² → N) and the shadow N at every +inf d2, in the
    reference's order. ``exclude_self`` and ``ensure_self`` are the
    kernel's self modes: they need query is support, whose two sorts are
    then one. The search is exact; ``recall`` only selects the reference's
    CPU tie rule: with a recall target its top-1 (k < W) breaks ties to
    the last window row (``lax.approx_max_k`` on the CPU), every other
    search to the first. k > W raises, as the reference's ``lax.top_k``
    does. Where M or N is not a multiple of ``tile`` it is ``knn``, as in
    the reference (a dispatch by shape)."""
    b, m, _ = query.shape
    n = support.shape[1]
    if m % tile or n % tile:
        return knn(query, support, k, exclude_self=exclude_self, radius=radius,
                   recall=recall, ensure_self=ensure_self)
    if exclude_self and ensure_self:
        raise ValueError("exclude_self and ensure_self are exclusive")
    gq, gs = m // tile, n // tile
    width = self_width(gs, window)
    w_sz = width * tile
    if k > w_sz:
        raise ValueError(f"k={k} > the {w_sz} rows of a window (tile {tile}, width {width})")
    mode = "exclude_self" if exclude_self else ("ensure_self" if ensure_self else "plain")
    if mode != "plain" and (query is not support):
        raise ValueError(f"mode {mode!r} needs query is support")
    q_ord = serialized_order(query)
    s_ord = q_ord if query is support else serialized_order(support)
    q_sorted = batch_gather(query.float(), q_ord)
    s_sorted = q_sorted if query is support else batch_gather(support.float(), s_ord)
    local, neg = _window_topk(
        q_sorted, s_sorted, k, tile=tile, width=width, window=window, mode=mode,
        last_ties=recall is not None and k == 1 < w_sz,
    )
    dev = query.device
    starts = win_topk.window_start_tiles(gq, gs, width, window) * tile
    row0 = torch.as_tensor(starts, device=dev).repeat_interleave(tile)
    valid = local < w_sz
    rows = torch.where(valid, row0[None, :, None] + local, 0).reshape(b, m * k)
    orig = torch.gather(s_ord, 1, rows.long()).reshape(b, m, k)
    scatter = q_ord.long()[..., None].expand(b, m, k)
    idx = torch.empty((b, m, k), dtype=torch.int32, device=dev).scatter_(
        1, scatter, torch.where(valid, orig, n).to(torch.int32))
    d2 = torch.empty((b, m, k), dtype=torch.float32, device=dev).scatter_(1, scatter, -neg)
    if ensure_self:
        idx[..., 0] = torch.arange(m, dtype=torch.int32, device=dev)
        d2[..., 0] = 0.0
    if radius is not None:
        r2 = np.float32(radius) * np.float32(radius)
        idx = torch.where(d2 > float(r2), n, idx)
    return torch.where(torch.isinf(d2), n, idx).to(torch.int32), d2


def pairwise_sqdist(query: torch.Tensor, support: torch.Tensor) -> torch.Tensor:
    """Squared distances ‖q‖² + ‖s‖² − 2·q·s, clamped at 0, in the
    reference's expression: query [..., M, 3], support [..., N, 3] →
    [..., M, N] f32. Each product and sum is its own float32 op (no matmul,
    so no TF32 and no reduced-precision pass): on clouds whose squared
    distances are exact in float32 the two packages give the same bits.
    The factor 2 is applied to the query's coordinates (exact: a power of
    two commutes with each rounding), which saves one pass over [M, N]."""
    q = query.float()[..., :, None, :]
    s = support.float()[..., None, :, :]
    qx, qy, qz = q.unbind(-1)
    sx, sy, sz = s.unbind(-1)
    qn = qx * qx + qy * qy + qz * qz
    sn = sx * sx + sy * sy + sz * sz
    qs2 = (2.0 * qx) * sx + (2.0 * qy) * sy + (2.0 * qz) * sz  # = 2·(q·s), bit for bit
    return torch.clamp_min((qn + sn) - qs2, 0.0)


def _smallest_k(d2: torch.Tensor, k: int, last_ties: bool = False):
    """The k smallest of d2 [..., N] ascending, ties to the lower column
    (as ``lax.top_k`` on −d2), or to the higher one with ``last_ties``: one
    top-k over the int64 key (float32 bits of d2, column or N − 1 − column),
    which is unique and orders as d2 first since d2 ≥ 0. → (idx int64, d2)."""
    n = d2.shape[-1]
    bits = d2.contiguous().view(torch.int32).to(torch.int64)
    col = torch.arange(n, device=d2.device)
    key = (bits << 32) | (n - 1 - col if last_ties else col)
    top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    d2k = (top >> 32).to(torch.int32).view(torch.float32)
    low = top & 0xFFFFFFFF
    return (n - 1 - low if last_ties else low), d2k


@torch.no_grad()
def knn(query: torch.Tensor, support: torch.Tensor, k: int, *,
        support_mask: Optional[torch.Tensor] = None, exclude_self: bool = False,
        radius: Optional[float] = None, chunk: int = 2048,
        recall: Optional[float] = None, ensure_self: bool = False):
    """Exact batched KNN over every support row.

    query [B, M, 3], support [B, N, 3] → (idx [B, M, k] int32 in [0, N],
    d2 [B, M, k] f32 ascending). A masked support row (``support_mask``
    [B, N] False) or the query's own row (``exclude_self``, query is
    support) scores +inf; every +inf slot, and the slots beyond N (or N − 1
    without self) neighbours, are the shadow index N (d2 +inf).
    ``ensure_self`` then writes (own row, 0) into slot 0; ``radius`` last
    turns every slot with d2 > float32(radius)² into the shadow.

    The search is exact whatever ``recall`` says. The reference's
    ``recall`` selects ``lax.approx_max_k``, approximate on the TPU; on the
    CPU it returns the exact top-k with first-column ties, except at k = 1
    (k < N), where its ties go to the last column. ``recall`` keeps that
    one rule, so that the nearest-point searches pick the tied point the
    reference picks on the CPU. ``chunk`` bounds the
    queries of one distance block (fewer when B·chunk·N exceeds
    KNN_BLOCK_ELEMS); the result does not depend on it."""
    b, m, _ = query.shape
    n = support.shape[1]
    dev = query.device
    k_eff = min(k, n - 1 if exclude_self else n)
    if k_eff <= 0:
        idx = torch.full((b, m, k), n, dtype=torch.int32, device=dev)
        d2 = torch.full((b, m, k), float("inf"), device=dev)
    else:
        step = max(1, min(chunk, m, KNN_BLOCK_ELEMS // max(b * n, 1)))
        idx_parts, d2_parts = [], []
        for c0 in range(0, m, step):
            d2c = pairwise_sqdist(query[:, c0:c0 + step], support)
            if support_mask is not None:
                d2c = d2c.masked_fill(~support_mask[:, None, :], float("inf"))
            if exclude_self:
                rows = torch.arange(c0, c0 + d2c.shape[1], device=dev)
                own = rows[:, None] == torch.arange(n, device=dev)[None, :]
                d2c = d2c.masked_fill(own[None], float("inf"))
            i, d = _smallest_k(d2c, k_eff, recall is not None and k_eff == 1 < n)
            idx_parts.append(i)
            d2_parts.append(d)
        idx, d2 = torch.cat(idx_parts, 1), torch.cat(d2_parts, 1)
        if k_eff < k:
            pad = (0, k - k_eff)
            idx = torch.nn.functional.pad(idx, pad, value=n)
            d2 = torch.nn.functional.pad(d2, pad, value=float("inf"))
        idx = torch.where(torch.isinf(d2), n, idx).to(torch.int32)
    if ensure_self:
        idx[..., 0] = torch.arange(m, dtype=torch.int32, device=dev)
        d2[..., 0] = 0.0
    if radius is not None:
        r2 = np.float32(radius) * np.float32(radius)
        idx = torch.where(d2 > float(r2), n, idx).to(torch.int32)
    return idx, d2
