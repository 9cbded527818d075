"""Window top-k: kernel wrapper, plain PyTorch version and launch counter.

Replaces contrastboundary_tpu/ops/pallas/win_topk.py::window_topk (the TPU
kernel computes the [T, W] distance tile once in VMEM and runs k exact
(max, first-index argmax, mask) passes on it). The CUDA kernel is
``csrc/win_topk.cu``; its design and bound are noted there.

Contract (both versions):
  query [B, M, 3] f32 and support [B, Ns, 3] f32, both Morton-sorted; query
  tile g of T = ``tile`` rows scores the W = width·tile support rows starting
  at tile clip((g·gs)//gq − window, 0, gs − width), with gq = M/T and
  gs = Ns/T (the self geometry is gs == gq: ``_self_start`` and
  ``_cross_start`` of the TPU kernel are one formula).
  Returns (idx [B, M, k] int32 window-relative, neg_d2 [B, M, k] f32)
  descending with first-index ties. Unlike the TPU kernel, a slot left
  without a candidate (k > W, or only the excluded self left) is returned as
  (W, −inf) directly — the TPU callers map every −inf slot to that shadow.
  mode: "plain" | "exclude_self" (own row scored −inf) | "ensure_self" (slot
  0 overwritten with (own row, 0)); the self modes need support is query.
"""
from __future__ import annotations

import numpy as np
import torch

from ...kernels import build

# kernel launches made by the wrapper below (plain-version calls not counted)
launches = 0

MODES = {"plain": 0, "exclude_self": 1, "ensure_self": 2}


def window_start_tiles(gq: int, gs: int, width: int, window: int) -> np.ndarray:
    """Window start (in tiles) of each of the gq query tiles."""
    centers = (np.arange(gq) * gs) // gq
    return np.clip(centers - window, 0, gs - width)


def _geometry(query, support, tile, width, mode):
    b, m, d = query.shape
    ns = support.shape[1]
    if d != 3 or support.shape[0] != b or support.shape[2] != 3:
        raise ValueError(f"bad shapes {tuple(query.shape)}, {tuple(support.shape)}")
    if m % tile or ns % tile or width > ns // tile:
        raise ValueError(f"M={m}, Ns={ns} vs tile={tile}, width={width}")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode != "plain" and ns != m:
        raise ValueError(f"mode {mode!r} needs the self geometry")
    return b, m, ns


def window_neg_d2(query, support, *, tile: int, width: int, window: int,
                  mode: str = "plain"):
    """The kernel's window scores: −d² [B, G, T, W] in the kernel's
    elementwise order (−inf at the excluded self), and the window-relative
    self position [G, T]."""
    b, m, ns = _geometry(query, support, tile, width, mode)
    gq, gs, w_sz = m // tile, ns // tile, width * tile
    dev = query.device
    starts = torch.as_tensor(window_start_tiles(gq, gs, width, window), device=dev)
    cols = starts[:, None] + torch.arange(width, device=dev)[None, :]
    q = query.float().reshape(b, gq, tile, 1, 3)
    win = support.float().reshape(b, gs, tile, 3)[:, cols].reshape(b, gq, 1, w_sz, 3)
    qx, qy, qz = q.unbind(-1)
    sx, sy, sz = win.unbind(-1)
    qn = qx * qx + qy * qy + qz * qz
    sn = sx * sx + sy * sy + sz * sz
    qs = qx * sx + qy * sy + qz * sz  # [B, G, T, W]
    neg = -torch.clamp_min((qn + sn) - 2.0 * qs, 0.0)
    self_pos = (
        torch.arange(gq, device=dev)[:, None] * tile
        + torch.arange(tile, device=dev)[None, :]
        - (starts * tile)[:, None]
    ).to(torch.int32)  # [G, T]
    if mode == "exclude_self":
        iota = torch.arange(w_sz, device=dev, dtype=torch.int32)
        neg = neg.masked_fill(iota == self_pos[..., None], float("-inf"))
    return neg, self_pos


def window_topk_plain(query, support, k: int, *, tile: int, width: int,
                      window: int, mode: str = "plain"):
    """Plain PyTorch version: the same elementwise arithmetic in the same
    order as the kernel, then k passes of (max, first index of the max,
    mask)."""
    b, m, _ = query.shape
    w_sz = width * tile
    neg, self_pos = window_neg_d2(
        query, support, tile=tile, width=width, window=window, mode=mode
    )
    iota = torch.arange(w_sz, device=query.device, dtype=torch.int32)
    vals, idxs = [], []
    for _ in range(k):
        v = neg.amax(-1, keepdim=True)
        i = torch.where(neg == v, iota, w_sz).amin(-1, keepdim=True)
        i = torch.where(torch.isinf(v), w_sz, i)
        vals.append(v)
        idxs.append(i)
        neg = neg.masked_fill(iota == i, float("-inf"))
    val = torch.cat(vals, -1)
    idx = torch.cat(idxs, -1).to(torch.int32)
    if mode == "ensure_self":
        idx[..., 0] = self_pos
        val[..., 0] = 0.0
    return idx.reshape(b, m, k), val.reshape(b, m, k)


def window_topk(query, support, k: int, *, tile: int, width: int, window: int,
                mode: str = "plain"):
    """Window top-k: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global launches
    if query.device.type == "cpu" and support.device.type == "cpu":
        return window_topk_plain(
            query, support, k, tile=tile, width=width, window=window, mode=mode
        )
    if not (query.is_cuda and support.is_cuda and query.device == support.device):
        raise ValueError(f"window_topk: tensors on {query.device}, {support.device}")
    if query.dtype != torch.float32 or support.dtype != torch.float32:
        raise TypeError("window_topk takes float32 points")
    b, m, ns = _geometry(query, support, tile, width, mode)
    if tile > 1024:
        raise ValueError(f"tile={tile} > 1024 threads")
    if 16 * width * tile > 227 * 1024:
        raise ValueError(f"window of {width * tile} rows exceeds shared memory")
    query, support = query.contiguous(), support.contiguous()
    idx = torch.empty((b, m, k), dtype=torch.int32, device=query.device)
    val = torch.empty((b, m, k), dtype=torch.float32, device=query.device)
    lib = build.library()
    stream = torch.cuda.current_stream(query.device).cuda_stream
    rc = lib.cbl_win_topk(
        query.data_ptr(), support.data_ptr(), idx.data_ptr(), val.data_ptr(),
        b, m, ns, k, tile, width, window, ns // tile, MODES[mode], stream,
    )
    launches += 1
    build.check(rc, "cbl_win_topk")
    return idx, val

