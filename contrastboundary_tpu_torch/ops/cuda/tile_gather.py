"""Tile-window row gather and its backward: kernel wrappers, plain PyTorch
versions and launch counters.

Replaces contrastboundary_tpu/ops/pallas/tile_gather_pl.py::
tile_window_gather_pl, forward (a per-(batch, tile) one-hot matmul in VMEM)
and backward (the transposed one-hot matmul, then an overlap-add of the
windows). The CUDA kernels are ``csrc/tile_gather.cu`` and
``csrc/window_gather_bwd.cu``; their designs and bounds are noted there.

Contract (both versions): x [B, Ns, C] support rows, float32 or bfloat16,
local_idx [B, M, K] int32 window-relative, starts int32 [M / tile] window
starts in tiles → out [B, M, K, C] in x's dtype with out[b, q, k] = x[b,
starts[q // tile]·tile + local_idx[b, q, k]] (the same bits) and a zero row
wherever local_idx is outside [0, W), W = width·tile (the shadow index W).
The backward takes g [B, M, K, C] to dx [B, Ns, C], adding each slot's row
onto its support row; shadow slots add nothing. Each dx row is the float32
sum of its slots' rows (bfloat16 ones widened exactly) taken in ascending
slot order (q, then k), starting from 0: the order of CPU ``index_add_``,
and of the kernel on every run (no atomics); dx is that sum rounded once to
g's dtype, as the reference's backward casts its float32 sum to x's
(tile_gather_pl.py::_bwd_call), which autograd makes g's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...kernels import build

# kernel launches made by the wrappers below (plain-version calls not counted)
launches = 0
bwd_launches = 0
# the same launches by the element type of x (forward) and of g (backward)
DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16"}
dtype_launches = dict.fromkeys(DTYPES.values(), 0)
bwd_dtype_launches = dict.fromkeys(DTYPES.values(), 0)

WARPS_PER_BLOCK = 8  # 256 threads
# bytes of output a warp moves: the sizes that timed fastest over the
# flagship step's calls on an H100 (rows a warp swept from 1 to 32)
VEC_WARP_BYTES = 2048
SCALAR_WARP_BYTES = 4096


class GatherPlan(NamedTuple):
    """Launch geometry of the forward gather kernel (``csrc/tile_gather.cu``)."""
    lpg: int  # lanes a row on the vector path; 0: the scalar-read path
    nt: int  # 16-byte pieces a lane (vector path)
    rw: int  # output rows a warp
    grid: tuple  # (blocks of 256 threads, channel chunks)


def gather_plan(rows: int, c: int, aligned: bool, elem_bytes: int = 4) -> GatherPlan:
    """The path and launch geometry for ``rows`` = B·M·K output rows of C
    elements of ``elem_bytes`` bytes (4: float32, 2: bfloat16). The vector
    path (rows of whole 16-byte pieces, x and out 16-byte aligned): the
    smallest power-of-two lane group (4 to 32) that covers the row's pieces,
    or 32 lanes with 2 or 4 pieces each, in channel chunks beyond 128
    pieces; a piece is 4 floats or 8 bfloat16s, moved as bits. Other widths
    take the scalar-read path, whose warp rows are a multiple of 4 (its runs
    then start aligned to 4 elements). Rows a warp: 32, halved while the warp
    would move more than VEC_WARP_BYTES (SCALAR_WARP_BYTES), down to one row
    a lane group (vector) or 4 (scalar)."""
    if (c * elem_bytes) % 16 == 0 and aligned:
        cv = c * elem_bytes // 16
        lpg = min(32, max(4, 1 << (cv - 1).bit_length()))
        nt = min(4, 1 << (-(-cv // lpg) - 1).bit_length())
        chunks = -(-cv // (lpg * nt))
        row_bytes = 16 * min(cv, lpg * nt)
        min_rw, target = 32 // lpg, VEC_WARP_BYTES
    else:
        lpg, nt, chunks = 0, 1, 1
        row_bytes = elem_bytes * c
        min_rw, target = 4, SCALAR_WARP_BYTES
    rw = 32
    while rw > min_rw and rw * row_bytes > target:
        rw //= 2
    warps = -(-rows // rw)
    return GatherPlan(lpg, nt, rw, (-(-warps // WARPS_PER_BLOCK), chunks))


def _check(b, ns, local_idx, starts, tile, width):
    bi, m, _ = local_idx.shape
    if bi != b or m % tile or ns % tile or starts.shape != (m // tile,):
        raise ValueError(
            f"bad shapes: {b} clouds of {ns} rows, idx {tuple(local_idx.shape)}, "
            f"starts {tuple(starts.shape)} for tile={tile}"
        )
    if width > ns // tile:
        raise ValueError(f"width={width} > {ns // tile} support tiles")


def window_gather_plain(x, local_idx, starts, tile: int, width: int):
    """Plain PyTorch version: one advanced-indexing gather, then the shadow
    rows zeroed."""
    b, ns, c = x.shape
    _check(b, ns, local_idx, starts, tile, width)
    rows, valid = _rows(local_idx, starts, tile, width, ns)
    out = x.reshape(b * ns, c)[rows]
    return out.masked_fill(~valid[..., None], 0.0)


def window_gather(x, local_idx, starts, tile: int, width: int):
    """Window gather: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors. The kernel (``csrc/tile_gather.cu``) gives each warp
    consecutive output rows, reads their indices once and copies the rows
    on the path and geometry ``gather_plan`` chooses; a bfloat16 row is
    copied as bits, as the reference's bf16 branch selects it exactly."""
    global launches
    if x.device.type == "cpu":
        return window_gather_plain(x, local_idx, starts, tile, width)
    if not (x.is_cuda and local_idx.device == x.device and starts.device == x.device):
        raise ValueError(
            f"window_gather: tensors on {x.device}, {local_idx.device}, {starts.device}"
        )
    if x.dtype not in DTYPES:
        raise TypeError(f"window_gather takes float32 or bfloat16, got {x.dtype}")
    b, ns, c = x.shape
    _check(b, ns, local_idx, starts, tile, width)
    m, k = local_idx.shape[1:]
    if b * m * k >= 2**31 - 64 or b * ns >= 2**31:
        raise ValueError(f"window_gather: {b * m * k} rows or {b * ns} support rows ≥ 2^31")
    x = x.contiguous()
    li = local_idx.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    out = torch.empty((b, m, k, c), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    eb = x.element_size()
    plan = gather_plan(b * m * k, c, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0, eb)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().cbl_window_gather(
        x.data_ptr(), li.data_ptr(), st.data_ptr(), out.data_ptr(),
        b, ns, m, k, c, tile, width, plan.lpg, plan.nt, plan.rw, eb, stream,
    )
    launches += 1
    dtype_launches[DTYPES[x.dtype]] += 1
    build.check(rc, "cbl_window_gather")
    return out


def _rows(local_idx, starts, tile, width, n_support):
    """Flat support rows b·Ns + row of every slot, and the valid-slot mask."""
    b = local_idx.shape[0]
    li = local_idx.long()
    valid = (li >= 0) & (li < width * tile)
    row0 = torch.repeat_interleave(starts.long() * tile, tile)  # [M]
    rows = torch.where(valid, row0[None, :, None] + li, 0)
    rows = rows + torch.arange(b, device=li.device)[:, None, None] * n_support
    return rows, valid


def window_gather_bwd_plain(g, local_idx, starts, tile: int, width: int,
                            n_support: int):
    """Plain PyTorch version: one float32 index_add_ of the valid slots'
    rows (a shadow slot adds +0 onto row 0), cast to g's dtype. On the CPU index_add_ adds in index order, so each row is the
    sequential sum in ascending slot order that the kernel computes; on the
    card it adds with atomics, in no fixed order."""
    b, m, k, c = g.shape
    _check(b, n_support, local_idx, starts, tile, width)
    rows, valid = _rows(local_idx, starts, tile, width, n_support)
    src = g.float().masked_fill(~valid[..., None], 0.0).reshape(-1, c)
    dx = torch.zeros((b * n_support, c), dtype=torch.float32, device=g.device)
    dx = dx.index_add_(0, rows.reshape(-1), src).reshape(b, n_support, c)
    return dx.to(g.dtype)


def window_gather_bwd(g, local_idx, starts, tile: int, width: int,
                      n_support: int):
    """Window-gather backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors. The kernel (``csrc/window_gather_bwd.cu``) gives
    each support tile's rows to blocks that find the query tiles whose
    windows hold them by a binary search over ``starts`` (non-decreasing in
    every window geometry), sort those slots by row in slot order and sum
    each row's gradient rows in that order in shared memory: no atomics,
    the same bits on every run, every dx element written once, rounded
    once to g's dtype (float32 or bfloat16). Bound: bytes (g and li read once, dx
    written once). It takes M·K < 2^23."""
    global bwd_launches
    if g.device.type == "cpu":
        return window_gather_bwd_plain(g, local_idx, starts, tile, width, n_support)
    if not (g.is_cuda and local_idx.device == g.device and starts.device == g.device):
        raise ValueError(
            f"window_gather_bwd: tensors on {g.device}, {local_idx.device}, {starts.device}"
        )
    if g.dtype not in DTYPES:
        raise TypeError(f"window_gather_bwd takes float32 or bfloat16, got {g.dtype}")
    b, m, k, c = g.shape
    if local_idx.shape != (b, m, k):
        raise ValueError(f"g {tuple(g.shape)} vs idx {tuple(local_idx.shape)}")
    _check(b, n_support, local_idx, starts, tile, width)
    if m * k >= 1 << 23:
        raise ValueError(f"M·K = {m * k} slots a cloud ≥ 2^23, the kernel's limit")
    g = g.contiguous()
    li = local_idx.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    dx = torch.empty((b, n_support, c), dtype=g.dtype, device=g.device)
    if dx.numel() == 0:
        return dx
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = build.library().cbl_window_gather_bwd(
        g.data_ptr(), li.data_ptr(), st.data_ptr(), dx.data_ptr(),
        b, n_support, m, k, c, tile, width, g.element_size(), stream,
    )
    bwd_launches += 1
    bwd_dtype_launches[DTYPES[g.dtype]] += 1
    build.check(rc, "cbl_window_gather_bwd")
    return dx
