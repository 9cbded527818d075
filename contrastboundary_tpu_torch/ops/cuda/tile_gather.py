"""Tile-window row gather and its backward: kernel wrappers, plain PyTorch
versions and launch counters.

Replaces contrastboundary_tpu/ops/pallas/tile_gather_pl.py::
tile_window_gather_pl, forward (a per-(batch, tile) one-hot matmul in VMEM)
and backward (the transposed one-hot matmul, then an overlap-add of the
windows). The CUDA kernels are ``csrc/tile_gather.cu`` and
``csrc/window_gather_bwd.cu``; their designs and bounds are noted there.

Contract (both versions): x [B, Ns, C] f32 support rows, local_idx
[B, M, K] int32 window-relative, starts int32 [M / tile] window starts in
tiles → out [B, M, K, C] with out[b, q, k] = x[b, starts[q // tile]·tile +
local_idx[b, q, k]] and a zero row wherever local_idx is outside [0, W),
W = width·tile (the shadow index W). The backward takes g [B, M, K, C] to
dx [B, Ns, C], adding each slot's row onto its support row; shadow slots add
nothing.
"""
from __future__ import annotations

import torch

from ...kernels import build

# kernel launches made by the wrappers below (plain-version calls not counted)
launches = 0
bwd_launches = 0


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
    for CPU tensors."""
    global launches
    if x.device.type == "cpu":
        return window_gather_plain(x, local_idx, starts, tile, width)
    if not (x.is_cuda and local_idx.device == x.device and starts.device == x.device):
        raise ValueError(
            f"window_gather: tensors on {x.device}, {local_idx.device}, {starts.device}"
        )
    if x.dtype != torch.float32:
        raise TypeError(f"window_gather takes float32, got {x.dtype}")
    b, ns, c = x.shape
    _check(b, ns, local_idx, starts, tile, width)
    m, k = local_idx.shape[1:]
    x = x.contiguous()
    li = local_idx.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    out = torch.empty((b, m, k, c), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().cbl_window_gather(
        x.data_ptr(), li.data_ptr(), st.data_ptr(), out.data_ptr(),
        b, ns, m, k, c, tile, width, stream,
    )
    launches += 1
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
    """Plain PyTorch version: one index_add_ of the valid slots' rows."""
    b, m, k, c = g.shape
    _check(b, n_support, local_idx, starts, tile, width)
    rows, valid = _rows(local_idx, starts, tile, width, n_support)
    src = g.float().masked_fill(~valid[..., None], 0.0).reshape(-1, c)
    dx = torch.zeros((b * n_support, c), dtype=torch.float32, device=g.device)
    return dx.index_add_(0, rows.reshape(-1), src).reshape(b, n_support, c)


def window_gather_bwd(g, local_idx, starts, tile: int, width: int,
                      n_support: int):
    """Window-gather backward: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    global bwd_launches
    if g.device.type == "cpu":
        return window_gather_bwd_plain(g, local_idx, starts, tile, width, n_support)
    if not (g.is_cuda and local_idx.device == g.device and starts.device == g.device):
        raise ValueError(
            f"window_gather_bwd: tensors on {g.device}, {local_idx.device}, {starts.device}"
        )
    if g.dtype != torch.float32:
        raise TypeError(f"window_gather_bwd takes float32, got {g.dtype}")
    b, m, k, c = g.shape
    if local_idx.shape != (b, m, k):
        raise ValueError(f"g {tuple(g.shape)} vs idx {tuple(local_idx.shape)}")
    _check(b, n_support, local_idx, starts, tile, width)
    g = g.contiguous()
    li = local_idx.to(torch.int32).contiguous()
    st = starts.to(torch.int32).contiguous()
    dx = torch.zeros((b, n_support, c), dtype=torch.float32, device=g.device)
    if g.numel() == 0:
        return dx
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = build.library().cbl_window_gather_bwd(
        g.data_ptr(), li.data_ptr(), st.data_ptr(), dx.data_ptr(),
        b, n_support, m, k, c, tile, width, stream,
    )
    bwd_launches += 1
    build.check(rc, "cbl_window_gather_bwd")
    return dx
