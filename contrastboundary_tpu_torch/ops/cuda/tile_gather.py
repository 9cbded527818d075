"""Tile-window row gather: kernel wrapper, plain PyTorch version and launch
counter.

Replaces the forward of contrastboundary_tpu/ops/pallas/tile_gather_pl.py::
tile_window_gather_pl (a per-(batch, tile) one-hot matmul in VMEM). The CUDA
kernel is ``csrc/tile_gather.cu``; its design and bound are noted there.

Contract (both versions): x [B, Ns, C] f32 support rows, local_idx
[B, M, K] int32 window-relative, starts int32 [M / tile] window starts in
tiles → out [B, M, K, C] with out[b, q, k] = x[b, starts[q // tile]·tile +
local_idx[b, q, k]] and a zero row wherever local_idx is outside [0, W),
W = width·tile (the shadow index W).
"""
from __future__ import annotations

import torch

from ...kernels import build

# kernel launches made by the wrapper below (plain-version calls not counted)
launches = 0


def _check(x, local_idx, starts, tile, width):
    b, ns, _ = x.shape
    bi, m, _ = local_idx.shape
    if bi != b or m % tile or ns % tile or starts.shape != (m // tile,):
        raise ValueError(
            f"bad shapes x {tuple(x.shape)}, idx {tuple(local_idx.shape)}, "
            f"starts {tuple(starts.shape)} for tile={tile}"
        )
    if width > ns // tile:
        raise ValueError(f"width={width} > {ns // tile} support tiles")


def window_gather_plain(x, local_idx, starts, tile: int, width: int):
    """Plain PyTorch version: one advanced-indexing gather, then the shadow
    rows zeroed."""
    _check(x, local_idx, starts, tile, width)
    b, ns, _ = x.shape
    w_sz = width * tile
    li = local_idx.long()
    valid = (li >= 0) & (li < w_sz)
    row0 = torch.repeat_interleave(starts.long() * tile, tile)  # [M]
    rows = torch.where(valid, row0[None, :, None] + li, 0)
    out = x[torch.arange(b, device=x.device)[:, None, None], rows]
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
    _check(x, local_idx, starts, tile, width)
    b, ns, c = x.shape
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

