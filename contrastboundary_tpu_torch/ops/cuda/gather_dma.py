"""Row gather: kernel wrapper, plain PyTorch version and launch counter.

Replaces contrastboundary_tpu/ops/pallas/gather_dma.py::gather_rows_dma
(one async DMA a row). The CUDA kernel is ``csrc/gather_rows.cu``; its
design and bound are noted there. Contract (both versions): x [N, C] with
C % 128 == 0, idx [M] integer with M % tile == 0 → [M, C] in x's dtype,
out[i] = x[idx[i]]; a row whose index is outside [0, N) is zeros. No path
of the system calls it, as in the reference, and it has no backward.
"""
from __future__ import annotations

import torch

from ...kernels import build

# kernel launches made by the wrapper below (plain-version calls not counted)
launches = 0

TILE = 1024  # the reference's rows a grid step


def _check(x, idx, tile: int):
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"x {tuple(x.shape)} must be [N, C] and idx {tuple(idx.shape)} [M]")
    c, (m,) = x.shape[1], idx.shape
    if c % 128:
        raise ValueError(f"C={c} must be a multiple of 128")
    if m % tile:
        raise ValueError(f"M={m} must be a multiple of tile={tile}")


def gather_rows_plain(x, idx, tile: int = TILE):
    """Plain PyTorch version: one index_select, rows outside [0, N) zeroed."""
    _check(x, idx, tile)
    n = x.shape[0]
    idx = idx.long()
    inside = (idx >= 0) & (idx < n)
    out = x.index_select(0, idx.clamp(0, max(n - 1, 0)))
    return out.masked_fill(~inside[:, None], 0)


def gather_rows(x, idx, tile: int = TILE):
    """Row gather: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global launches
    if x.device.type == "cpu":
        return gather_rows_plain(x, idx, tile)
    _check(x, idx, tile)
    if not (x.is_cuda and idx.device == x.device):
        raise ValueError(f"gather_rows: tensors on {x.device}, {idx.device}")
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel copies 16-byte words
        x = x.clone()
    ii = idx.to(torch.int32).contiguous()
    out = torch.empty((ii.shape[0], x.shape[1]), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = build.library().cbl_gather_rows(
        x.data_ptr(), ii.data_ptr(), out.data_ptr(), x.shape[0], ii.shape[0],
        x.shape[1] * x.element_size(), stream,
    )
    launches += 1
    build.check(rc, "cbl_gather_rows")
    return out
