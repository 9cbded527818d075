"""Farthest point sampling chains: kernel wrapper, plain PyTorch version
and launch counter.

Replaces no Pallas kernel: the reference computes the chain of
contrastboundary_tpu/ops/sampling.py::_fps_single as a lax.fori_loop on the
device, which plain PyTorch would run as one Python iteration a pick. The
CUDA kernel is ``csrc/fps.cu`` (a block a bucket, the step's argmax a
block reduction); its design and bound are noted there.

Contract (both versions): grouped [P, per, 3] float32, P point sets of
``per`` rows → [P, m_per] int32 rows within each set: row 0 first, then
m_per − 1 greedy picks, each the argmax (ties to the lowest row) of
mind2 = min over the picks so far of d2, with d2 = (dx·dx + dy·dy) + dz·dz,
every product and sum rounded on its own. Once every mind2 is 0 (more picks
than distinct points) the chain keeps picking row 0, as the reference's.
"""
from __future__ import annotations

import torch

from ...kernels import build

# kernel launches made by the wrapper below (plain-version calls not counted)
launches = 0

STAGE_MAX_ROWS = 13312  # csrc/fps.cu kStageMaxRows: larger sets keep mind2 in global memory


def _check(grouped, m_per: int):
    if grouped.dim() != 3 or grouped.shape[2] != 3 or grouped.shape[1] == 0:
        raise ValueError(f"grouped {tuple(grouped.shape)} must be [P, per, 3] with per > 0")
    if grouped.dtype != torch.float32:
        raise ValueError(f"grouped must be float32, not {grouped.dtype}")
    if m_per < 0:
        raise ValueError(f"m_per={m_per} must be >= 0")


def fps_chains_plain(grouped, m_per: int):
    """Plain PyTorch version: the chain of every set at once, one step a
    loop iteration."""
    _check(grouped, m_per)
    p, per, _ = grouped.shape
    x, y, z = grouped.unbind(-1)
    mind2 = torch.full((p, per), float("inf"), device=grouped.device)
    out = torch.zeros((p, m_per), dtype=torch.int64, device=grouped.device)
    last = torch.zeros((p, 1), dtype=torch.int64, device=grouped.device)
    for s in range(1, m_per):
        dx = x - x.gather(1, last)
        dy = y - y.gather(1, last)
        dz = z - z.gather(1, last)
        d2 = (dx * dx + dy * dy) + dz * dz
        mind2 = torch.minimum(mind2, d2)
        last = mind2.argmax(1, keepdim=True)
        out[:, s] = last[:, 0]
    return out.to(torch.int32)


def fps_chains(grouped, m_per: int):
    """FPS chains: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    global launches
    if grouped.device.type == "cpu":
        return fps_chains_plain(grouped, m_per)
    _check(grouped, m_per)
    if not grouped.is_cuda:
        raise ValueError(f"fps_chains: tensor on {grouped.device}")
    p, per, _ = grouped.shape
    planes = grouped.transpose(1, 2).contiguous()  # [P, 3, per]
    out = torch.empty((p, m_per), dtype=torch.int32, device=grouped.device)
    if out.numel() == 0:
        return out
    scratch = (torch.empty((p, per), dtype=torch.float32, device=grouped.device)
               if per > STAGE_MAX_ROWS else None)
    stream = torch.cuda.current_stream(grouped.device).cuda_stream
    rc = build.library().cbl_fps(
        planes.data_ptr(), out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
        p, per, m_per, stream,
    )
    launches += 1
    build.check(rc, "cbl_fps")
    return out
