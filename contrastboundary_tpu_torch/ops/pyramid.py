"""Multi-resolution index pyramid for the Morton-sorted, strided layout
(counterpart of contrastboundary_tpu/ops/pyramid.py::build_pyramid).

Ported for the eval pyramid of the flagship: ``layout='sorted'``,
``sampler='strided'``, no contrast or sub-scene searches, no radius masks.
Every level is stored Morton-sorted (``order0`` maps the caller's level-0
rows to sorted rows), each level is a strided row pick of the previous one,
and every search is a tile-window search (ops/knn.py), so each neighbour
index has a window-relative twin for the tile gathers (ops/tile_gather.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.gather import batch_gather
from .interpolate import interpolation_weights
from .knn import cross_width, tile_cross_knn, tile_self_knn
from .sampling import serialized_order
from .tile_gather import cross_window_gather, cross_window_starts, tile_window_gather


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static description of the pyramid; field names and defaults as in the
    JAX PyramidSpec (only the sorted + strided eval path is built)."""

    strides: Tuple[int, ...] = (1, 4, 4, 4, 4)
    k_self: Tuple[int, ...] = (8, 16, 16, 16, 16)
    k_down: Tuple[int, ...] = (8, 16, 16, 16, 16)
    k_up: int = 3
    k_contrast: Optional[Tuple[int, ...]] = None
    with_subscene: bool = False
    sampler: str = "strided"
    layout: str = "sorted"
    self_tile: int = 256
    self_window: int = 1

    @property
    def num_levels(self) -> int:
        return len(self.strides)


@dataclasses.dataclass
class Pyramid:
    """Per-level tensors (tuples over levels, None where not defined); the
    field names and meanings of the JAX Pyramid. Neighbour and sample
    indices are int32 (``order0`` int64); ``*_local`` are window-relative
    twins with shadow tile·width, and ``*_meta`` the matching (tile, width,
    window)."""

    points: Tuple
    sample_idx: Tuple
    self_idx: Tuple
    down_idx: Tuple
    up_idx: Tuple
    up_w: Tuple
    near0_idx: Tuple
    self_rel: Tuple
    down_rel: Tuple
    order0: torch.Tensor
    self_local: Tuple
    down_local: Tuple
    up_local: Tuple
    near0_local: Tuple
    down_meta: Tuple
    up_meta: Tuple
    near0_meta: Tuple


def strided_pick(n_prev: int, m: int) -> np.ndarray:
    """Row pick ``jnp.linspace(0, n_prev − 1, m).round()`` with the bits XLA
    gives it: its simplifier folds (n_prev − 1)·(i/div) into
    i·((n_prev − 1)·(1/div)) in float32 (checked against JAX on the CPU by
    tests/test_torch_pyramid.py); the last entry is exactly n_prev − 1, and
    rounding is half to even."""
    if m == 1:
        return np.zeros(1, np.int32)
    div = m - 1
    stop = np.float32(n_prev - 1)
    out = np.arange(div, dtype=np.float32) * (stop * (np.float32(1) / np.float32(div)))
    out = np.concatenate([out, np.array([stop], np.float32)])
    return np.round(out).astype(np.int32)


def _check_spec(spec: PyramidSpec):
    if spec.layout != "sorted" or spec.sampler != "strided":
        raise ValueError("only layout='sorted', sampler='strided' is ported")
    if spec.k_contrast is not None or spec.with_subscene:
        raise ValueError("contrast and sub-scene searches are not ported")


def _tile(spec: PyramidSpec, *sizes: int) -> int:
    t = min(spec.self_tile, *sizes)
    if any(s % t for s in sizes):
        raise ValueError(f"level sizes {sizes} are not multiples of tile {t}")
    return t


def _cross(spec, query, support, k):
    """→ (global idx, d2, (tile, width, window), window-relative idx)."""
    t = _tile(spec, query.shape[1], support.shape[1])
    idx, d2 = tile_cross_knn(query, support, k, tile=t, window=spec.self_window)
    n_sup = support.shape[1]
    gq, gs = query.shape[1] // t, n_sup // t
    width = cross_width(gq, gs, spec.self_window)
    starts = cross_window_starts(gq, gs, width, spec.self_window) * t
    row0 = torch.as_tensor(starts, device=idx.device).repeat_interleave(t)
    local = torch.where(idx >= n_sup, width * t, idx - row0[None, :, None])
    return idx, d2, (t, width, spec.self_window), local.to(torch.int32)


def _masked_rel(nb, p_query, li, shadow):
    valid = (li < shadow)[..., None]
    return torch.where(valid, nb - p_query[:, :, None, :], 0.0)


@torch.no_grad()
def build_pyramid(points: torch.Tensor, spec: PyramidSpec) -> Pyramid:
    """Build the eval pyramid from level-0 points [B, N, 3] (f32, on the
    device the searches should run on)."""
    _check_spec(spec)
    b, n, _ = points.shape
    dev = points.device
    order0 = serialized_order(points)
    points = batch_gather(points.float(), order0)

    def level_self(p, level):
        t = _tile(spec, p.shape[1])
        _, li, width = tile_self_knn(
            p, spec.k_self[level], tile=t, window=spec.self_window,
            exclude_self=False, ensure_self=True, assume_sorted=True,
        )
        return li, (t, width)

    pts = [points]
    ident = torch.arange(n, device=dev, dtype=torch.int32)[None].expand(b, n)
    sample_idx = [ident]
    s0, loc0 = level_self(points, 0)
    self_idx, self_local = [s0], [loc0]
    down_idx, up_idx, up_w, near0_idx = [None], [None], [None], [ident]
    down_local, down_meta = [None], [None]
    up_local, up_meta = [None], [None]
    near0_local, near0_meta = [None], [None]

    for l in range(1, spec.num_levels):
        prev = pts[l - 1]
        m = prev.shape[1] // spec.strides[l]
        pick = torch.as_tensor(strided_pick(prev.shape[1], m), device=dev)
        cur = prev[:, pick.long()]
        pts.append(cur)
        sample_idx.append(pick[None].expand(b, m))

        d_idx, _, d_meta, d_loc = _cross(spec, cur, prev, spec.k_down[l])
        down_idx.append(d_idx)
        down_meta.append(d_meta)
        down_local.append(d_loc)

        s_idx, s_loc = level_self(cur, l)
        self_idx.append(s_idx)
        self_local.append(s_loc)

        u_idx, u_d2, u_meta, u_loc = _cross(spec, prev, cur, spec.k_up)
        up_idx.append(u_idx)
        up_w.append(interpolation_weights(u_d2))
        up_meta.append(u_meta)
        up_local.append(u_loc)

        n_idx, _, n_meta, n_loc = _cross(spec, points, cur, 1)
        near0_idx.append(n_idx[..., 0])
        near0_meta.append(n_meta)
        near0_local.append(n_loc[..., 0])

    self_rel = []
    for l in range(spec.num_levels):
        t, width = self_local[l]
        nb = tile_window_gather(pts[l], self_idx[l], t, width)
        self_rel.append(_masked_rel(nb, pts[l], self_idx[l], t * width))
    down_rel = [None]
    for l in range(1, spec.num_levels):
        t, width, window = down_meta[l]
        nb = cross_window_gather(
            pts[l - 1], down_local[l], pts[l - 1].shape[1], t, width, window
        )
        down_rel.append(_masked_rel(nb, pts[l], down_local[l], t * width))

    return Pyramid(
        points=tuple(pts),
        sample_idx=tuple(sample_idx),
        self_idx=tuple(self_idx),
        down_idx=tuple(down_idx),
        up_idx=tuple(up_idx),
        up_w=tuple(up_w),
        near0_idx=tuple(near0_idx),
        self_rel=tuple(self_rel),
        down_rel=tuple(down_rel),
        order0=order0,
        self_local=tuple(self_local),
        down_local=tuple(down_local),
        up_local=tuple(up_local),
        near0_local=tuple(near0_local),
        down_meta=tuple(down_meta),
        up_meta=tuple(up_meta),
        near0_meta=tuple(near0_meta),
    )
