"""Multi-resolution index pyramid (counterpart of
contrastboundary_tpu/ops/pyramid.py::build_pyramid), in two layouts.

``layout='sorted'`` (the point transformer's fast path): every level is
stored Morton-sorted (``order0`` maps the caller's level-0 rows to sorted
rows) and every search is a tile-window search (ops/knn.py), so each
neighbour index has a window-relative twin for the tile gathers
(ops/tile_gather.py). With ``sampler='strided'`` each level is a strided
row pick of the previous one; with ``fps``, ``bucket_fps``,
``serialized`` or ``random`` it is that sampler's pick, sorted by row (a subset of a
sorted level, in row order, is sorted). With ``k_contrast`` the self and
contrast searches are one merged search where the contrast search's tile
and window are the self search's, else the contrast search is its own
tile-window search (self excluded) on ``contrast_tile`` and
``contrast_window``; with ``with_subscene`` the kr = 4^l searches over
level 0 are added.

``layout='natural'`` (the ConvNet family with ``sampler='voxel'`` or
``random``, the point transformer with ``fps``, ``bucket_fps``,
``serialized``, which ``strided`` means there, or ``random``): the levels keep the caller's row order
(``order0`` None), each level is the sampler's pick of the previous one
(ops/sampling.py), and every search is over global rows with the shadow
index N: the pooling search within ``down_radii``, the self search within
``radii`` (slot 0 the point itself), the up, nearest-to-level-0, contrast
(self excluded, k − 1) and sub-scene searches unbounded. A search is the
dense exact ops/knn.py::knn, or with ``knn_window`` > 0 and both sizes
multiples of ``knn_tile`` the windowed ops/knn.py::windowed_knn. With
``contrast_mode='tile'`` the contrast search of a level whose size is a
multiple of min(contrast_tile, M_l) is instead a tile-window search in the
level's own Morton order (``contrast_order``), its indices window-relative
(``contrast_local`` = (tile, width)), as the sorted layout's. The relative
positions ``self_rel`` and ``down_rel`` are the neighbour's coordinates
(read at min(idx, N − 1)) less the query's, zero at a shadow slot; the
window-relative twins are None.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.gather import batch_gather, clamped_gather
from .interpolate import interpolation_weights
from .knn import cross_width, knn as _knn, tile_cross_knn, tile_self_knn, windowed_knn
from .sampling import (bucket_fps, fps, random_sample, serialized_order, serialized_sample,
                       strided_pick, voxel_sample)
from .tile_gather import cross_window_gather, cross_window_starts, tile_window_gather


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static description of the pyramid; field names as in the JAX
    PyramidSpec, whose defaults differ in ``sampler`` and ``layout`` (the
    port's default is the flagship's sorted, strided pyramid). Two layouts
    are built: sorted and natural; the samplers are strided (the sorted
    layout's inherited order; serialized on the natural one), serialized,
    fps, bucket_fps (``num_buckets`` Morton buckets, halved until they
    divide both level sizes, exact fps at one), voxel (with
    ``voxel_sizes``) and random (the first rows of a fixed threefry
    permutation of the level, ops/sampling.py::random_sample). ``radii[l]`` bounds the level-l self search,
    ``down_radii[l]`` the level-(l−1) → l pooling search (natural layout;
    None: unbounded); ``voxel_sizes[l]`` is the voxel sampler's cell at
    level l (level 0 unused). ``knn_window`` > 0 makes the natural layout's
    searches windowed (``knn_tile`` rows a tile); ``contrast_mode='tile'``
    its contrast searches tile-window searches; ``contrast_tile`` and
    ``contrast_window`` give their geometry (on the sorted layout too).
    ``knn_recall`` only sets the tie rule of the natural layout's top-1
    searches (ops/knn.py::knn, ::windowed_knn): every search of the port
    is exact."""

    strides: Tuple[int, ...] = (1, 4, 4, 4, 4)
    k_self: Tuple[int, ...] = (8, 16, 16, 16, 16)
    k_down: Tuple[int, ...] = (8, 16, 16, 16, 16)
    k_up: int = 3
    k_contrast: Optional[Tuple[int, ...]] = None
    with_subscene: bool = False
    sampler: str = "strided"
    num_buckets: int = 64
    layout: str = "sorted"
    self_tile: int = 256
    self_window: int = 1
    radii: Optional[Tuple[float, ...]] = None
    down_radii: Optional[Tuple[float, ...]] = None
    voxel_sizes: Optional[Tuple[float, ...]] = None
    knn_recall: Optional[float] = 0.95
    knn_window: int = 0
    knn_tile: int = 256
    contrast_mode: str = "dense"
    contrast_tile: int = 256
    contrast_window: int = 1

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def subscene_k(self, level: int) -> int:
        """kr of the sub-scene labels: the product of the strides up to
        ``level``."""
        return int(np.prod(self.strides[1: level + 1], dtype=np.int64))


@dataclasses.dataclass
class Pyramid:
    """Per-level tensors (tuples over levels, None where not defined); the
    field names and meanings of the JAX Pyramid. Neighbour and sample
    indices are int32 (``order0`` int64, None in the natural layout);
    ``*_local`` are window-relative twins with shadow tile·width, and
    ``*_meta`` the matching (tile, width, window), all None in the natural
    layout. ``contrast_idx`` (self excluded; window-relative with
    ``contrast_local`` = (tile, width) in the sorted layout and in the
    natural one's tile mode, else global rows with ``contrast_local`` None)
    and ``subscene_idx`` (global level-0 rows) are None per level unless the
    spec asks for them. ``contrast_order[l]`` is the [B, N_l] Morton order
    of a natural level whose contrast search ran in tile mode (its indices
    are rows of the level taken in that order), None elsewhere."""

    points: Tuple
    sample_idx: Tuple
    self_idx: Tuple
    down_idx: Tuple
    up_idx: Tuple
    up_w: Tuple
    near0_idx: Tuple
    self_rel: Tuple
    down_rel: Tuple
    order0: Optional[torch.Tensor]
    self_local: Tuple
    down_local: Tuple
    up_local: Tuple
    near0_local: Tuple
    down_meta: Tuple
    up_meta: Tuple
    near0_meta: Tuple
    contrast_idx: Tuple
    contrast_local: Tuple
    subscene_idx: Tuple
    contrast_order: Tuple


SAMPLERS = ("strided", "serialized", "fps", "bucket_fps", "voxel", "random")


def _check_spec(spec: PyramidSpec):
    if spec.layout not in ("sorted", "natural"):
        raise ValueError(f"unknown layout {spec.layout!r}")
    if spec.sampler not in SAMPLERS:
        raise ValueError(f"sampler {spec.sampler!r} is not one of the ported samplers {SAMPLERS}")
    if spec.layout == "sorted" and (spec.radii or spec.down_radii):
        raise ValueError("layout='sorted' does not support radius masks")
    if spec.sampler == "voxel" and spec.voxel_sizes is None:
        raise ValueError("sampler='voxel' requires voxel_sizes")
    if spec.k_contrast is not None and len(spec.k_contrast) < spec.num_levels:
        raise ValueError(f"k_contrast {spec.k_contrast} needs {spec.num_levels} levels")
    if spec.contrast_mode not in ("dense", "tile"):
        raise ValueError(f"unknown contrast_mode {spec.contrast_mode!r}")


def _sample(points: torch.Tensor, m: int, spec: PyramidSpec, level: int) -> torch.Tensor:
    """The sampler's m rows of ``points`` [B, N, 3] → [B, m] int32 (JAX
    ``_sample``): bucket_fps halves its buckets while they do not divide N
    and m, and is exact fps at one bucket; strided is serialized here (the
    sorted layout's strided pick never comes here); random is the level's
    fixed permutation (sorted by row on the sorted layout, by the
    caller)."""
    if spec.sampler == "fps":
        return fps(points, m)
    if spec.sampler == "bucket_fps":
        g, n = spec.num_buckets, points.shape[1]
        while g > 1 and (n % g or m % g):
            g //= 2
        return fps(points, m) if g <= 1 else bucket_fps(points, m, g)
    if spec.sampler in ("serialized", "strided"):
        return serialized_sample(points, m)
    if spec.sampler == "random":
        return random_sample(points, m, level)
    return voxel_sample(points, m, spec.voxel_sizes[level])


def _tile(spec: PyramidSpec, *sizes: int, tile: Optional[int] = None) -> int:
    t = min(spec.self_tile if tile is None else tile, *sizes)
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


def _merged_self_contrast(spec, p, level, tile):
    """One window search of top-max(k_self, k_contrast) serves both the
    backbone and the CBL (JAX ``_merged_self_contrast``): self_idx is its
    first k_self slots with slot 0 forced to the query itself, contrast_idx
    its first k_contrast slots with the self entry dropped (the first
    k_contrast − 1 when self is not among them). → (self_idx, width,
    contrast_idx), window-relative."""
    b, m, _ = p.shape
    ks, kc = spec.k_self[level], spec.k_contrast[level]
    _, li, width = tile_self_knn(
        p, max(ks, kc), tile=tile, window=spec.self_window,
        exclude_self=False, ensure_self=False, assume_sorted=True,
    )
    starts = cross_window_starts(m // tile, m // tile, width, spec.self_window)
    self_pos = torch.as_tensor(
        np.arange(m) - np.repeat(starts * tile, tile), dtype=torch.int32,
        device=p.device,
    )[None, :, None]
    s_idx = torch.cat([self_pos.expand(b, m, 1), li[..., 1:ks]], -1)
    is_self = li[..., :kc] == self_pos
    slot = torch.where(
        is_self.any(-1), is_self.to(torch.int32).argmax(-1), kc
    )[..., None]
    j = torch.arange(kc - 1, device=p.device)
    c_idx = torch.where(j < slot, li[..., : kc - 1], li[..., 1:kc])
    return s_idx.to(torch.int32), width, c_idx.to(torch.int32)


def _masked_rel(nb, p_query, li, shadow):
    valid = (li < shadow)[..., None]
    return torch.where(valid, nb - p_query[:, :, None, :], 0.0)


def _rel(p_support, p_query, idx):
    """Neighbour minus query coordinates over global rows (JAX ``_rel``):
    the neighbour read at min(idx, N − 1), zero where idx is the shadow N."""
    return _masked_rel(clamped_gather(p_support, idx), p_query, idx, p_support.shape[1])


@torch.no_grad()
def build_pyramid(points: torch.Tensor, spec: PyramidSpec) -> Pyramid:
    """Build the pyramid from level-0 points [B, N, 3] (f32, on the device
    the searches should run on)."""
    _check_spec(spec)
    if spec.layout == "natural":
        return _build_natural(points.float(), spec)
    b, n, _ = points.shape
    dev = points.device
    order0 = serialized_order(points)
    points = batch_gather(points.float(), order0)

    contrast_idx = [None] * spec.num_levels
    contrast_local = [None] * spec.num_levels
    merge = spec.k_contrast is not None and (spec.self_tile, spec.self_window) == (
        spec.contrast_tile, spec.contrast_window)

    def level_self(p, level):
        t = _tile(spec, p.shape[1])
        if merge:
            s_idx, width, c_idx = _merged_self_contrast(spec, p, level, t)
            contrast_idx[level], contrast_local[level] = c_idx, (t, width)
            return s_idx, (t, width)
        _, li, width = tile_self_knn(
            p, spec.k_self[level], tile=t, window=spec.self_window,
            exclude_self=False, ensure_self=True, assume_sorted=True,
        )
        if spec.k_contrast is not None:
            # the contrast search on its own geometry (JAX: when the tile or
            # window differs from the self search's)
            tc = _tile(spec, p.shape[1], tile=spec.contrast_tile)
            _, c_idx, c_width = tile_self_knn(
                p, spec.k_contrast[level] - 1, tile=tc, window=spec.contrast_window,
                exclude_self=True, assume_sorted=True,
            )
            contrast_idx[level], contrast_local[level] = c_idx, (tc, c_width)
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
        if spec.sampler == "strided":
            pick = torch.as_tensor(strided_pick(prev.shape[1], m), device=dev)
            cur = prev[:, pick.long()]
            sample_idx.append(pick[None].expand(b, m))
        else:
            idx = torch.sort(_sample(prev, m, spec, l), dim=1).values
            cur = batch_gather(prev, idx)
            sample_idx.append(idx)
        pts.append(cur)

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

    subscene_idx = [None] * spec.num_levels
    if spec.with_subscene:
        for l in range(1, spec.num_levels):
            subscene_idx[l] = _cross(spec, pts[l], points, spec.subscene_k(l))[0]

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
        contrast_idx=tuple(contrast_idx),
        contrast_local=tuple(contrast_local),
        subscene_idx=tuple(subscene_idx),
        contrast_order=(None,) * spec.num_levels,
    )


def _build_natural(points: torch.Tensor, spec: PyramidSpec) -> Pyramid:
    """The natural layout (JAX ``build_pyramid`` with layout='natural'):
    searches over global rows, dense or windowed (JAX ``_knn``), and the
    contrast searches of ``contrast_mode='tile'``."""
    b, n, _ = points.shape
    nl = spec.num_levels
    none = (None,) * nl

    def radius(radii, l):
        return radii[l] if radii else None

    def knn(query, support, k, **kw):
        if spec.knn_window > 0 and not (query.shape[1] % spec.knn_tile
                                        or support.shape[1] % spec.knn_tile):
            return windowed_knn(query, support, k, tile=spec.knn_tile,
                                window=spec.knn_window, recall=spec.knn_recall, **kw)
        return _knn(query, support, k, recall=spec.knn_recall, **kw)

    ident = torch.arange(n, device=points.device, dtype=torch.int32)[None].expand(b, n)
    pts, sample_idx = [points], [ident]
    self_idx = [knn(points, points, spec.k_self[0], radius=radius(spec.radii, 0),
                    ensure_self=True)[0]]
    down_idx, up_idx, up_w, near0_idx = [None], [None], [None], [ident]
    for l in range(1, nl):
        prev = pts[l - 1]
        idx = _sample(prev, prev.shape[1] // spec.strides[l], spec, l)
        cur = batch_gather(prev, idx)
        pts.append(cur)
        sample_idx.append(idx)
        down_idx.append(knn(cur, prev, spec.k_down[l],
                            radius=radius(spec.down_radii, l))[0])
        self_idx.append(knn(cur, cur, spec.k_self[l], radius=radius(spec.radii, l),
                            ensure_self=True)[0])
        u_idx, u_d2 = knn(prev, cur, spec.k_up)
        up_idx.append(u_idx)
        up_w.append(interpolation_weights(u_d2))
        near0_idx.append(knn(points, cur, 1)[0][..., 0])

    contrast_idx, contrast_local, contrast_order = list(none), list(none), list(none)
    if spec.k_contrast is not None:
        for l in range(nl):
            m_l, kc = pts[l].shape[1], spec.k_contrast[l] - 1
            tile = min(spec.contrast_tile, m_l)
            if spec.contrast_mode == "tile" and m_l % tile == 0:
                contrast_order[l], contrast_idx[l], width = tile_self_knn(
                    pts[l], kc, tile=tile, window=spec.contrast_window, exclude_self=True)
                contrast_local[l] = (tile, width)
            else:
                contrast_idx[l] = knn(pts[l], pts[l], kc, exclude_self=True)[0]
    subscene_idx = list(none)
    if spec.with_subscene:
        for l in range(1, nl):
            subscene_idx[l] = knn(pts[l], points, spec.subscene_k(l))[0]

    return Pyramid(
        points=tuple(pts),
        sample_idx=tuple(sample_idx),
        self_idx=tuple(self_idx),
        down_idx=tuple(down_idx),
        up_idx=tuple(up_idx),
        up_w=tuple(up_w),
        near0_idx=tuple(near0_idx),
        self_rel=tuple(_rel(pts[l], pts[l], self_idx[l]) for l in range(nl)),
        down_rel=(None,) + tuple(_rel(pts[l - 1], pts[l], down_idx[l]) for l in range(1, nl)),
        order0=None,
        self_local=none,
        down_local=none,
        up_local=none,
        near0_local=none,
        down_meta=none,
        up_meta=none,
        near0_meta=none,
        contrast_idx=tuple(contrast_idx),
        contrast_local=tuple(contrast_local),
        subscene_idx=tuple(subscene_idx),
        contrast_order=tuple(contrast_order),
    )
