"""Host grid subsample for the data preparers (counterpart of
contrastboundary_tpu/native/__init__.py, without its silent fallback).

``grid_subsample`` and ``voxel_pick`` call the port's copy of the C++ source
(csrc/grid_subsample.cpp), built with the host compiler at first use into
``_build/<hash>/libcbl_native.so`` (kernels/build.py::build_host) and loaded
with ctypes; a failed build raises. ``grid_subsample_plain`` and
``voxel_pick_plain`` are their numpy twins, which run only where a caller
calls them.

Both entries emit voxels in ascending voxel-hash order: the hash of a point
is that of its cell ``floor((p − min) / cell)`` on a 2^21 grid, in float32
as the C++ code computes it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np

from .kernels import build

_F32P, _I32P, _I64P = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int32,
                                                   ctypes.c_int64))
GRID = 1 << 21  # cells an axis of the voxel hash
_PICK_MIX = np.uint64(0x9E3779B97F4A7C15)  # cbl_voxel_pick's multiplicative hash


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded host library (built on first call)."""
    lib = ctypes.CDLL(str(build.build_host()))
    lib.cbl_grid_subsample.restype = ctypes.c_int64
    lib.cbl_grid_subsample.argtypes = [
        _F32P, _F32P, _I32P, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_float,
        _F32P, _F32P, _I32P, ctypes.c_int64,
    ]
    lib.cbl_voxel_pick.restype = ctypes.c_int64
    lib.cbl_voxel_pick.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_float, ctypes.c_uint64, _I64P, ctypes.c_int64,
    ]
    return lib


def _ptr(a, kind):
    return None if a is None else a.ctypes.data_as(kind)


def grid_subsample(points: np.ndarray, features: Optional[np.ndarray] = None,
                   labels: Optional[np.ndarray] = None, cell: float = 0.04,
                   num_classes: int = 13):
    """Voxel barycentre, feature mean and majority label (negative labels and
    labels >= num_classes vote for nothing; a voxel without a vote gets -1)
    → (points [M, 3] f32, features [M, F] f32 | None, labels [M] i32 | None)."""
    points = np.ascontiguousarray(points, np.float32)
    n = len(points)
    fdim = 0 if features is None else features.shape[1]
    feats = (np.zeros((0,), np.float32) if features is None
             else np.ascontiguousarray(features, np.float32))
    labs = None if labels is None else np.ascontiguousarray(labels, np.int32)
    out_p = np.empty((n, 3), np.float32)
    out_f = np.empty((n, max(fdim, 1)), np.float32)
    out_l = np.empty((n,), np.int32)
    m = library().cbl_grid_subsample(
        _ptr(points, _F32P), _ptr(feats, _F32P), _ptr(labs, _I32P), n, fdim,
        num_classes if labs is not None else 0, cell, _ptr(out_p, _F32P), _ptr(out_f, _F32P),
        _ptr(out_l, _I32P), n)
    if m < 0:
        raise RuntimeError("grid_subsample: more voxels than points")
    return (out_p[:m].copy(), out_f[:m, :fdim].copy() if features is not None else None,
            out_l[:m].copy() if labels is not None else None)


def voxel_pick(points: np.ndarray, cell: float, salt: int = 0) -> np.ndarray:
    """One pseudo-random member index per occupied voxel, sorted (train-mode
    voxelize), reproducible from ``salt``."""
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((len(points),), np.int64)
    m = library().cbl_voxel_pick(_ptr(points, _F32P), len(points), cell, salt,
                                 _ptr(out, _I64P), len(out))
    if m < 0:
        raise RuntimeError("voxel_pick: more voxels than points")
    return out[:m].copy()


def grid_subsample_plain(points, features, labels, cell, num_classes):
    """The numpy twin of ``grid_subsample`` (the JAX package's numpy route,
    the same code)."""
    points = np.ascontiguousarray(points, np.float32)
    v = np.floor((points - points.min(0)) / cell).astype(np.int64)
    key = (v[:, 0] * GRID + v[:, 1]) * GRID + v[:, 2]
    uniq, inv = np.unique(key, return_inverse=True)
    m = len(uniq)
    cnt = np.bincount(inv, minlength=m).astype(np.float64)
    out_p = np.stack([np.bincount(inv, weights=points[:, d], minlength=m) for d in range(3)],
                     -1) / cnt[:, None]
    out_f = None
    if features is not None:
        out_f = np.stack([
            np.bincount(inv, weights=features[:, d].astype(np.float64), minlength=m)
            for d in range(features.shape[1])], -1) / cnt[:, None]
        out_f = out_f.astype(np.float32)
    out_l = None
    if labels is not None:
        votes = np.zeros((m, num_classes))
        valid = labels >= 0
        np.add.at(votes, (inv[valid], labels[valid]), 1.0)
        out_l = np.where(votes.sum(-1) > 0, votes.argmax(-1), -1).astype(np.int32)
    return out_p.astype(np.float32), out_f, out_l


def voxel_pick_plain(points: np.ndarray, cell: float, salt: int = 0) -> np.ndarray:
    """The numpy twin of ``voxel_pick``: in each voxel the member whose mixed
    hash ((i + salt)·φ64, then h ^ h >> 29, modulo 2^64) is smallest."""
    points = np.ascontiguousarray(points, np.float32)
    if len(points) == 0 or cell <= 0:
        return np.zeros((0,), np.int64)
    v = np.floor((points - points.min(0)) / np.float32(cell)).astype(np.uint64)
    key = (v[:, 0] * np.uint64(GRID) + v[:, 1]) * np.uint64(GRID) + v[:, 2]
    h = (np.arange(len(points), dtype=np.uint64) + np.uint64(salt)) * _PICK_MIX
    h ^= h >> np.uint64(29)
    order = np.lexsort((h, key))  # by voxel, then by hash
    first = np.ones(len(order), bool)
    first[1:] = key[order][1:] != key[order][:-1]
    return np.sort(order[first]).astype(np.int64)
