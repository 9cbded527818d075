"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every source under ``csrc/`` is compiled by one ``nvcc`` call into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), at first use, into ``_build/<hash of the sources, the headers they
include and the flags>/``
inside the package. A finished library is found again by its hash; a build
writes to a temporary name and renames it into place, so a cut build leaves
no library behind. A failed or timed-out build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = (
    "win_topk.cu", "tile_gather.cu", "window_gather_bwd.cu", "cbl_dense.cu", "pt_attn.cu",
    "cbl_tile2.cu", "gather_rows.cu",
)
HEADERS = ("window_sort.cuh", "slot_scatter.cuh")  # included by sources; part of the hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)
BUILD_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes; every entry returns cudaGetLastError() as an int
SIGNATURES = {
    # query, support, idx, val, b, m, ns, k, tile, width, window, gs, mode, stream
    "cbl_win_topk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, li, starts, out, b, ns, m, k, c, tile, width, lanes a row, pieces a
    # lane, rows a warp, stream
    "cbl_window_gather": (_P, _P, _P, _P) + (_I,) * 10 + (_P,),
    # g, li, starts, dx, b, ns, m, k, c, tile, width, stream
    "cbl_window_gather_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # features, meta, li, stats, b, m, k, c, tile, width, window, inv_t,
    # blocks a cloud, threads, shared bytes, stream
    "cbl_stats_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # features, meta, li, stats, g_stats, cd, lands, dx, b, m, k, c, tile,
    # width, window, inv_t, scatter rows a block, stream
    "cbl_stats_bwd": (_P,) * 8 + (_I,) * 7 + (_F, _I, _P),
    # q, kv, rel, li, starts, params (12 pointers), out, stats, b, m, k, c,
    # tile, width, blocks, threads, rows a tile, slots a chunk, shared bytes,
    # stream
    "cbl_pt_attn_fwd": (_P,) * 8 + (_I,) * 11 + (_P,),
    # q, kv, rel, li, starts, params, g_out, dq, dkv, dparams, b, m, k, c,
    # tile, width, blocks, threads, rows a tile, slots a chunk, shared bytes,
    # stream
    "cbl_pt_attn_bwd": (_P,) * 10 + (_I,) * 11 + (_P,),
    # features, meta, li, stats, b, m, k, c, tile, width, window, temperature,
    # rows a label block, rows a block over the rows of the mask, stream
    "cbl_tile2_fwd": (_P,) * 4 + (_I,) * 7 + (_F, _I, _I, _P),
    # features, meta, li, stats, g_loss, coef, lands, dx, b, m, k, c, tile,
    # width, window, temperature, rows a block of pass 1, scatter rows a block,
    # stream
    "cbl_tile2_bwd": (_P,) * 8 + (_I,) * 7 + (_F, _I, _I, _P),
    # fused, li, starts, stats, b, m, k, c, ncls, tile, width, temperature,
    # stream
    "cbl_tile_fwd": (_P,) * 4 + (_I,) * 7 + (_F, _P),
    # fused, li, starts, stats, g_loss, dx, b, m, k, c, ncls, tile, width,
    # temperature, stream
    "cbl_tile_bwd": (_P,) * 6 + (_I,) * 7 + (_F, _P),
    # x, idx, out, n, m, row bytes, stream
    "cbl_gather_rows": (_P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libcbl_kernels.so"


def build() -> Path:
    """Compile the sources unless a library with their hash exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    try:
        res = subprocess.run(
            cmd, capture_output=True, text=True, timeout=BUILD_TIMEOUT_S
        )
    except subprocess.TimeoutExpired as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc timed out after {BUILD_TIMEOUT_S} s: {' '.join(cmd)}"
        ) from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.cbl_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cbl_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = library().cbl_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
