"""Build the port's CUDA kernels with nvcc, and its host library with the
host C++ compiler, and load them with ctypes.

Every source under ``csrc/`` is compiled by its own ``nvcc -c`` call, all of
them started together, and the objects are linked by one more into one
shared library with a plain C interface (no PyTorch headers), at first use,
into ``_build/<hash of the sources, the headers they include and the
flags>/`` inside the package. A finished library is found again by its hash;
a build writes to temporary names and renames the library into place, so a
cut build leaves no library behind. A failed or timed-out build raises.

The host sources (``HOST_SOURCES``: the data preparers' grid subsample) are
not CUDA: one call of the host compiler builds them into their own
``_build/<hash>/libcbl_native.so`` the same way, so that they build on a
machine without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = (
    "win_topk.cu", "tile_gather.cu", "window_gather_bwd.cu", "cbl_dense.cu", "pt_attn.cu",
    "cbl_tile2.cu", "gather_rows.cu", "fps.cu",
)
HEADERS = ("window_sort.cuh", "slot_scatter.cuh")  # included by sources; part of the hash
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
)
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")
HOST_SOURCES = ("grid_subsample.cpp",)  # built by the host compiler, not nvcc
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
BUILD_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry -> argtypes; every entry returns cudaGetLastError() as an int
SIGNATURES = {
    # query, support, idx, val, b, m, ns, k, tile, width, window, gs, mode,
    # last_ties, stream
    "cbl_win_topk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, li, starts, out, b, ns, m, k, c, tile, width, lanes a row, pieces a
    # lane, rows a warp, bytes an element, stream
    "cbl_window_gather": (_P, _P, _P, _P) + (_I,) * 11 + (_P,),
    # g, li, starts, dx, b, ns, m, k, c, tile, width, bytes an element, stream
    "cbl_window_gather_bwd": (_P, _P, _P, _P) + (_I,) * 8 + (_P,),
    # features, meta, li, stats, b, m, k, c, tile, width, window, inv_t,
    # blocks a cloud, threads, shared bytes, stream
    "cbl_stats_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    # features, meta, li, stats, g_stats, cd, lands, dx, b, m, k, c, tile,
    # width, window, inv_t, scatter rows a block, stream
    "cbl_stats_bwd": (_P,) * 8 + (_I,) * 7 + (_F, _I, _P),
    # q, kv, rel, li, starts, params (12 pointers), out, stats, b, m, k, c,
    # tile, width, blocks, threads, rows a tile, slots a chunk, shared bytes,
    # bytes an element of q, kv and out, stream
    "cbl_pt_attn_fwd": (_P,) * 8 + (_I,) * 12 + (_P,),
    # q, kv, rel, li, starts, params, g_out, dq, dkv, dparams, b, m, k, c,
    # tile, width, blocks, threads, rows a tile, slots a chunk, shared bytes,
    # bytes an element of q, kv and g_out, stream
    "cbl_pt_attn_bwd": (_P,) * 10 + (_I,) * 12 + (_P,),
    # features, meta, li, stats, b, m, k, c, tile, width, window, temperature,
    # rows a label block, rows a block over the rows of the mask, stream
    "cbl_tile2_fwd": (_P,) * 4 + (_I,) * 7 + (_F, _I, _I, _P),
    # features, meta, li, stats, g_loss, coef, lands, dx, b, m, k, c, tile,
    # width, window, temperature, rows a block of pass 1, scatter rows a block,
    # stream
    "cbl_tile2_bwd": (_P,) * 8 + (_I,) * 7 + (_F, _I, _I, _P),
    # fused, li, features, meta (the split's scratch), stats, b, m, k, c,
    # ncls, tile, width, window, temperature, rows a label block, rows a
    # block over the rows of the mask, stream
    "cbl_tile_fwd": (_P,) * 5 + (_I,) * 8 + (_F, _I, _I, _P),
    # fused, li, stats, g_loss, features, meta, coef, lands, dx (scratch),
    # dfused, b, m, k, c, ncls, tile, width, window, temperature, rows a
    # block of pass 1, scatter rows a block, stream
    "cbl_tile_bwd": (_P,) * 10 + (_I,) * 8 + (_F, _I, _I, _P),
    # x, idx, out, n, m, row bytes, stream
    "cbl_gather_rows": (_P, _P, _P, _I, _I, _I, _P),
    # planes, out, scratch, buckets, rows a bucket, picks a bucket, stream
    "cbl_fps": (_P, _P, _P, _I, _I, _I, _P),
}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _digest(names, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in names:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def source_hash() -> str:
    return _digest(SOURCES + HEADERS, NVCC_FLAGS + LINK_FLAGS)


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "libcbl_kernels.so"


def _run(cmds) -> None:
    """Run the compiler commands together; raise (after stopping the others)
    if one fails or the batch outlasts BUILD_TIMEOUT_S."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    deadline = time.monotonic() + BUILD_TIMEOUT_S
    try:
        for cmd, p in zip(cmds, procs):
            try:
                stdout, stderr = p.communicate(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired as e:
                raise RuntimeError(
                    f"{Path(cmd[0]).name} timed out after {BUILD_TIMEOUT_S} s: {' '.join(cmd)}"
                ) from e
            if p.returncode != 0:
                raise RuntimeError(f"{Path(cmd[0]).name} failed ({p.returncode}): "
                                   f"{' '.join(cmd)}\n{stdout}\n{stderr}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def build() -> Path:
    """Compile the sources unless a library with their hash exists: one
    ``nvcc -c`` a source, all at once, then one link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [out.with_name(f".{Path(s).stem}.{tag}.o") for s in SOURCES]
    tmp = out.with_name(f".{out.name}.{tag}")
    try:
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
              for s, o in zip(SOURCES, objs)])
        _run([[nvcc, *LINK_FLAGS, "-o", str(tmp), *(str(o) for o in objs)]])
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return out


def host_library_path() -> Path:
    return BUILD_ROOT / _digest(HOST_SOURCES, CXX_FLAGS) / "libcbl_native.so"


def _cxx() -> str:
    for cand in ("g++", "c++"):
        path = shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found (g++ or c++ on PATH)")


def build_host() -> Path:
    """Compile the host sources unless a library with their hash exists."""
    out = host_library_path()
    if out.exists():
        return out
    cxx = _cxx()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    try:
        _run([[cxx, *CXX_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in HOST_SOURCES)]])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
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
