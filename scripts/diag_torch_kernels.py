"""Diagnostics of the port's cbl_stats_fwd CUDA kernel on one card: a
launch-plan sweep and variant kernel packages for same-call A/B runs.
Timing aids, not checks. (The attention's launch plans are
ops/cuda/pt_attn.py::fwd_plan and ::bwd_plan; scripts/ab_torch_kernels.py
times its calls.)

    python3 scripts/diag_torch_kernels.py sweep
    python3 scripts/diag_torch_kernels.py variant NAME

from the repository root. ``sweep`` times the kernel's bare C entry at the
flagship's five CBL stages (B=2 x N=65536; seeded synthetic inputs) with
32-256 rows a block and 256 or 512 threads. ``variant NAME`` writes a copy
of the kernel package with one edit under ``_local/variants/NAME/``, for
``scripts/ab_torch_kernels.py --parent _local/variants/NAME
--old-may-differ``:

- conflict_free_reads: the stats forward reads, for each slot, the row of
  the same 8-row group whose index mod 8 is the lane's (wrong values: the
  reads without bank conflicts, timing only);
- tree_sums: the stats forward adds each lane's terms in slot order, then
  the lanes in a fixed tree (not slot order).
"""
from __future__ import annotations

import argparse
import importlib
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = "contrastboundary_tpu_torch"
# (M, K, tile, width, window) of the five dense-CBL stages of the flagship
CBL_STAGES = [(65536, 35, 256, 3, 1), (16384, 23, 256, 3, 1), (4096, 23, 256, 3, 1),
              (1024, 23, 256, 3, 1), (256, 23, 256, 1, 0)]
# variant name -> (source, [(text, replacement), ...]); each text must occur once
EDITS = {
    "conflict_free_reads": ("cbl_dense.cu", [
        ("      const float4 t = win[chunk_at(w[j], i)];",
         "      const float4 t = win[chunk_at((w[j] & ~7) | (int)(threadIdx.x & 7), i)];"),
    ]),
    "tree_sums": ("cbl_dense.cu", [
        ("""      for (int l = 0; l < kFwdLanes; ++l) {
        if (lane == l) {
#pragma unroll
          for (int j = 0; j < S; ++j) {
            if (!(mv[j] > 0.f)) continue;  // e = posmv = mv = 0
            const float posmv = (pos >> j & 1u ? 1.f : 0.f) * mv[j];
            acc.x = __fadd_rn(acc.x, __fmul_rn(d[j], posmv));
            acc.y = __fadd_rn(acc.y, d[j]);
            acc.z = __fadd_rn(acc.z, posmv);
            acc.w = __fadd_rn(acc.w, mv[j]);
          }
        }
        acc.x = __shfl_sync(gmask, acc.x, l, kFwdLanes);
        acc.y = __shfl_sync(gmask, acc.y, l, kFwdLanes);
        acc.z = __shfl_sync(gmask, acc.z, l, kFwdLanes);
        acc.w = __shfl_sync(gmask, acc.w, l, kFwdLanes);
      }
    }""", """#pragma unroll
      for (int j = 0; j < S; ++j) {
        if (!(mv[j] > 0.f)) continue;
        const float posmv = (pos >> j & 1u ? 1.f : 0.f) * mv[j];
        acc.x = __fadd_rn(acc.x, __fmul_rn(d[j], posmv));
        acc.y = __fadd_rn(acc.y, d[j]);
        acc.z = __fadd_rn(acc.z, posmv);
        acc.w = __fadd_rn(acc.w, mv[j]);
      }
    }
#pragma unroll
    for (int o = kFwdLanes / 2; o > 0; o /= 2) {
      acc.x = __fadd_rn(acc.x, __shfl_xor_sync(gmask, acc.x, o, kFwdLanes));
      acc.y = __fadd_rn(acc.y, __shfl_xor_sync(gmask, acc.y, o, kFwdLanes));
      acc.z = __fadd_rn(acc.z, __shfl_xor_sync(gmask, acc.z, o, kFwdLanes));
      acc.w = __fadd_rn(acc.w, __shfl_xor_sync(gmask, acc.w, o, kFwdLanes));
    }
    acc.x = __shfl_sync(gmask, acc.x, 0, kFwdLanes);
    acc.y = __shfl_sync(gmask, acc.y, 0, kFwdLanes);
    acc.z = __shfl_sync(gmask, acc.z, 0, kFwdLanes);
    acc.w = __shfl_sync(gmask, acc.w, 0, kFwdLanes);"""),
    ]),
}


def write_variant(name: str) -> Path:
    """A copy of the kernel package with the variant's edits, under
    _local/variants/<name>/."""
    src, edits = EDITS[name]
    dest = ROOT / "_local" / "variants" / name
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(ROOT / PKG, dest / PKG, ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = dest / PKG / "csrc" / src
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {src} holds {text.count(old)} copies of {old[:60]!r}")
        text = text.replace(old, new)
    path.write_text(text)
    return dest


def import_package(root: Path):
    """The kernel package under ``root`` (this process's only copy)."""
    sys.path.insert(0, str(root))
    return (importlib.import_module(f"{PKG}.kernels.build"),
            importlib.import_module(f"{PKG}.ops.cuda.cbl_dense"))


def time_ms(fn, flush, reps=10) -> float:
    """Mean device time of fn over reps runs, each after an L2 flush."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def sweep(dev) -> None:
    build, cd = import_package(ROOT)
    lib, rng = build.library(), np.random.default_rng(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    flush = torch.empty(64 * 2**20, device=dev)
    for m, k, tile, width, window in CBL_STAGES:
        b, w_sz = 2, tile * width
        f = torch.as_tensor(rng.standard_normal((b, m, 32), dtype=np.float32), device=dev)
        meta = np.zeros((b, m, 8), np.float32)
        meta[..., 0] = rng.integers(0, 13, (b, m))
        meta[..., 1] = rng.random((b, m)) > 0.1
        meta = torch.as_tensor(meta, device=dev)
        li = np.stack([rng.permutation(w_sz)[:k] for _ in range(64)])
        li = torch.as_tensor(np.tile(li, (b * m // 64, 1)).reshape(b, m, k).astype(np.int32),
                             device=dev)
        out = torch.empty((b, m, 8), device=dev)
        plan = cd.fwd_plan(b, m, k, tile, width)
        res = []
        for rows in (32, 64, 128, 256):
            for threads in (256, 512):
                if tile % rows or (threads > 256 and threads // 8 > rows):
                    continue
                fn = lambda: build.check(lib.cbl_stats_fwd(
                    f.data_ptr(), meta.data_ptr(), li.data_ptr(), out.data_ptr(), b, m, k, 32,
                    tile, width, window, 1.0, m // rows, threads, plan[2], stream), "fwd")
                res.append(f"rows {rows} threads {threads}: {time_ms(fn, flush):.4f}")
        print(f"cbl_stats_fwd M={m} K={k}, plan {plan}: " + ", ".join(res), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("sweep", "variant"))
    ap.add_argument("name", nargs="?", choices=tuple(EDITS))
    args = ap.parse_args()
    if args.what == "variant":
        if args.name is None:
            ap.error("variant needs a NAME")
        print(write_variant(args.name))
        return 0
    if not torch.cuda.is_available():
        print("diag_torch_kernels: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
