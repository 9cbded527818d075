"""Diagnostics of the port's cbl_stats_fwd and pt_attn_bwd CUDA kernels on
one card: launch-plan sweeps, per-phase clocks, and variant kernel packages
for same-call A/B runs. Timing aids, not checks.

    python3 scripts/diag_torch_kernels.py sweep
    python3 scripts/diag_torch_kernels.py clocks
    python3 scripts/diag_torch_kernels.py variant NAME

from the repository root. ``sweep`` times the two kernels' bare C entries
at the flagship's shapes (B=2 x N=65536; seeded synthetic inputs) for every
launch geometry the kernels take: the stats forward at the five CBL stages
with 32-256 rows a block and 256 or 512 threads, the attention backward at
the five stale widths with each power-of-two tile that fits. ``clocks``
builds the phase_clocks variant and prints the attention backward's clock
cycles per phase and tile at the five widths. ``variant NAME`` writes a copy
of the kernel package with one edit under ``_local/variants/NAME/``, for
``scripts/ab_torch_kernels.py --parent _local/variants/NAME
--old-may-differ``:

- conflict_free_reads: the stats forward reads, for each slot, the row of
  the same 8-row group whose index mod 8 is the lane's (wrong values: the
  reads without bank conflicts, timing only);
- tree_sums: the stats forward adds each lane's terms in slot order, then
  the lanes in a fixed tree (not slot order);
- no_atomics: the attention backward leaves out its dk|dv atomics (wrong
  dk|dv, timing only);
- phase_clocks: thread 0 of each attention-backward block adds up the
  clock cycles between the block's barriers by phase and writes the 8 sums
  over the first floats of the block's packed gradient row.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = "contrastboundary_tpu_torch"
SHARES = 8
# (M, K, tile, width, window) of the five dense-CBL stages of the flagship
CBL_STAGES = [(65536, 35, 256, 3, 1), (16384, 23, 256, 3, 1), (4096, 23, 256, 3, 1),
              (1024, 23, 256, 3, 1), (256, 23, 256, 1, 0)]
# (C, M, K) of the stale step's five attention widths
ATTN_WIDTHS = [(32, 65536, 8), (64, 16384, 16), (128, 4096, 16), (256, 1024, 16), (512, 256, 16)]
PHASES = ("P6 and the parameters", "P0", "P1", "P2", "P3", "P4", "P5", "P6 of the last tile")

# variant name -> (source, [(text, replacement), ...]); each text must occur once
_CLK = "do { const long long n_ = clock64(); clk[i] += n_ - clk_t; clk_t = n_; } while (0)"
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
    "no_atomics": ("pt_attn.cu", [
        ("""          if (src >= 0 && (c & 3) == 0) {
            atomicAdd(reinterpret_cast<float4*>(dkv + (long long)src * (2 * C) + c), ak);
            atomicAdd(reinterpret_cast<float4*>(dkv + (long long)src * (2 * C) + C + c), av);
          }""", """          if (src >= 0 && (c & 3) == 0 && ak.x == 12345.f)
            *reinterpret_cast<float4*>(dkv + (long long)src * (2 * C) + c) = av;"""),
    ]),
    "phase_clocks": ("pt_attn.cu", [
        ("  const int n_tiles = (int)((rows + R - 1) / R);",
         "  long long clk[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n  long long clk_t = clock64();\n"
         f"#define CLK(i) {_CLK}\n  const int n_tiles = (int)((rows + R - 1) / R);"),
        ("    __syncthreads();  // the parameters loaded; the last tile's arrays read\n",
         "    __syncthreads();  // the parameters loaded; the last tile's arrays read\n    CLK(0);\n"),
        ("    // P1: r1 (rounded", "    CLK(1);\n    // P1: r1 (rounded"),
        ("    // P2: bvec, in", "    CLK(2);\n    // P2: bvec, in"),
        ("    // P3: w4 = r2 W4", "    CLK(3);\n    // P3: w4 = r2 W4"),
        ("    // P4: softmax over", "    CLK(4);\n    // P4: softmax over"),
        ("    // P5: dr2 = dw4", "    CLK(5);\n    // P5: dr2 = dw4"),
        ("    // P6: thread (c6, g6)", "    CLK(6);\n    // P6: thread (c6, g6)"),
        ("  // the block's packed gradient row, in place",
         "  __syncthreads();\n  CLK(7);\n  // the block's packed gradient row, in place"),
        ("  for (int e = tid; e < L::PROW; e += T) out[e] = pr[e];\n}",
         "  for (int e = tid; e < L::PROW; e += T) out[e] = pr[e];\n  __syncthreads();\n"
         "  if (tid == 0) for (int i = 0; i < 8; ++i) out[i] = (float)clk[i];\n}"),
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
            importlib.import_module(f"{PKG}.ops.cuda.cbl_dense"),
            importlib.import_module(f"{PKG}.ops.cuda.pt_attn"),
            importlib.import_module(f"{PKG}.ops.tile_gather"))


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


def attn_inputs(rng, dev, c, m, k, tile_gather):
    """Seeded synthetic operands of one attention backward call: B=2, tile
    256, width 3 (1 at M = 256), slot 0 the query itself, every 7th row's
    last slot a shadow slot."""
    b, cs, tile = 2, c // SHARES, 256
    width = 3 if m // tile >= 3 else 1
    w_sz = tile * width
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float32), device=dev)
    params = [t(rng.standard_normal(sh) * 0.3 + off) for sh, off in (
        ((3, 3), 0), ((1, 3), 0), ((3, c), 0), ((1, c), 0), ((1, c), 1), ((1, c), 0),
        ((c, cs), 0), ((1, cs), 0), ((1, cs), 1), ((1, cs), 0), ((cs, cs), 0), ((1, cs), 0))]
    q, kv = t(rng.standard_normal((b, m, c))), t(rng.standard_normal((b, m, 2 * c)))
    rel, g = t(rng.standard_normal((b, m, k, 3))), t(rng.standard_normal((b, m, c)))
    starts = tile_gather.window_starts(m // tile, width)
    li = rng.integers(0, w_sz, (b, m, k)).astype(np.int32)
    li[:, :, 0] = (np.arange(m) - np.repeat(starts * tile, tile))[None]
    li[:, ::7, -1] = w_sz
    return (q, kv, rel, torch.as_tensor(li, device=dev),
            torch.as_tensor(starts, dtype=torch.int32, device=dev), tile, width, params, g)


def sweep(dev) -> None:
    build, cd, pa, tgm = import_package(ROOT)
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
    for c, m, k in ATTN_WIDTHS:
        q, kv, rel, li, st, tile, width, params, g = attn_inputs(rng, dev, c, m, k, tgm)
        b, cs = q.shape[0], c // SHARES
        ptrs = (ctypes.c_void_p * 12)(*(p.data_ptr() for p in params))
        dq, dkv = torch.empty_like(q), torch.zeros_like(kv)
        threads, plan = pa.bwd_threads(c), pa.bwd_plan(b, m, k, c)
        res, rows = [], threads // c
        while rows * k * c <= 4 * pa.BWD_TILE_FLOATS:
            smem = pa.bwd_smem(c, rows, k)
            if smem <= pa.SMEM_LIMIT:
                per_sm = min(2 if threads == 256 else 1, pa.SMEM_PER_SM // (smem + 1024))
                blocks = min(-(-b * m // rows), pa.SM_COUNT * per_sm)
                dp = torch.empty((blocks, sum(pa._prow(c, cs))), device=dev)
                fn = lambda: build.check(lib.cbl_pt_attn_bwd(
                    q.data_ptr(), kv.data_ptr(), rel.data_ptr(), li.data_ptr(), st.data_ptr(),
                    ctypes.cast(ptrs, ctypes.c_void_p), g.data_ptr(), dq.data_ptr(),
                    dkv.data_ptr(), dp.data_ptr(), b, m, k, c, tile, width, blocks, threads,
                    rows, smem, stream), "bwd")
                res.append(f"rows {rows} blocks {blocks}: {time_ms(fn, flush):.4f}")
            rows *= 2
        print(f"pt_attn_bwd C={c} M={m} K={k}, plan rows {plan.rows} blocks {plan.blocks}: "
              + ", ".join(res), flush=True)


def clocks(dev) -> None:
    _, _, pa, tgm = import_package(write_variant("phase_clocks"))
    rng = np.random.default_rng(0)
    for c, m, k in ATTN_WIDTHS:
        args = attn_inputs(rng, dev, c, m, k, tgm)
        b = args[0].shape[0]
        plan = pa.bwd_plan(b, m, k, c)
        pa.pt_attn_bwd(*args)
        grads = pa.pt_attn_bwd(*args)[2]
        torch.cuda.synchronize()
        # the wrapper sums the blocks' rows: the first 8 floats of dA1 | dc1
        cyc = torch.cat([grads[0].reshape(-1), grads[1].reshape(-1)])[:8].double().cpu().numpy()
        tiles = -(-b * m // plan.rows)
        tot = cyc.sum()
        print(f"pt_attn_bwd C={c} M={m} K={k} {tuple(plan)}: {tot / plan.blocks:.0f} cycles a "
              f"block, {tiles / plan.blocks:.2f} tiles a block; per tile "
              + ", ".join(f"{n} {v / tiles:.0f} ({v / tot:.0%})" for n, v in zip(PHASES, cyc)),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("sweep", "clocks", "variant"))
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
    (sweep if args.what == "sweep" else clocks)(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
