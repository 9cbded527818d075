"""Where the v2 CBL kernels' time goes (and v1's, which runs them), on the
calls of one impl='pallas' flagship train step (chip_smoke.py's setup, B=2
x N=65536 from the trained checkpoint), on one card.

    python3 scripts/diag_cbl_tile2.py profile [--reps 10]
    python3 scripts/diag_cbl_tile2.py clocks

from the repository root, on a machine with a CUDA card and nvcc.
- profile: each level's forward and backward (bare C entries, as
  scripts/ab_torch_kernels.py drives them) under torch.profiler, the device
  time of each kernel of the two entries, and of v1's two entries on that
  level's stage input ([soft labels | latents], the v2 backward's
  cotangent): its split and join beside v2's kernels; then each level's
  backward timed
  (L2 flushed, mean of --reps) with the scatter's rows a block swept over 16
  to 256 and the rows dealt to a block of pass 1 over 32 to 1024, beside the
  plan's (ops/cuda/cbl_tile2.py::bwd_plan), and the forward's rows dealt to
  a block likewise.
- clocks: a copy of csrc/cbl_tile2.cu and csrc/slot_scatter.cuh with
  clock64() phase marks, built beside the tree's library into a temporary
  directory under _local/: per masked row of the forward, the cycles to
  its slots' loads and distances, to its running max and terms, and to its
  end; per row of the backward's pass 1, to the loads and distances, to the
  coefficients (and their stores), and to dq; per block of the scatter, the
  cycles of its start, its compaction of the active rows, its scans, its
  adds (sorts included) and in all. Mean, median and max of each.
Prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import ab_torch_kernels as ab  # noqa: E402
import chip_smoke as cs  # noqa: E402
from contrastboundary_tpu_torch.kernels import build  # noqa: E402
from contrastboundary_tpu_torch.ops.cuda import cbl_tile as c1  # noqa: E402
from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2  # noqa: E402

# (file, text, replacement) of the phase marks; g_clk[row] holds a forward
# row's marks, g_clk[B·M + row] a backward row's, g_sclk[block] a scatter
# block's
CLOCKS = [
    ("slot_scatter.cuh", "namespace {\n\nconstexpr int kScatterMaxRows",
     "__device__ long long g_sclk[1 << 16][6];\nnamespace {\n\nconstexpr int kScatterMaxRows"),
    ("slot_scatter.cuh", "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n  const int splits",
     "  const long long c0 = clock64();\n  long long t_cmp = 0, t_add = 0, t_scan = 0;\n"
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n  const int splits"),
    ("slot_scatter.cuh", "  counts.cnt[tid] = 0;\n  __syncthreads();\n",
     "  counts.cnt[tid] = 0;\n  __syncthreads();\n  const long long c1 = clock64();\n"),
    ("slot_scatter.cuh", "  const auto add_hits = [&](int n) {\n",
     "  const auto add_hits = [&](int n) {\n    const long long ca = clock64();\n"),
    ("slot_scatter.cuh", "      return;\n", "      { t_add += clock64() - ca; return; }\n"),
    ("slot_scatter.cuh", "    __syncthreads();\n  };\n\n  int n_hits",
     "    __syncthreads();\n    t_add += clock64() - ca;\n  };\n\n  int n_hits"),
    ("slot_scatter.cuh", "      // the active rows of [q0, q1), ascending, into qlist",
     "      const long long cc = clock64();\n      // the active rows of [q0, q1), ascending, into qlist"),
    ("slot_scatter.cuh", "      // their slots v = i K + k, all loads of a chunk in flight\n",
     "      t_cmp += clock64() - cc;\n      const long long cs0 = clock64();\n"
     "      // their slots v = i K + k, all loads of a chunk in flight\n"),
    ("slot_scatter.cuh", "      add_hits(n_hits);  // before qlist is overwritten\n",
     "      t_scan += clock64() - cs0;\n      add_hits(n_hits);  // before qlist is overwritten\n"),
    ("slot_scatter.cuh", "                         __fadd_rn(d.z, a.z), __fadd_rn(d.w, a.w));\n  }\n}",
     "                         __fadd_rn(d.z, a.z), __fadd_rn(d.w, a.w));\n  }\n"
     "  if (ACTIVE && tid == 0) {\n    long long* o = g_sclk[blockIdx.y * gridDim.x + blockIdx.x];\n"
     "    o[0] = c1 - c0; o[1] = t_cmp; o[2] = t_scan; o[3] = t_add; o[4] = clock64() - c0; o[5] = 1;\n"
     "  }\n}"),
    ("cbl_tile2.cu", '#include "slot_scatter.cuh"\n',
     '#include "slot_scatter.cuh"\n__device__ long long g_clk[1 << 20][6];\n'
     'extern "C" int read_clk(long long* out, long long n, int scatter) {\n'
     '  return scatter ? (int)cudaMemcpyFromSymbol(out, g_sclk, n * 48)\n'
     '                 : (int)cudaMemcpyFromSymbol(out, g_clk, n * 48);\n}\n'
     'extern "C" int zero_clk() {\n  static long long z[1 << 20][6];\n'
     '  const int e = (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));\n'
     '  return e ? e : (int)cudaMemcpyToSymbol(g_sclk, z, sizeof(long long) * 6 * (1 << 16));\n}\n'),
    ("cbl_tile2.cu", "  float carry = kNeg;  // the running max over the slots before the chunk\n",
     "  const long long f0 = clock64();\n  long long f1 = 0, f2 = 0;\n"
     "  float carry = kNeg;  // the running max over the slots before the chunk\n"),
    ("cbl_tile2.cu", "                       sv, d, pos);\n    // this lane's counts",
     "                       sv, d, pos);\n    if (!f1) f1 = clock64() - f0;\n    // this lane's counts"),
    ("cbl_tile2.cu", "    // the sums in slot order, each slot's terms handed round\n",
     "    if (!f2) f2 = clock64() - f0;\n    // the sums in slot order, each slot's terms handed round\n"),
    ("cbl_tile2.cu", "  if (lane < 2) {\n    const float ratio",
     "  if (lane == 0) {\n    long long* o = g_clk[r];\n"
     "    o[0] = f1; o[1] = f2; o[2] = clock64() - f0; o[5] = 1;\n  }\n"
     "  if (lane < 2) {\n    const float ratio"),
    ("cbl_tile2.cu", "  const float4* f4 = reinterpret_cast<const float4*>(a.f);\n  float4 q4[CPL], acc[CPL];\n",
     "  const long long b0 = clock64();\n  long long b1 = 0, b2 = 0;\n"
     "  const float4* f4 = reinterpret_cast<const float4*>(a.f);\n  float4 q4[CPL], acc[CPL];\n"),
    ("cbl_tile2.cu", "                       d, pos);\n#pragma unroll\n    for (int j = 0; j < S; ++j) {\n      coef[j] = 0.f;",
     "                       d, pos);\n    if (!b1) b1 = clock64() - b0;\n#pragma unroll\n"
     "    for (int j = 0; j < S; ++j) {\n      coef[j] = 0.f;"),
    ("cbl_tile2.cu", "    // dq: the lanes over the channels, the slots in order\n",
     "    if (!b2) b2 = clock64() - b0;\n    // dq: the lanes over the channels, the slots in order\n"),
    ("cbl_tile2.cu", "  float4* dq = reinterpret_cast<float4*>(dx) + (long long)r * NV + lane;\n",
     "  if (lane == 0) {\n    long long* o = g_clk[a.rows + r];\n"
     "    o[0] = b1; o[1] = b2; o[2] = clock64() - b0; o[5] = 2;\n  }\n"
     "  float4* dq = reinterpret_cast<float4*>(dx) + (long long)r * NV + lane;\n"),
]


def entries(lib, fwd_call, bwd_call):
    """Bare forward and backward entries of one level on ``lib`` (the
    tree's signatures), with plan overrides: fwd(row_rows), bwd(row_rows,
    scatter_rows); and the operands kept alive."""
    features, meta, li, temperature, tile, width, window = fwd_call[0]
    b, m, c = features.shape
    k = li.shape[-1]
    stream = torch.cuda.current_stream(features.device).cuda_stream
    f, mt, lii = c2.v2_operands(features, meta, li, tile, width)
    plan = c2.bwd_plan(b, m, k, c, tile)
    stats = torch.empty((b, m, 8), device=f.device)
    st, g = bwd_call[0][3].contiguous(), bwd_call[0][4].contiguous()
    coef = torch.empty((b, m, k), device=f.device)
    lands = torch.empty((b, m, k), dtype=torch.int32, device=f.device)
    dx = torch.empty_like(f)
    dims = (b, m, k, plan.pass1.channels, tile, width, window, float(temperature))

    def fwd(row_rows=plan.pass1.row_rows):
        return lib.cbl_tile2_fwd(f.data_ptr(), mt.data_ptr(), lii.data_ptr(), stats.data_ptr(),
                                 *dims, plan.pass1.label_rows, row_rows, stream)

    def bwd(row_rows=plan.pass1.row_rows, scatter_rows=plan.scatter_rows):
        return lib.cbl_tile2_bwd(f.data_ptr(), mt.data_ptr(), lii.data_ptr(), st.data_ptr(),
                                 g.data_ptr(), coef.data_ptr(), lands.data_ptr(), dx.data_ptr(),
                                 *dims, row_rows, scatter_rows, stream)

    return fwd, bwd, plan, (f, mt, lii, stats, st, g, coef, lands, dx)


def levels(dev):
    """(forward call, backward call, stage input) of each level of one
    impl='pallas' step."""
    inputs = []
    calls = ab.record(dev, "batch", "pallas", inputs)
    by_rows = lambda call: -call[0][0].shape[1]
    fwd = sorted(calls["cbl_tile2_fwd"], key=by_rows)
    bwd = sorted(calls["cbl_tile2_bwd"], key=by_rows)
    return list(zip(fwd, bwd, sorted(inputs, key=lambda args: -args[0].shape[1])))


def device_times(fns, flush, reps) -> str:
    """Device time a launch of each kernel the entries ``fns`` launch, run
    reps times in turn after an L2 flush, under torch.profiler."""
    for fn in fns:
        build.check(fn(), "entry")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        name = re.search(r"(\w+_kernel)", e.key)
        if name and "elementwise" not in e.key:
            us = getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)
            kernels.append(f"{name.group(1)} {us / e.count:.1f} us")
    return ", ".join(kernels)


def v1_entries(stage, g):
    """v1's bare forward and backward entries (chip_smoke.bare_entry) on a
    level's stage input, the backward on the forward's statistics."""
    features, label_soft, li, temperature, tile, width, window = stage
    ncls = label_soft.shape[-1]
    fused = torch.cat([label_soft.float(), features.float()], -1).contiguous()
    args = (fused, li, ncls, temperature, tile, width, window)
    stats = c1.cbl_tile_fwd(*args)
    fwd = cs.bare_entry("cbl_tile_fwd", args, {})
    bwd = cs.bare_entry("cbl_tile_bwd", (fused, li, stats, g) + args[2:], {})
    return (lambda: fwd() or 0), (lambda: bwd() or 0)  # they check their own return codes


def profile(dev, calls, reps):
    lib = build.library()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    timed = lambda fn: cs.time_ms(lambda: build.check(fn(), "entry"), flush, reps)
    for fwd_call, bwd_call, stage in calls:
        fwd, bwd, plan, keep = entries(lib, fwd_call, bwd_call)
        m = fwd_call[0][0].shape[1]
        print(f"M={m}: device time a launch: {device_times((fwd, bwd), flush, reps)}", flush=True)
        v1 = v1_entries(stage, bwd_call[0][4])
        print(f"M={m}: v1 device time a launch: {device_times(v1, flush, reps)}", flush=True)
        del v1
        tile = fwd_call[0][4]
        sweep = {r: round(timed(lambda: bwd(scatter_rows=r)), 4)
                 for r in (16, 32, 64, 128, 256) if r <= tile}
        rows = sorted({32, 64, 128, 256, 512, 1024, plan.pass1.row_rows})
        bwd_rows = {r: round(timed(lambda: bwd(row_rows=r)), 4) for r in rows}
        fwd_rows = {r: round(timed(lambda: fwd(row_rows=r)), 4) for r in rows}
        print(f"M={m}: backward ms by scatter rows a block (plan {plan.scatter_rows}) {sweep}; by "
              f"rows dealt to a pass-1 block (plan {plan.pass1.row_rows}) {bwd_rows}; forward by "
              f"rows dealt to a block {fwd_rows}", flush=True)
        del keep


def clocks(dev, calls):
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "_local"))
    try:
        for name in build.SOURCES + build.HEADERS:
            if name in ("cbl_tile2.cu", "slot_scatter.cuh", "window_sort.cuh"):
                text = (build.CSRC / name).read_text()
                for f, a, b in CLOCKS:
                    if f == name:
                        if a not in text:
                            raise RuntimeError(f"clock mark not found in {name}: {a[:60]!r}")
                        text = text.replace(a, b, 1)
                (tmp / name).write_text(text)
        res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(tmp / "lib.so"),
                              str(tmp / "cbl_tile2.cu")], capture_output=True, text=True,
                             timeout=900)
        if res.returncode:
            raise RuntimeError(f"nvcc failed: {res.stderr[-3000:]}")
        lib = ctypes.CDLL(str(tmp / "lib.so"))
        for e in ("cbl_tile2_fwd", "cbl_tile2_bwd"):
            getattr(lib, e).argtypes = list(build.SIGNATURES[e])
        lib.read_clk.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
        flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
        stat = lambda a: f"mean {a.mean():.0f} median {np.median(a):.0f} max {a.max()}"
        for fwd_call, bwd_call, _ in calls:
            fwd, bwd, plan, keep = entries(lib, fwd_call, bwd_call)
            b, m = fwd_call[0][0].shape[:2]
            assert lib.zero_clk() == 0
            for fn in (fwd, bwd):
                flush.zero_()
                torch.cuda.synchronize()
                assert fn() == 0
                torch.cuda.synchronize()
            rows = np.zeros((2 * b * m, 6), np.int64)
            assert lib.read_clk(rows.ctypes.data, 2 * b * m, 0) == 0
            n_blocks = plan.scatter_grid[0] * plan.scatter_grid[1]
            blocks = np.zeros((n_blocks, 6), np.int64)
            assert lib.read_clk(blocks.ctypes.data, n_blocks, 1) == 0
            fw, bw = rows[:b * m][rows[:b * m, 5] == 1], rows[b * m:][rows[b * m:, 5] == 2]
            print(f"M={m}: forward, {len(fw)} masked rows, cycles to the loads and distances "
                  f"{stat(fw[:, 0])}, to the terms {stat(fw[:, 1])}, to the end {stat(fw[:, 2])}",
                  flush=True)
            print(f"M={m}: backward pass 1, {len(bw)} rows, to the loads and distances "
                  f"{stat(bw[:, 0])}, to the coefficients {stat(bw[:, 1])}, to the end (dq) "
                  f"{stat(bw[:, 2])}", flush=True)
            print(f"M={m}: scatter, {n_blocks} blocks, start {stat(blocks[:, 0])}, compaction "
                  f"{stat(blocks[:, 1])}, scans {stat(blocks[:, 2])}, adds {stat(blocks[:, 3])}, "
                  f"in all {stat(blocks[:, 4])}", flush=True)
            del keep
    finally:
        shutil.rmtree(tmp)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("profile", "clocks"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("diag_cbl_tile2: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}", flush=True)
    build.library()
    calls = levels(dev)  # a train step: outside no_grad
    with torch.no_grad():
        if args.what == "profile":
            profile(dev, calls, args.reps)
        else:
            clocks(dev, calls)
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
