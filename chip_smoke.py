"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

    python3 chip_smoke.py

from the repository root, on a machine with a CUDA card, nvcc and the
trained checkpoint results/ckpts/parity_s0_fast_e15.pkl. Phases, each
printed with its elapsed seconds; any failed check raises, so the exit code
is not 0:

1. build   the CUDA kernels (one nvcc call, contrastboundary_tpu_torch/_build/).
2. kernels window top-k and window gather against their plain PyTorch
           versions on the card, at every geometry of a B=2 x N=65536
           request: integer-grid clouds with duplicated rows (exact) and
           synthetic crops (values 1e-5, index disagreement <= 1e-4 of
           slots, which allows for near-ties); window top-k where no
           path takes it (k > W in the self and cross geometries,
           exclude_self), exact on the integer grid; and window gather
           directly at C in {1, 2, 3, 5, 35, 67, 131, 259, 1024} in the self
           and cross geometries, and from a misaligned x (the scalar-read
           path at C % 4 == 0), equal to the plain version.
3. serve   the trained flagship (full width, float32) on B=2 x N=65536
           crops of synthetic val room 0: one request with the launch counts
           reset just before and read just after (both must be > 0) and the
           running statistics untouched, three timed requests, and one with
           both kernels swapped for their plain versions (probs within 1e-3,
           argmax agreeing on >= 99.9% of points); crop overall accuracy
           must be >= 0.5.
4. timing  every kernel launch of that request replayed: kernel, plain
           version and one PyTorch library call, each with L2 flushed, beside
           its bound (bytes at 3.35 TB/s or FP32 operations at 67 TFLOP/s,
           the H100 SXM data sheet, whichever is larger); the largest
           window_topk call also 20 times through its wrapper and through
           its bare C entry.
5. profile the request split: pyramid alone and whole step (CUDA events),
           and one torch.profiler trace: device time by kernel and the
           device's busy share of the request.
6. voting  VotingEvaluator over room 0 for three requests.
7. stale-serve the same checkpoint in a bn_mode='stale' model, whose 18
           attention layers run the fused attention kernel: one request with
           the counts reset (pt_attn_fwd exactly 18), the running statistics
           untouched, three timed requests beside phase serve's median,
           probs against the plain versions' and against phase serve's
           batch-BN probs (eval-mode BN is the same function: 1e-3, argmax
           >= 99.9%), crop OA >= 0.5, three voting requests; each
           pt_attn_fwd launch against its plain version (1e-4 of scale, the
           same bits of out, s1 and s2 when run again), timed, and the times
           summed per width (C, M, K, launches, ms, bound).
8. train   the flagship train step (train/trainer.py::make_train_step: the
           training pyramid, the model in train mode, CE + 5-stage CBL,
           backward, SGD lr 0.05) from the checkpoint on B=2 x N=65536 crops
           of synthetic train rooms: one step with every launch count reset
           just before and read just after (all five kernels must be > 0; the
           searches wider than 2048 rows, plain PyTorch by the reference's
           width rule, are counted apart); one step with the kernels and one
           with the plain versions from the same weights and batch (loss rel
           <= 1e-4, global gradient norm rel <= 1e-3, running statistics rel
           <= 1e-4); five steps on that batch (every loss finite, the last
           below the first), the median of the three warm ones on the host
           clock, points/s and max_memory_allocated; one step under
           torch.profiler.
9. train-kernels every kernel call of that step against its plain version:
           window_topk and window_gather as in phase 2, window_gather_bwd
           max-abs <= 1e-5 of the output's scale (the plain version's
           index_add_ adds with atomics on the card), exact on integer
           cotangents, the same bits when run again, and bit-equal to the
           plain version on CPU copies (CPU index_add_ sums each row in slot
           order, as the kernel does), cbl_stats_fwd counts exact, sums rel
           <= 1e-5 and the same bits on every lane when run again,
           cbl_stats_bwd max-abs <= 1e-4 of the output's
           scale, the same bits when run again, and its first pass's slot
           coefficients cd within 1e-5 of their scale of the plain
           version's; the same on one step over integer-grid clouds. Then
           each call timed as in phase 4 (5 runs each), and the largest
           (level-0) window_topk, window_gather, window_gather_bwd,
           cbl_stats_fwd and cbl_stats_bwd calls 20 times through the wrapper
           and through the bare C entry.
10. stale-train phase 8 with bn_mode='stale': pt_attn_fwd and pt_attn_bwd
           exactly 18 launches each, window_gather and window_gather_bwd 18
           fewer than in phase 8 (the attention layers' gathers are inside
           the kernel), the same kernel-vs-plain, five-step, timing, memory
           and profile checks.
11. stale-kernels every pt_attn call of that step against its plain version
           (out, both statistic pairs, dq, dkv and each of the 12 parameter
           gradients within 1e-4 of scale; the forward's out, s1 and s2 the
           same bits when run again), and of one stale step on integer-grid
           clouds, whose backward calls also give dkv exactly on integer
           cotangents (with W4 = 0, so that the softmax weights are exact);
           then each call timed as in phase 4 (5 runs each), both kernels'
           times summed per width (C, M, K, launches, ms, bound), and the
           largest (level-0) call of each 20 times through the wrapper and
           through the bare C entry.

12. cbl-xla the flagship train step of phase 8 with CBL_DENSE=off and
           ContrastConfig(impl='xla'), the reference's XLA tile route: the
           label pack and the latents gathered by window_gather (its backward
           by window_gather_bwd), exactly 5 more launches of each than phase
           8 (one a stage) and none of a CBL kernel; kernel vs plain step,
           five steps, step time, memory and profile as in phase 8.
13. cbl-pallas the same with impl='pallas', the fused v2 kernel:
           cbl_tile2_fwd and cbl_tile2_bwd exactly 5 launches each (the
           backward reads the forward's statistics), the dense CBL kernels
           none, the gathers as in phase 8; the same step checks; and the CBL
           losses of one step of phases 8 and 13 against phase 12's on the
           same weights and batch, each stage within the tolerance the CPU
           tests state (dense 3e-5, v2 1e-5).
14. cbl-kernels every v2 call of phase 13's step against its plain version
           and timed: the forward's counts and mask exact on every row,
           lanes 0-2 and loss·mask within 1e-4 of scale on the rows of the
           mask and the fill (0, 0, 0; loss·mask 0) elsewhere, the same bits
           when run again; the backward within 1e-4 of scale, the same bits
           when run again, its pass-1 coefficients within 1e-5 of scale; the
           level-0 calls also 20 times alone for the spread of a launch's
           time, with the backward scatter's terms a support tile; v1
           (cbl_tile_fwd, cbl_tile_bwd), which no path runs,
           at that step's level-0 shape ([soft labels | latents], K = 35)
           against its plain version and against v2 on the same inputs;
           gather_rows, which no path runs either, equal to x[idx] at x
           [131072, 128] f32 with 131072 random rows, timed beside
           torch.index_select.
15. plan-shapes direct calls at shapes the reference trains beyond the
           flagship's, whose plans take smaller tiles or slot chunks, on
           seeded inputs: pt_attn_fwd and pt_attn_bwd at C = 512 with K = 8
           (M = 1024) and K = 32 and 48 (M = 256), held as in phase 11; and
           cbl_stats_fwd on windows wider than shared memory holds (width 7
           x tile 256 and width 3 x tile 1024, K = 36), read through L2 and
           held as in phase 9, with the L2 path at the flagship's level-0
           window equal bit for bit to the staged path; and cbl_tile2_fwd and
           cbl_tile2_bwd at every shape class the previous v2 kernels took
           (V2_SHAPES: C in {1, 20, 32, 33, 64, 128}, K in {1, 35, 300},
           M·K >= 2^23, tile x width 128 x 5 and 1024 x 1, every row and no
           row in the loss mask) held as in phase 14.

It prints the card's name and power limit, one JSON line of per-kernel
numbers (times are sums over the launches of one run of a path: the numbers
of the kernels a request runs, window_topk, window_gather and pt_attn_fwd,
are per serving request, with those of one train step under "train"; the
training kernels' numbers are per train step; v1 and gather_rows, which
no path runs, have the launches read from phase 13's step, which must be
0 as in every train run, and their direct calls under "direct_launches"),
and as its last line {"ok": true, "device": {...}}. Without CUDA it exits with 2
before doing anything.
"""
from __future__ import annotations

import copy
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
from contextlib import ExitStack, contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from contrastboundary_tpu_torch.data.synthetic import SyntheticSceneDataset, train_batch
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator
from contrastboundary_tpu_torch.kernels import build
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, load_checkpoint, load_jax_variables,
)
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.losses import contrast as cbl_losses
from contrastboundary_tpu_torch.ops import PyramidSpec, build_pyramid, knn
from contrastboundary_tpu_torch.ops.cuda import cbl_dense as cd
from contrastboundary_tpu_torch.ops.cuda import cbl_tile as c1
from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2
from contrastboundary_tpu_torch.ops.cuda import gather_dma as gd
from contrastboundary_tpu_torch.ops.cuda import pt_attn as pa
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from contrastboundary_tpu_torch.ops.cuda import win_topk as wt
from contrastboundary_tpu_torch.ops.tile_gather import window_starts
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step

ROOT = Path(__file__).resolve().parent
CKPT = ROOT / "results" / "ckpts" / "parity_s0_fast_e15.pkl"
B, N, NUM_CLASSES = 2, 65536, 13
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM, CUDA cores, no tensor cores
KERNELS = {
    "window_topk": dict(
        source="contrastboundary_tpu_torch/csrc/win_topk.cu",
        replaces="contrastboundary_tpu/ops/pallas/win_topk.py:157",
    ),
    "window_gather": dict(
        source="contrastboundary_tpu_torch/csrc/tile_gather.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:120",
    ),
    "window_gather_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/window_gather_bwd.cu",
        replaces="contrastboundary_tpu/ops/pallas/tile_gather_pl.py:156",
    ),
    "cbl_stats_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_dense.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_dense.py:247",
    ),
    "cbl_stats_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_dense.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_dense.py:272",
    ),
    "pt_attn_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:406",
    ),
    "pt_attn_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/pt_attn.cu",
        replaces="contrastboundary_tpu/ops/pallas/pt_attn.py:830",
    ),
    "cbl_tile2_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile2.py:317",
    ),
    "cbl_tile2_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile2.py:350",
    ),
    "cbl_tile_fwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile.py:233",
    ),
    "cbl_tile_bwd": dict(
        source="contrastboundary_tpu_torch/csrc/cbl_tile2.cu",
        replaces="contrastboundary_tpu/ops/pallas/cbl_tile.py:259",
    ),
    "gather_rows": dict(
        source="contrastboundary_tpu_torch/csrc/gather_rows.cu",
        replaces="contrastboundary_tpu/ops/pallas/gather_dma.py:52",
    ),
}
# each kernel's wrapper (module, attribute) and its plain version
WRAPPERS = {
    "window_topk": (wt, "window_topk", wt.window_topk_plain),
    "window_gather": (tg, "window_gather", tg.window_gather_plain),
    "window_gather_bwd": (tg, "window_gather_bwd", tg.window_gather_bwd_plain),
    "cbl_stats_fwd": (cd, "cbl_stats_fwd", cd.cbl_stats_fwd_plain),
    "cbl_stats_bwd": (cd, "cbl_stats_bwd", cd.cbl_stats_bwd_plain),
    "pt_attn_fwd": (pa, "pt_attn_fwd", pa.pt_attn_plain),
    "pt_attn_bwd": (pa, "pt_attn_bwd", pa.pt_attn_bwd_plain),
    "cbl_tile2_fwd": (c2, "cbl_tile2_fwd", c2.cbl_tile2_fwd_plain),
    "cbl_tile2_bwd": (c2, "cbl_tile2_bwd", c2.cbl_tile2_bwd_plain),
    "cbl_tile_fwd": (c1, "cbl_tile_fwd", c1.cbl_tile_fwd_plain),
    "cbl_tile_bwd": (c1, "cbl_tile_bwd", c1.cbl_tile_bwd_plain),
    "gather_rows": (gd, "gather_rows", gd.gather_rows_plain),
}
SERVE_KERNELS = ("window_topk", "window_gather")
PATH_KERNELS = ("window_topk", "window_gather", "window_gather_bwd")
# the train step's CBL routes (losses/contrast.py): CBL_DENSE, ContrastConfig.impl
# and the CBL kernels each launches (the XLA tile route only adds gathers)
CBL_ROUTES = {
    "dense": (None, "xla", ("cbl_stats_fwd", "cbl_stats_bwd")),
    "xla": ("off", "xla", ()),
    "pallas": ("off", "pallas", ("cbl_tile2_fwd", "cbl_tile2_bwd")),
}
CBL_KERNELS = ("cbl_stats_fwd", "cbl_stats_bwd", "cbl_tile2_fwd", "cbl_tile2_bwd")
# kernels no path runs (as in the reference): every train run reads 0 of them
NO_PATH_KERNELS = ("cbl_tile_fwd", "cbl_tile_bwd", "gather_rows")
TRAIN_KERNELS = PATH_KERNELS + CBL_ROUTES["dense"][2]
STALE_SERVE_KERNELS = SERVE_KERNELS + ("pt_attn_fwd",)
STAGES = 5  # CBL stages of the flagship, one launch of each CBL kernel a stage
# the tolerances the CPU tests state between the routes' stage losses:
# dense against the XLA tile route (tests/test_torch_cbl.py), v2 against it
# (tests/test_torch_cbl_routes.py)
ROUTE_RTOL = {"dense": 3e-5, "pallas": 1e-5}
# attention layers of the flagship: 13 encoder blocks (blocks (2, 3, 4, 6, 3)
# less one transition a level) and 5 decoder blocks
ATTENTION_LAYERS = 18
TRAIN_SPEC = PyramidSpec(k_contrast=(36, 24, 24, 24, 24), with_subscene=True)
TRAIN_LR = 0.05


def require(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


@contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[phase] {name} ...", flush=True)
    yield
    print(f"[phase] {name} ok {time.perf_counter() - t0:.3f} s", flush=True)


@contextmanager
def cbl_route_env(route: str):
    """The environment that selects a CBL route: CBL_DENSE as CBL_ROUTES
    gives it, unset for None."""
    value = CBL_ROUTES[route][0]
    with mock.patch.dict(os.environ):
        if value is None:
            os.environ.pop("CBL_DENSE", None)
        else:
            os.environ["CBL_DENSE"] = value
        yield


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def frozen(x):
    """A copy of a call's tensor arguments (the attention layer passes views
    of weights that the optimizer then updates in place)."""
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    if isinstance(x, (tuple, list)):
        return type(x)(frozen(v) for v in x)
    return x


@contextmanager
def recording():
    """Record every call (arguments as they were and the kernel's outputs)
    of the kernel wrappers made through the ops modules while active."""
    calls = {name: [] for name in WRAPPERS}
    with ExitStack() as stack:
        for name, (mod, attr, _) in WRAPPERS.items():
            def rec(*args, _fn=getattr(mod, attr), _name=name, **kw):
                out = _fn(*args, **kw)
                calls[_name].append((frozen(args), kw, out))
                return out
            stack.enter_context(mock.patch.object(mod, attr, rec))
        yield calls


@contextmanager
def plain_kernels():
    """Swap every kernel for its plain PyTorch version."""
    with ExitStack() as stack:
        for mod, attr, plain in WRAPPERS.values():
            stack.enter_context(mock.patch.object(mod, attr, plain))
        yield


def reset_counts():
    wt.launches = tg.launches = tg.bwd_launches = 0
    cd.fwd_launches = cd.bwd_launches = 0
    pa.fwd_launches = pa.bwd_launches = 0
    c2.fwd_launches = c2.bwd_launches = c1.fwd_launches = c1.bwd_launches = 0
    gd.launches = 0
    knn.wide_calls = 0


def read_counts() -> dict:
    return {"window_topk": wt.launches, "window_gather": tg.launches,
            "window_gather_bwd": tg.bwd_launches, "cbl_stats_fwd": cd.fwd_launches,
            "cbl_stats_bwd": cd.bwd_launches, "pt_attn_fwd": pa.fwd_launches,
            "pt_attn_bwd": pa.bwd_launches, "cbl_tile2_fwd": c2.fwd_launches,
            "cbl_tile2_bwd": c2.bwd_launches, "cbl_tile_fwd": c1.fwd_launches,
            "cbl_tile_bwd": c1.bwd_launches, "gather_rows": gd.launches}


def grid_cloud(rng, b, n, side=64):
    """Integer-grid cloud with duplicated rows: every distance is exact."""
    p = rng.integers(0, side, (b, n, 3)).astype(np.float32)
    for bb in range(b):
        p[bb, rng.integers(0, n, n // 8)] = p[bb, rng.integers(0, n, n // 8)]
    return p


def compare_topk(call, exact: bool) -> float:
    """Kernel output of a recorded call against the plain version."""
    (query, support, k), kw, (idx, val) = call
    p_idx, p_val = wt.window_topk_plain(query, support, k, **kw)
    err = float((val - p_val).abs().nan_to_num(0.0).max())
    same_inf = bool(torch.equal(torch.isinf(val), torch.isinf(p_val)))
    mismatch = float((idx != p_idx).float().mean())
    what = f"window_topk k={k} {kw}: max|dv|={err:.3g}, idx mismatch {mismatch:.3g}"
    if exact:
        require(torch.equal(idx, p_idx) and torch.equal(val, p_val), what)
    else:
        require(same_inf and err <= 1e-5 and mismatch <= 1e-4, what)
    return err


def compare_gather(call) -> float:
    args, _, out = call
    ref = tg.window_gather_plain(*args)
    require(torch.equal(out, ref), f"window_gather {tuple(out.shape)} differs")
    return 0.0


def compare_scaled(name, got, ref, tol) -> float:
    """max|got − ref| within ``tol`` of max|ref| (the output's scale)."""
    err = float((got - ref).abs().max()) if got.numel() else 0.0
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    require(err <= tol * scale, f"{name} {tuple(got.shape)}: max|d|={err:.3g}, scale {scale:.3g}")
    return err


def compare_gather_bwd(call) -> float:
    """Against the plain version on the card, whose index_add_ adds with
    atomics in no fixed order: 1e-5 of the output's scale, and exact on
    integer-valued cotangents at the same geometry (small integers sum
    exactly in any order). The kernel sums each row in slot order without
    atomics: the call run again gives the same bits, and so does the plain
    version on CPU copies (CPU index_add_ adds in index order)."""
    (g, li, starts, tile, width, ns), _, out = call
    what = f"window_gather_bwd {tuple(g.shape)}"
    err = compare_scaled("window_gather_bwd", out, tg.window_gather_bwd_plain(*call[0]), 1e-5)
    g_int = torch.randint_like(g, -3, 4)
    require(torch.equal(tg.window_gather_bwd(g_int, li, starts, tile, width, ns),
                        tg.window_gather_bwd_plain(g_int, li, starts, tile, width, ns)),
            f"{what} not exact on integer cotangents")
    bits = lambda t: t.cpu().view(torch.int32)
    require(torch.equal(bits(tg.window_gather_bwd(*call[0])), bits(out)), f"{what} differs between runs")
    cpu = tg.window_gather_bwd_plain(g.cpu(), li.cpu(), starts.cpu(), tile, width, ns)
    require(torch.equal(bits(cpu), bits(out)), f"{what} is not the plain version's CPU sum bit for bit")
    return err


def compare_stats_fwd(call) -> float:
    """Counts exact, the rest rel 1e-5 (the same arithmetic; exp and the
    sums over slots may round differently); the call run again gives the
    same bits on every lane (lane 0, m̂, is what the backward reads)."""
    args, _, out = call
    out = out.detach()
    ref = cd.cbl_stats_fwd_plain(*args)
    require(torch.equal(out[..., 3:], ref[..., 3:]), f"cbl_stats_fwd {tuple(out.shape)}: counts differ")
    err = float((out[..., :3] - ref[..., :3]).abs().max())
    require(bool(torch.allclose(out[..., :3], ref[..., :3], rtol=1e-5, atol=1e-7)),
            f"cbl_stats_fwd {tuple(out.shape)}: max|d|={err:.3g}")
    again = cd.cbl_stats_fwd(*args)
    require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
            f"cbl_stats_fwd {tuple(out.shape)}: differs between runs")
    return err


def compare_stats_bwd(call) -> float:
    """Against the plain version (1e-4 of the output's scale: the sums
    over a row's slots meet in another order, and the plain version's
    index_add_ adds with atomics on the card); the call run again gives the
    same bits (no atomics); the first pass's slot coefficients cd within
    1e-5 of their scale of the plain version's (the same roundings; exp may
    round otherwise)."""
    args, _, out = call
    what = f"cbl_stats_bwd {tuple(out.shape)}"
    err = compare_scaled(what, out, cd.cbl_stats_bwd_plain(*args), 1e-4)
    again, coef = cd.cbl_stats_bwd_passes(*args)
    bits = lambda t: t.cpu().view(torch.int32)
    require(torch.equal(bits(again), bits(out)), f"{what} differs between runs")
    compare_scaled(f"{what} pass-1 cd", coef, cd.cbl_bwd_cd_plain(*args)[0], 1e-5)
    return err


def compare_pt_attn_fwd(call) -> float:
    """out and both statistic pairs within 1e-4 of their scale (the kernel
    sums over slots and blocks in another order, and rounds exp otherwise);
    the call run again gives the same bits of all three (no atomics, the
    blocks' partial rows summed in order)."""
    args, _, got = call
    got = [t.detach() for t in got]
    ref = pa.pt_attn_plain(*args)
    again = pa.pt_attn_fwd(*args)
    err = 0.0
    for what, a, r, a2 in zip(("out", "s1", "s2"), got, ref, again):
        name = f"pt_attn_fwd {what} {tuple(a.shape)}"
        err = max(err, compare_scaled(name, a, r, 1e-4))
        require(torch.equal(a.view(torch.int32), a2.view(torch.int32)), f"{name} differs between runs")
    return err


PT_GRADS = ("dq", "dkv", "dA1", "dc1", "dW2", "db2", "dg1", "dh1", "dW3", "db3", "dg2", "dh2",
            "dW4", "db4")


def compare_pt_attn_bwd(call) -> float:
    """dq, dkv and the 12 parameter gradients within 1e-4 of their scale.
    db4 is zero in exact arithmetic (b4 shifts every slot's score alike,
    which a softmax ignores), so both values are rounding noise: it is held
    to 1e-4 of dW4's scale."""
    args, _, (dq, dkv, grads) = call
    r_dq, r_dkv, r_grads = pa.pt_attn_bwd_plain(*args)
    got, ref = (dq, dkv, *grads), (r_dq, r_dkv, *r_grads)
    err = 0.0
    for name, a, b in zip(PT_GRADS, got, ref):
        scale_of = ref[PT_GRADS.index("dW4")] if name == "db4" else b
        e = float((a - b).abs().max())
        require(e <= 1e-4 * float(scale_of.abs().max()),
                f"pt_attn_bwd {name} {tuple(a.shape)}: max|d|={e:.3g}, scale {float(scale_of.abs().max()):.3g}")
        err = max(err, e)
    return err


def check_pt_attn_bwd_exact(call):
    """dkv exact on integer-valued cotangents: with W4 = 0 every score is
    b4, so att = 1/K and d(v + pe) = g/K are exact dyadic numbers, and the
    atomics' sums of them are exact in any order (dk is then exactly 0)."""
    (q, kv, rel, li, starts, tile, width, params, g), _, _ = call
    ps = list(params)
    ps[10] = torch.zeros_like(ps[10])
    g_int = torch.randint_like(g, -3, 4)
    dkv = pa.pt_attn_bwd(q, kv, rel, li, starts, tile, width, ps, g_int)[1]
    ref = pa.pt_attn_bwd_plain(q, kv, rel, li, starts, tile, width, ps, g_int)[1]
    require(torch.equal(dkv, ref), f"pt_attn_bwd dkv {tuple(dkv.shape)} not exact on integer cotangents")


def compare_tile_stats(name, call) -> float:
    """Per-row statistics of a CBL tile kernel call against its plain
    version: the counts and the mask exact on every row, the max, the sums
    and loss·mask within 1e-4 of each lane's scale (the distances are
    rounded in one order on both sides; exp and log may round otherwise on
    the card). v2 computes the max and the sums (lanes 0-2) only on the rows
    of the mask: there they are held so, elsewhere they must be the fill
    (0, 0, 0) with lane 5 zero; lane 7 is 0; the call run again gives the
    same bits on every lane."""
    args, kw, out = call
    ref = WRAPPERS[name][2](*args, **kw)
    exact = [3, 4, 6]
    require(torch.equal(out[..., exact], ref[..., exact]),
            f"{name} {tuple(out.shape)}: counts or mask differ")
    if name == "cbl_tile_fwd":
        return max(compare_scaled(f"{name} lane {i}", out[..., i], ref[..., i], 1e-4)
                   for i in (0, 1, 2, 5))
    mask = out[..., 6] > 0
    require(not out[~mask][:, [0, 1, 2, 5]].any() and not out[..., 7].any(),
            f"{name} {tuple(out.shape)}: not the fill outside the mask")
    again = WRAPPERS[name][0].cbl_tile2_fwd(*args, **kw)
    require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
            f"{name} {tuple(out.shape)}: differs between runs")
    return max(compare_scaled(f"{name} lane {i} (masked rows)", out[mask][:, i], ref[mask][:, i],
                              1e-4) for i in (0, 1, 2, 5))


def compare_tile_grad(name, call) -> float:
    """A CBL tile backward call against its plain version: 1e-4 of the
    output's scale (the sums meet in another order, and the plain version's
    index_add_ adds with atomics on the card); v1's label columns zero. v2
    has no atomics: the call run again gives the same bits; and its first
    pass's slot coefficients, on the rows it serves, are within 1e-5 of
    their scale of the plain version's (the same roundings; exp may round
    otherwise)."""
    args, kw, out = call
    if name == "cbl_tile_bwd":
        require(not out[..., :args[4]].any(), "cbl_tile_bwd: a label column has a gradient")
    else:
        again, coef = c2.cbl_tile2_bwd_passes(*args, **kw)
        require(torch.equal(again.view(torch.int32), out.view(torch.int32)),
                f"{name} {tuple(out.shape)}: differs between runs")
        features, meta, li, stats, g = args[:5]
        served = (stats[..., 6] != 0) & (g[:, None] != 0)  # pass 1 writes their slots
        ref = c2.grad_coefs_plain(features, meta[..., 0], meta[..., 1], li, stats, g,
                                  *args[5:])[0]
        compare_scaled(f"{name} {tuple(out.shape)} pass-1 coef", coef[served], ref[served], 1e-5)
    return compare_scaled(name, out, WRAPPERS[name][2](*args, **kw), 1e-4)


def compare_call(name, call, exact_topk=False) -> float:
    if name in ("cbl_tile2_fwd", "cbl_tile_fwd"):
        return compare_tile_stats(name, call)
    if name in ("cbl_tile2_bwd", "cbl_tile_bwd"):
        return compare_tile_grad(name, call)
    if name == "gather_rows":
        args, _, out = call
        require(torch.equal(out, gd.gather_rows_plain(*args)), "gather_rows differs")
        return 0.0
    if name == "pt_attn_fwd":
        return compare_pt_attn_fwd(call)
    if name == "pt_attn_bwd":
        return compare_pt_attn_bwd(call)
    if name == "window_topk":
        return compare_topk(call, exact_topk)
    if name == "window_gather":
        return compare_gather(call)
    if name == "window_gather_bwd":
        return compare_gather_bwd(call)
    if name == "cbl_stats_fwd":
        return compare_stats_fwd(call)
    return compare_stats_bwd(call)


def check_kernels(dev, points_sets) -> float:
    """Phase 2: every kernel call of the eval pyramid of each cloud."""
    err = 0.0
    spec = PyramidSpec()
    for name, pts, exact in points_sets:
        with recording() as calls:
            build_pyramid(torch.as_tensor(pts, device=dev), spec)
        for c in calls["window_topk"]:
            err = max(err, compare_topk(c, exact))
        for c in calls["window_gather"]:
            err = max(err, compare_gather(c))
        print(f"  {name}: {len(calls['window_topk'])} window_topk and "
              f"{len(calls['window_gather'])} window_gather calls agree "
              f"({'exact' if exact else 'tolerance'})", flush=True)
    return err


def check_topk_modes(dev, pts) -> float:
    """window_topk where no eval or train geometry takes it (the train and
    serve paths use the plain and ensure_self modes with k <= W): k > W in
    the self and cross geometries, and exclude_self with k <= W and k > W,
    on an integer-grid cloud, held to exact equality."""
    p = torch.as_tensor(pts, device=dev)
    small = p[:, :2048].contiguous()
    cases = (
        ("exclude_self", p, p, 16, dict(tile=256, width=3, window=1)),
        ("plain", small, small, 12, dict(tile=8, width=1, window=0)),
        ("exclude_self", small, small, 12, dict(tile=8, width=1, window=0)),
        ("plain", p[:, ::4].contiguous(), p, 300, dict(tile=256, width=1, window=0)),
    )
    for mode, query, support, k, geo in cases:
        kw = dict(geo, mode=mode)
        out = wt.window_topk(query, support, k, **kw)
        compare_topk(((query, support, k), kw, out), exact=True)
        print(f"  window_topk mode={mode} k={k} W={geo['tile'] * geo['width']} "
              f"M={query.shape[1]} Ns={support.shape[1]}: equal to the plain version", flush=True)
    return 0.0


GATHER_WIDTHS = (1, 2, 3, 5, 35, 67, 131, 259, 1024)


def check_gather_widths(dev) -> float:
    """window_gather at the widths of GATHER_WIDTHS, in the self geometry
    (tile 256, width 3, K 16) and the cross one (16384 queries on 65536
    support rows, width 6, K 3), with repeated and shadow slots, and at C =
    1024 from an x that is not 16-byte aligned (the scalar-read path at C %
    4 == 0): each equal to the plain version."""
    rng = np.random.default_rng(6)
    tile = 256
    cases = []
    for c in GATHER_WIDTHS:
        for m, ns, k, width, window in ((4096, 4096, 16, 3, 1), (16384, 65536, 3, 6, 1)):
            if c == 1024 and ns == 65536:
                continue  # 2 GB of output; the self case covers the width
            cases.append((c, m, ns, k, width, window, 0))
    cases.append((1024, 4096, 4096, 16, 3, 1, 1))
    for c, m, ns, k, width, window, shift in cases:
        buf = torch.as_tensor(rng.standard_normal(B * ns * c + shift, dtype=np.float32), device=dev)
        x = buf[shift:].view(B, ns, c)
        w_sz = width * tile
        li = rng.integers(0, w_sz + 1, (B, m, k)).astype(np.int32)
        li[:, ::7, -1] = w_sz  # shadow slots
        starts = wt.window_start_tiles(m // tile, ns // tile, width, window)
        li_t = torch.as_tensor(li, device=dev)
        st = torch.as_tensor(starts, dtype=torch.int32, device=dev)
        out = tg.window_gather(x, li_t, st, tile, width)
        compare_gather(((x, li_t, st, tile, width), {}, out))
        plan = tg.gather_plan(B * m * k, c, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        print(f"  window_gather C={c} x {tuple(x.shape)}{' misaligned' if shift else ''} idx "
              f"{tuple(li.shape)} W={w_sz} {plan}: equal to the plain version", flush=True)
    return 0.0


def random_flax_tree(model, seed: int) -> dict:
    """Seeded random weights as a flax tree for the converter (used only when
    the checkpoint file is absent)."""
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, v in model.state_dict().items():
        *path, leaf = key.split(".")
        mod = model.get_submodule(".".join(path))
        shape = tuple(v.shape)
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", "mean" if leaf == "running_mean" else "var"
            a = rng.random(shape) + 0.5 if name == "var" else 0.1 * rng.standard_normal(shape)
        elif leaf == "weight" and isinstance(mod, torch.nn.Linear):
            coll, name = "params", "kernel"
            a = rng.standard_normal(shape[::-1]) / np.sqrt(shape[1])
        else:
            coll, name = "params", "scale" if leaf == "weight" else "bias"
            a = 1.0 + 0.1 * rng.standard_normal(shape) if name == "scale" else 0.1 * rng.standard_normal(shape)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = a.astype(np.float32)
    return tree


def load_model(bn_mode="batch"):
    model = PointTransformerSeg(num_classes=NUM_CLASSES, bn_mode=bn_mode)
    if CKPT.exists():
        return load_jax_variables(model, load_checkpoint(str(CKPT))), True
    print(f"checkpoint {CKPT} is absent: seeded random weights, no accuracy floor",
          flush=True)
    return load_jax_variables(model, random_flax_tree(model, 0)), False


def room0(seed=0):
    return SyntheticSceneDataset(num_rooms=1, points_per_room=120_000, seed=seed, split="val")


def time_ms(fn, flush_buf=None, reps=10) -> float:
    """Mean device time of fn over reps runs (CUDA events), each after an L2
    flush when flush_buf is given."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush_buf is not None:
            flush_buf.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def topk_library_call(query, support, k, *, tile, width, window, mode="plain"):
    """torch.topk over the window distance tensor (built outside the timed
    call): the library yardstick, which leaves out the distances."""
    b, m, _ = query.shape
    gq, gs = m // tile, support.shape[1] // tile
    starts = torch.as_tensor(wt.window_start_tiles(gq, gs, width, window), device=query.device)
    cols = starts[:, None] + torch.arange(width, device=query.device)[None, :]
    win = support.reshape(b, gs, tile, 3)[:, cols].reshape(b, gq, width * tile, 3)
    neg = -torch.cdist(query.reshape(b, gq, tile, 3), win).square()
    kk = min(k, width * tile)
    return lambda: torch.topk(neg, kk, dim=-1)


def gather_library_call(x, local_idx, starts, tile, width):
    """x[b, rows] advanced indexing with the global rows built outside the
    timed call (shadow rows read row 0 instead of zeros)."""
    row0 = torch.repeat_interleave(starts.long() * tile, tile)
    rows = (row0[None, :, None] + local_idx.long()).clamp_max(x.shape[1] - 1)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None, None]
    return lambda: x[bidx, rows]


def gather_bwd_library_call(g, local_idx, starts, tile, width, n_support):
    """index_add_ of g's rows onto zeros with the global rows built outside
    the timed call (shadow slots add onto row 0 instead of nothing)."""
    b, m, k, c = g.shape
    row0 = torch.repeat_interleave(starts.long() * tile, tile)
    rows = (row0[None, :, None] + local_idx.long()).clamp_max(n_support - 1)
    rows = (rows + torch.arange(b, device=g.device)[:, None, None] * n_support).reshape(-1)
    src = g.reshape(-1, c)
    return lambda: torch.zeros(b * n_support, c, device=g.device).index_add_(0, rows, src)


def tile_costs(name, args, out):
    """(bytes, FP32 operations, shape) that a CBL tile kernel call's function
    needs on this call's data. Every row's li and label (v2: meta lanes 0
    and 1; v1: its ncls label columns) decide the slot counts and so the
    loss mask. Only the rows of the mask (in the backward: with a cotangent
    != 0) need their features, the labels and features of the rows their
    slots name (features of the valid ones), the distances and the sums.
    The forward's outputs are the two [B] sums (not the statistics it keeps
    for the backward); the backward reads every row's statistics and writes
    its whole gradient. Operations: a label's argmax and sum 2·ncls a row
    (v1), 4 a valid slot for the counts; per valid slot of a masked row the
    distance 3C + 2 and the max, exp and sums ~26 forward, ~6C + 70
    backward."""
    v1, fwd = name.startswith("cbl_tile_"), name.endswith("fwd")
    x, li = (args[0], args[1]) if v1 else (args[0], args[2])
    ncls = (args[2] if fwd else args[4]) if v1 else 0
    tile, width, window = args[-3:]
    b, m, k = li.shape
    c = x.shape[-1] - ncls
    valid = x[..., :ncls].sum(-1) > 0 if v1 else args[1][..., 1] > 0
    stats = out if fwd else args[2] if v1 else args[3]
    mask = stats[..., 6] > 0
    if not fwd:
        mask &= (args[3] if v1 else args[4])[:, None] != 0
    starts = torch.as_tensor(cd.self_window_starts(m, tile, width, window), device=x.device)
    rows, member = tg._rows(li, starts, tile, width, m)
    slot_ok = member & valid.reshape(-1)[rows]
    m_rows, m_member, m_ok = rows[mask], member[mask], slot_ok[mask]
    q_rows = torch.nonzero(mask.reshape(-1)).squeeze(1)
    named = int(torch.unique(torch.cat([q_rows, m_rows[m_member]])).numel())
    need = int(torch.unique(torch.cat([q_rows, m_rows[m_ok]])).numel())
    n_mask, n_masked_slots = int(mask.sum()), float(m_ok.sum())
    label_bytes = 4 * ncls if v1 else 8
    if fwd:
        n_bytes = b * m * (4 * k + label_bytes) + 4 * c * need + 8 * b
        n_ops = b * m * 2 * ncls + 4 * float(slot_ok.sum()) + n_masked_slots * (3 * c + 28)
    else:
        n_bytes = (b * m * (32 + 4 * x.shape[-1]) + 4 * b + 4 * k * n_mask
                   + label_bytes * named + 4 * c * need)
        n_ops = named * 2 * ncls + n_masked_slots * (6 * c + 70)
    shape = dict(rows=list(x.shape), K=k, ncls=ncls, masked_rows=n_mask,
                 masked_valid_slots=int(n_masked_slots), rows_read=need)
    return float(n_bytes), float(n_ops), shape


def attn_slot_ops(c: int, cs: int) -> tuple:
    """FP32 operations a slot-row of the fused attention needs, (forward,
    backward), counted from the plain versions: a product over n inputs is
    2n with its bias add, a ReLU or mask 1 an element.
    Forward: the PE tower 21 + 6C; w_pre and the bn1 affine 4C, ReLU C; fc1
    2C·Cs; the bn2 affine and ReLU 3Cs; fc2 2Cs²; the softmax over the
    slots 5Cs (max, subtract, exp, sum, divide) on the Cs weight channels;
    Σ att·(v + pe) 3C; the statistics 3C + 3Cs.
    Backward: the forward up to the softmax again; g·(v + pe) and dalpha
    3C, S and dw4 4Cs, dvpe C; dW4 and dc_ 4Cs² + Cs, db4 Cs; dg2, dh2 and
    dbv 4Cs; dW3 and db3 2C·Cs + Cs; da 2C·Cs + C; dg1, dh1 and dw_pre 4C;
    dq C; dk|dv 2C; dpe C; dW2 and db2 7C; dr_pe 6C + 3; dA1 and dc1 21."""
    fwd = 21 + 17 * c + 2 * c * cs + 2 * cs * cs + 11 * cs
    bwd = 45 + 37 * c + 6 * c * cs + 6 * cs * cs + 19 * cs
    return fwd, bwd


def call_costs(name, call):
    """(kernel fn, plain fn, library fn or None, bytes, operations, shape)
    of one recorded call."""
    args, kw, out = call
    mod, attr, plain_fn = WRAPPERS[name]
    kern = lambda: getattr(mod, attr)(*args, **kw)
    plain = lambda: plain_fn(*args, **kw)
    if name == "window_topk":
        query, support, k = args
        b, m, _ = query.shape
        w_sz = kw["width"] * kw["tile"]
        n_bytes = 4 * (query.numel() + support.numel()) + 8 * b * m * k
        n_ops = 10.0 * b * m * w_sz  # 9 FLOPs of distance + 1 compare a pair
        shape = dict(k=k, B=b, M=m, Ns=support.shape[1], W=w_sz, mode=kw.get("mode", "plain"))
        return kern, plain, topk_library_call(query, support, k, **kw), n_bytes, n_ops, shape
    if name == "window_gather":
        x, li, starts, tile, width = args
        n_bytes = 4 * (x.numel() + li.numel() + starts.numel() + out.numel())
        shape = dict(x=list(x.shape), idx=list(li.shape), W=tile * width)
        return kern, plain, gather_library_call(*args), n_bytes, 0.0, shape
    if name == "window_gather_bwd":
        g, li, starts, tile, width, ns = args
        n_bytes = 4 * (g.numel() + li.numel() + starts.numel() + out.numel())
        shape = dict(g=list(g.shape), Ns=ns, W=tile * width)
        return kern, plain, gather_bwd_library_call(*args), n_bytes, float(g.numel()), shape
    if name in ("cbl_tile2_fwd", "cbl_tile2_bwd", "cbl_tile_fwd", "cbl_tile_bwd"):
        n_bytes, n_ops, shape = tile_costs(name, args, out)
        return kern, plain, None, n_bytes, n_ops, shape
    if name == "gather_rows":
        # idx read once, the distinct rows it names read once, out written once
        x, idx = args[:2]
        rows = int(torch.unique(idx).numel())
        n_bytes = 4 * idx.numel() + x.element_size() * x.shape[1] * (rows + idx.numel())
        idx_long = idx.long()
        shape = dict(x=list(x.shape), M=idx.numel(), distinct_rows=rows)
        return (kern, plain, lambda: torch.index_select(x, 0, idx_long), n_bytes, 0.0,
                shape)
    if name in ("pt_attn_fwd", "pt_attn_bwd"):
        # inputs read once, outputs written once; FP32 operations of the
        # plain versions' slot-rows (attn_slot_ops)
        q, kv, rel, li, starts, tile, width, params = args[:8]
        b, m, c = q.shape
        k, cs = li.shape[-1], params[6].shape[-1]
        fwd_ops, bwd_ops = attn_slot_ops(c, cs)
        numel = lambda ts: sum(t.numel() for t in ts)
        n_bytes = 4 * (numel((q, kv, rel, li, starts)) + numel(params))
        if name == "pt_attn_fwd":
            n_bytes += 4 * numel(out)
            n_ops = b * m * k * fwd_ops
        else:
            dq, dkv, grads = out
            n_bytes += 4 * (args[8].numel() + dq.numel() + dkv.numel() + numel(grads))
            n_ops = b * m * k * bwd_ops
        shape = dict(B=b, M=m, C=c, K=k, W=tile * width)
        return kern, plain, None, n_bytes, float(n_ops), shape
    # stats: inputs read once, outputs written once; per valid listed slot
    # about 4C + 12 FP32 operations forward and 8C + 16 backward
    features, meta, li = args[:3]
    temperature, tile, width, window = args[-4:]
    valid = float(cd.cbl_stats_fwd_plain(features, meta, li, temperature, tile, width, window)[..., 4].sum())
    c = features.shape[-1]
    n_bytes = 4 * (features.numel() + meta.numel() + li.numel())
    if name == "cbl_stats_fwd":
        n_bytes += 4 * out.numel()
        n_ops = valid * (4 * c + 12)
    else:
        # the forward's m̂ (one lane of its stats), the cotangent, dx
        n_bytes += 4 * (features.shape[0] * features.shape[1] + args[4].numel() + out.numel())
        n_ops = valid * (8 * c + 16)
    shape = dict(features=list(features.shape), K=li.shape[-1], tile=tile, width=width,
                 valid_slots=int(valid))
    return kern, plain, None, n_bytes, n_ops, shape


@torch.no_grad()
def time_calls(calls, dev, launches, max_err, names, reps=10, records=None) -> list:
    """Hold each recorded launch against the plain version, then time it;
    per-kernel sums over the recorded run (and, into ``records`` where
    given, (name, shape, kernel ms, bound ms) of each launch)."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    summary = []
    for name in names:
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0)
        has_lib = True
        for call in calls[name]:
            max_err[name] = max(max_err[name], compare_call(name, call))
            kern, plain, lib, n_bytes, n_ops, shape = call_costs(name, call)
            t_k, t_p = (time_ms(f, flush_buf, reps) for f in (kern, plain))
            t_l = None if lib is None else time_ms(lib, flush_buf, reps)
            has_lib = has_lib and t_l is not None
            bnd, t_b, t_o = bound_ms(n_bytes, n_ops)
            lib_txt = "n/a" if t_l is None else f"{t_l:.4f} ms"
            print(f"  {name} {shape}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                  f"library {lib_txt}, bound {bnd:.5f} ms", flush=True)
            if records is not None:
                records.append((name, shape, t_k, bnd))
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l or 0.0),
                           ("bound_ms", bnd), ("t_bytes", t_b), ("t_ops", t_o)):
                tot[key] += v
        summary.append(dict(
            name=name, route="cuda", **KERNELS[name], launches=launches[name],
            max_abs_err=max_err[name], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by="operations" if tot["t_ops"] > tot["t_bytes"] else "bytes",
            library_ms=tot["library_ms"] if has_lib else None,
        ))
    return summary


def profile_request(step, batch, top=12, what="request"):
    """One request (or train step) under torch.profiler: device time by
    kernel name and the device's busy share of its wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    # device events only; "Optimizer.step#SGD.step"-style names are the
    # profiler's own annotations spanning kernels, not device work (kernel
    # names hold spaces or parentheses)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not re.fullmatch(r"[\w.]+#[\w.]+", e.key)]
    events = sorted(kernels, key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    n_dev = sum(e.count for e in events)
    print(f"profiled {what}: {n_dev} device events, wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})", flush=True)
    for e in events[:top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}", flush=True)
    return busy_ms


def snapshot(model, opt):
    return copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict())


def restore(model, opt, snap):
    model.load_state_dict(snap[0])
    opt.load_state_dict(copy.deepcopy(snap[1]))  # the optimizer keeps what it is given


def grad_norm(model) -> float:
    return float(torch.sqrt(sum((p.grad.double() ** 2).sum()
                                for p in model.parameters() if p.grad is not None)))


def buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in model.named_buffers()}


def run_train(dev, bn_mode="batch", route="dense") -> dict:
    """Phases 8, 10, 12 and 13: the flagship train step at B x N from the
    checkpoint, with flax batch BN or stale BN, on one of the CBL routes
    (the caller selects it with cbl_route_env)."""
    _, impl, cbl_kernels = CBL_ROUTES[route]
    require(cbl_losses.dense_route() == (route == "dense"), f"CBL_DENSE does not select {route}")
    kernels = PATH_KERNELS + cbl_kernels
    if bn_mode == "stale":
        kernels += ("pt_attn_fwd", "pt_attn_bwd")
    what = f"{bn_mode} BN" + ("" if route == "dense" else f", CBL route {route}")
    model, trained = load_model(bn_mode)
    opt = make_optimizer(model.parameters(), TRAIN_LR)
    cfg = TrainStepConfig(num_classes=NUM_CLASSES, spec=TRAIN_SPEC,
                          contrast=ContrastConfig(impl=impl))
    step = make_train_step(model, cfg, opt, device=dev)
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, B, N, np.random.default_rng(0))
    snap0 = snapshot(model, opt)
    step(batch)  # warm-up: library handles, allocator
    torch.cuda.synchronize()

    restore(model, opt, snap0)
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        m = step(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        print("  step: " + ", ".join(f"{k} {float(v):.6f}" for k, v in m.items()
                                      if k != "confusion"), flush=True)
    med = statistics.median(secs[2:])
    peak = torch.cuda.max_memory_allocated()
    print(f"train step ({what}) median of 3 warm steps {med * 1e3:.3f} ms over "
          f"{[round(x * 1e3, 3) for x in secs]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {peak} B", flush=True)
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    busy_ms = profile_request(step, batch, what="train step")
    print(f"device busy {busy_ms:.3f} ms of the unprofiled median step "
          f"{med * 1e3:.3f} ms: busy share {busy_ms / (med * 1e3):.3f}", flush=True)
    if route == "dense":  # the pyramid is the same on every route
        pts_dev = torch.as_tensor(batch["points"], device=dev)
        pyr_ms = time_ms(lambda: build_pyramid(pts_dev, TRAIN_SPEC), reps=3)
        print(f"device time of the training pyramid alone {pyr_ms:.3f} ms", flush=True)

    restore(model, opt, snap0)
    torch.cuda.synchronize()
    reset_counts()
    wide_args, wide_fn = [], knn.window_topk_wide
    stage_inputs, v2_fn = [], cbl_losses.cbl_tile_softnn2

    def rec_wide(*args, **kw):
        wide_args.append((args, kw))
        return wide_fn(*args, **kw)

    def rec_v2(*args, **kw):
        stage_inputs.append(frozen(args))
        return v2_fn(*args, **kw)

    with recording() as calls, mock.patch.object(knn, "window_topk_wide", rec_wide), \
            mock.patch.object(cbl_losses, "cbl_tile_softnn2", rec_v2):
        m = step(batch)
        torch.cuda.synchronize()
    counts, wide = read_counts(), knn.wide_calls
    launches = {k: counts[k] for k in kernels}
    print(f"launches in one train step ({what}): {launches}; wide-window searches "
          f"(plain PyTorch): {wide}", flush=True)
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    require(all(launches[k] == STAGES for k in cbl_kernels),
            f"not one launch of each CBL kernel a stage: {launches}")
    others = {k: counts[k] for k in CBL_KERNELS if k not in cbl_kernels}
    require(not any(others.values()), f"another route's CBL kernel was launched: {others}")
    no_path = {k: counts[k] for k in NO_PATH_KERNELS}
    require(not any(no_path.values()), f"a kernel of no path was launched: {no_path}")
    metrics = {k: float(v) for k, v in m.items() if k != "confusion"}
    for args, kw in wide_args if route == "dense" else ():
        t = time_ms(lambda: wide_fn(*args, **kw), reps=3)
        print(f"  wide-window search k={args[2]} M={args[0].shape[1]} "
              f"W={kw['width'] * kw['tile']}: {t:.4f} ms", flush=True)
    loss_k, gn_k, stats_k = float(m["loss"]), grad_norm(model), buffers(model)
    require(np.isfinite(loss_k) and np.isfinite(gn_k), f"loss {loss_k}, grad norm {gn_k}")
    restore(model, opt, snap0)
    with plain_kernels():
        m = step(batch)
    loss_p, gn_p, stats_p = float(m["loss"]), grad_norm(model), buffers(model)
    stats_rel = max(float((stats_k[n] - v).abs().max() / v.abs().max().clamp_min(1e-30))
                    for n, v in stats_p.items())
    print(f"kernels vs plain, same weights and batch: loss {loss_k:.7f} vs {loss_p:.7f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3g}), gradient norm {gn_k:.7f} vs "
          f"{gn_p:.7f} (rel {abs(gn_k - gn_p) / gn_p:.3g}), running statistics rel "
          f"{stats_rel:.3g}", flush=True)
    require(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p), "train losses disagree")
    require(abs(gn_k - gn_p) <= 1e-3 * gn_p, "gradient norms disagree")
    require(stats_rel <= 1e-4, "running statistics disagree")
    return dict(calls=calls, launches=launches, model=model, step=step, peak=peak, med=med,
                metrics=metrics, stage_inputs=stage_inputs, no_path=no_path)


def check_train_kernels(dev, train) -> list:
    """Phase 9: every kernel call of one train step on integer-grid clouds
    (exact top-k) against the plain versions; then every call of the
    recorded step compared and timed."""
    rng = np.random.default_rng(2)
    grid = {"points": grid_cloud(rng, B, N),
            "features": rng.random((B, N, 3)).astype(np.float32),
            "labels": rng.integers(0, NUM_CLASSES, (B, N)).astype(np.int32)}
    max_err = {name: 0.0 for name in WRAPPERS}
    with recording() as calls:
        train["step"](grid)
        torch.cuda.synchronize()
    with torch.no_grad():
        for name, cs in calls.items():
            for c in cs:
                max_err[name] = max(max_err[name], compare_call(name, c, exact_topk=True))
            print(f"  integer grid: {len(cs)} {name} calls agree", flush=True)
    del calls
    summary = time_calls(train["calls"], dev, train["launches"], max_err, TRAIN_KERNELS, reps=5)
    time_spread(train["calls"], dev,
                ("window_topk", "window_gather", "window_gather_bwd", "cbl_stats_fwd",
                 "cbl_stats_bwd"))
    return summary


def check_stale_kernels(dev, stale) -> list:
    """Phase 11: every pt_attn call of the recorded stale step against the
    plain versions; one stale step on integer-grid clouds, each of its
    backward calls also exact on integer cotangents; then each call of the
    recorded step timed as in phase 4."""
    max_err = {name: 0.0 for name in ("pt_attn_fwd", "pt_attn_bwd")}
    rng = np.random.default_rng(3)
    grid = {"points": grid_cloud(rng, B, N),
            "features": rng.random((B, N, 3)).astype(np.float32),
            "labels": rng.integers(0, NUM_CLASSES, (B, N)).astype(np.int32)}
    with recording() as calls:
        stale["step"](grid)
        torch.cuda.synchronize()
    with torch.no_grad():
        for name in max_err:
            for c in calls[name]:
                max_err[name] = max(max_err[name], compare_call(name, c))
        for c in calls["pt_attn_bwd"]:
            check_pt_attn_bwd_exact(c)
    print(f"  integer grid: {len(calls['pt_attn_fwd'])} pt_attn_fwd and "
          f"{len(calls['pt_attn_bwd'])} pt_attn_bwd calls agree, dkv exact on integer "
          f"cotangents", flush=True)
    del calls
    records = []
    summary = time_calls(stale["calls"], dev, stale["launches"], max_err, tuple(max_err), reps=5,
                         records=records)
    print_widths(records)
    time_spread(stale["calls"], dev, tuple(max_err))
    return summary


def print_widths(records) -> None:
    """The attention kernels' recorded launch times summed per width (C, M,
    K): launches, kernel ms, bound ms."""
    widths = {}
    for name, shape, t_k, bnd in records:
        w = widths.setdefault((name, shape["C"], shape["M"], shape["K"]), [0, 0.0, 0.0])
        w[0] += 1
        w[1] += t_k
        w[2] += bnd
    for (name, c, m, k), (n, t_k, bnd) in sorted(widths.items()):
        print(f"  {name} C={c} M={m} K={k}: {n} launches, {t_k:.4f} ms, bound {bnd:.5f} ms "
              f"({t_k / bnd:.1f}x)", flush=True)


def attn_inputs(dev, rng, c, m, k, tile, width):
    """Seeded operands of one attention call at B clouds: tower arrays about
    as the folded flagship's (bn scales near 1), slot 0 the query row, the
    slots beyond the largest power of two <= K shadow slots in every row (so
    that the valid slots' equal weights are dyadic where W4 = 0, as
    check_pt_attn_bwd_exact needs), and a cotangent."""
    cs = c // pa.SHARES
    w_sz = tile * width

    def a(shape, scale=0.3, off=0.0):
        return torch.as_tensor((rng.standard_normal(shape) * scale + off).astype(np.float32),
                               device=dev)

    params = (a((3, 3)), a((1, 3)), a((3, c)), a((1, c)), a((1, c), off=1.0), a((1, c)),
              a((c, cs), c ** -0.5), a((1, cs)), a((1, cs), off=1.0), a((1, cs)),
              a((cs, cs), cs ** -0.5), a((1, cs)))
    starts = window_starts(m // tile, width)
    li = rng.integers(0, w_sz, (B, m, k)).astype(np.int32)
    li[:, :, 0] = (np.arange(m) - np.repeat(starts * tile, tile))[None]
    li[:, :, 1 << (k.bit_length() - 1):] = w_sz
    args = (a((B, m, c), 1.0), a((B, m, 2 * c), 1.0), a((B, m, k, 3), 0.05),
            torch.as_tensor(li, device=dev), torch.as_tensor(starts, dtype=torch.int32, device=dev),
            tile, width, params)
    return args, a((B, m, c), 1.0)


# direct v2 calls of phase plan-shapes: (C, M, K, tile, width, window, labels)
# with labels "mixed" (4 classes, 10% of the rows without a label), "all"
# (every row in the loss mask: slot 0 the query, slot 1 a row of the other
# label) or "none" (one label: no row in the mask)
V2_SHAPES = (
    (1, 4096, 35, 256, 3, 1, "mixed"), (20, 4096, 35, 256, 3, 1, "mixed"),
    (33, 4096, 35, 256, 3, 1, "mixed"), (64, 4096, 1, 256, 3, 1, "mixed"),
    (128, 4096, 300, 256, 3, 1, "mixed"), (32, 4096, 300, 256, 3, 1, "all"),
    (32, 8192, 35, 128, 5, 2, "mixed"), (32, 8192, 35, 1024, 1, 0, "all"),
    (32, 4096, 35, 256, 3, 1, "none"),
    # M·K >= 2^23, and a support tile's slot range beyond the scatter's 2^22
    (32, 32768, 300, 4096, 4, 1, "mixed"),
)


def v2_inputs(dev, rng, c, m, k, tile, width, window, labels):
    """Seeded operands of a direct v2 call at B clouds → (features, meta,
    li, temperature, tile, width, window) and a cotangent g [B]."""
    w_sz = tile * width
    q = np.arange(m)
    own = q - np.repeat(cd.self_window_starts(m, tile, width, window) * tile, tile)
    if labels == "mixed":
        lab = rng.integers(0, 4, (B, m))
        valid = rng.random((B, m)) >= 0.1
    else:
        lab = np.broadcast_to(q % 2 if labels == "all" else 0 * q, (B, m))
        valid = np.ones((B, m), bool)
    onehot = np.eye(4, dtype=np.float32)[lab] * valid[..., None]
    li = rng.integers(0, w_sz + 1, (B, m, k)).astype(np.int32)
    if labels == "all":
        li[:, :, 0] = own
        li[:, :, 1] = np.where(own + 1 < w_sz, own + 1, own - 1)
    t = lambda a: torch.as_tensor(a, device=dev)
    features = t(rng.standard_normal((B, m, c), dtype=np.float32))
    args = (features, cd.row_meta(t(onehot)), t(li), 0.5, tile, width, window)
    return args, t(rng.standard_normal(B).astype(np.float32))


def check_v2_shapes(dev, rng) -> None:
    """The v2 kernels at V2_SHAPES against their plain versions, as in phase
    cbl-kernels: every shape the previous kernels took has a plan."""
    for c, m, k, tile, width, window, labels in V2_SHAPES:
        args, g = v2_inputs(dev, rng, c, m, k, tile, width, window, labels)
        stats = c2.cbl_tile2_fwd(*args)
        n_mask = int(stats[..., 6].sum())
        if labels == "all":
            require(n_mask == B * m, f"v2 C={c} M={m} K={k}: {n_mask} masked rows, not all")
        if labels == "none" or k == 1:
            require(n_mask == 0, f"v2 C={c} M={m} K={k}: {n_mask} masked rows, not none")
        err = compare_tile_stats("cbl_tile2_fwd", (args, {}, stats))
        bwd_args = args[:3] + (stats, g) + args[3:]
        dx = c2.cbl_tile2_bwd(*bwd_args)
        require(dx.shape == args[0].shape, f"v2 gradient {tuple(dx.shape)}")
        err = max(err, compare_tile_grad("cbl_tile2_bwd", (bwd_args, {}, dx)))
        plan = c2.bwd_plan(B, m, k, c, tile)
        print(f"  cbl_tile2 C={c} M={m} K={k} tile {tile} x width {width} ({labels}, {n_mask} "
              f"masked rows): fwd plan {tuple(c2.fwd_plan(B, m, k, c))}, scatter rows "
              f"{plan.scatter_rows}: max|d| {err:.3g}, the same bits twice", flush=True)
        del args, stats, dx
        torch.cuda.empty_cache()


def check_plan_shapes(dev) -> None:
    """Phase 15: direct calls at the shapes whose plans take a smaller tile
    or slot chunks, against the plain versions: pt_attn_fwd and pt_attn_bwd
    at C = 512 with K = 8 (M = 1024) and K = 32 and 48 (M = 256) as in
    phase 11 (1e-4 of scale, the forward's bits twice, dkv exact on integer
    cotangents); cbl_stats_fwd on windows wider than shared memory holds
    (width 7 x tile 256 and width 3 x tile 1024, K = 36) as in phase 9
    (counts exact, sums rel 1e-5, the same bits twice), and its L2 path at
    the flagship's level-0 window equal bit for bit to the staged path;
    cbl_tile2_fwd and cbl_tile2_bwd at V2_SHAPES (C in {1, 20, 32, 33, 64,
    128}, K in {1, 35, 300}, M·K >= 2^23, tile x width 128 x 5 and 1024 x
    1, every row and no row in the loss mask) as in phase 14."""
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for m, k, tile, width in ((1024, 8, 256, 3), (256, 32, 256, 1), (256, 48, 256, 1)):
            args, g = attn_inputs(dev, rng, 512, m, k, tile, width)
            fwd = (args, {}, pa.pt_attn_fwd(*args))
            bwd = (args + (g,), {}, pa.pt_attn_bwd(*args, g))
            err = max(compare_pt_attn_fwd(fwd), compare_pt_attn_bwd(bwd))
            check_pt_attn_bwd_exact(bwd)
            print(f"  pt_attn C=512 M={m} K={k}: fwd plan {tuple(pa.fwd_plan(B, m, k, 512))}, "
                  f"bwd plan {tuple(pa.bwd_plan(B, m, k, 512))}: max|d| {err:.3g}, dkv exact",
                  flush=True)
        labels = torch.as_tensor(rng.integers(0, NUM_CLASSES, (B, N)), device=dev)
        onehot = torch.nn.functional.one_hot(labels, NUM_CLASSES).float()
        onehot[torch.as_tensor(rng.random((B, N)) < 0.1, device=dev)] = 0.0
        meta = cd.row_meta(onehot)
        features = torch.as_tensor(rng.standard_normal((B, N, cd.CHANNELS), dtype=np.float32),
                                   device=dev)
        for k, tile, width, window in ((36, 256, 7, 3), (36, 1024, 3, 1), (35, 256, 3, 1)):
            w_sz = tile * width
            li = torch.as_tensor(rng.integers(0, w_sz + 1, (B, N, k)).astype(np.int32), device=dev)
            args = (features, meta, li, 1.0, tile, width, window)
            out = cd.cbl_stats_fwd(*args)
            err = compare_stats_fwd((args, {}, out))
            plan = cd.fwd_plan(B, N, k, tile, width)
            if plan[2]:  # a staged window: the L2 path gives its bits
                other = torch.empty_like(out)
                blocks, threads, _ = plan
                build.check(build.library().cbl_stats_fwd(
                    features.data_ptr(), meta.data_ptr(), li.data_ptr(), other.data_ptr(), B, N,
                    k, cd.CHANNELS, tile, width, window, cd._inv_t(1.0), blocks, threads, 0,
                    torch.cuda.current_stream(dev).cuda_stream), "cbl_stats_fwd")
                require(torch.equal(other.view(torch.int32), out.view(torch.int32)),
                        f"cbl_stats_fwd W={w_sz}: the L2 path's bits differ from the staged path's")
            print(f"  cbl_stats_fwd K={k} W={w_sz}: plan {plan}, max|d| {err:.3g}, the same bits "
                  f"twice{', and through L2' if plan[2] else ''}", flush=True)
        del features, meta, labels, onehot
        torch.cuda.empty_cache()
        check_v2_shapes(dev, rng)


def check_routes(metrics: dict) -> None:
    """Phase 13: the CBL losses of one step on the same weights and batch
    on the dense and v2 routes against the XLA tile route's, each stage
    within the tolerance the CPU tests state for the pair."""
    for route, rtol in ROUTE_RTOL.items():
        rels = {k: abs(metrics[route][k] - metrics["xla"][k]) / abs(metrics["xla"][k])
                for k in ["cbl"] + [f"cbl_stage{i}" for i in range(STAGES)]}
        print(f"CBL losses, {route} route vs the XLA tile route: "
              + ", ".join(f"{k} {metrics[route][k]:.7f} vs {metrics['xla'][k]:.7f} "
                          f"(rel {v:.3g})" for k, v in rels.items()), flush=True)
        require(all(v <= rtol for v in rels.values()),
                f"the {route} route's CBL losses are not within rel {rtol} of the XLA route's")


def bare_entry(name, args, kw):
    """A kernel's C entry on operands prepared once, outside the timed call:
    none of the wrapper's host work (operand checks and conversions, the
    window starts copied to the card, the output allocated, the parameter
    gradients' and statistics' partial rows summed) is timed. The attention
    backward's dk|dv is not zeroed between runs. The returned call keeps
    its operands alive."""
    lib, stream = build.library(), torch.cuda.current_stream(args[0].device).cuda_stream

    def call(entry, tensors, *rest):
        ptrs = [t.data_ptr() for t in tensors]
        return lambda _keep=tensors: build.check(entry(*ptrs, *rest, stream), name)

    if name == "window_topk":
        query, support, k = args
        b, m, _ = query.shape
        ns, tile = support.shape[1], kw["tile"]
        idx = torch.empty((b, m, k), dtype=torch.int32, device=query.device)
        val = torch.empty((b, m, k), dtype=torch.float32, device=query.device)
        return call(lib.cbl_win_topk, (query, support, idx, val), b, m, ns, k, tile,
                    kw["width"], kw["window"], ns // tile, wt.MODES[kw.get("mode", "plain")])
    if name == "window_gather":
        x, li, starts, tile, width = args
        b, ns, c = x.shape
        m, k = li.shape[1:]
        out = torch.empty((b, m, k, c), dtype=torch.float32, device=x.device)
        plan = tg.gather_plan(b * m * k, c, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
        ops = (x, li.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous(), out)
        return call(lib.cbl_window_gather, ops, b, ns, m, k, c, tile, width, plan.lpg, plan.nt,
                    plan.rw)
    if name == "window_gather_bwd":
        g, li, starts, tile, width, ns = args
        b, m, k, c = g.shape
        dx = torch.empty((b, ns, c), dtype=torch.float32, device=g.device)
        ops = (g, li.to(torch.int32).contiguous(), starts.to(torch.int32).contiguous(), dx)
        return call(lib.cbl_window_gather_bwd, ops, b, ns, m, k, c, tile, width)
    if name == "cbl_stats_fwd":
        features, meta, li, temperature, tile, width, window = args
        f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
        b, m, c = f.shape
        k = lii.shape[-1]
        ops = (f, mt, lii, torch.empty((b, m, 8), dtype=torch.float32, device=f.device))
        return call(lib.cbl_stats_fwd, ops, b, m, k, c, tile, width, window,
                    cd._inv_t(temperature), *cd.fwd_plan(b, m, k, tile, width))
    if name in ("pt_attn_fwd", "pt_attn_bwd"):
        q, kv, rel, li, starts, tile, width, params = args[:8]
        (q, kv, rel, li, st), ps, (b, m, k, c, cs_) = pa._cuda_args(
            q, kv, rel, li, starts, tile, width, params)
        ptrs = pa._pointers(ps)
        head = (q.data_ptr(), kv.data_ptr(), rel.data_ptr(), li.data_ptr(), st.data_ptr(),
                ctypes.cast(ptrs, ctypes.c_void_p))
        if name == "pt_attn_fwd":
            plan = pa.fwd_plan(b, m, k, c)
            out = (torch.empty_like(q), torch.empty((plan.blocks, 2 * c + 2 * cs_), device=q.device))
            entry = lib.cbl_pt_attn_fwd
        else:
            plan = pa.bwd_plan(b, m, k, c)
            out = (args[8].float().contiguous(), torch.empty_like(q), torch.zeros_like(kv),
                   torch.empty((plan.blocks, sum(pa._prow(c, cs_))), device=q.device))
            entry = lib.cbl_pt_attn_bwd
        ptr_args = head + tuple(t.data_ptr() for t in out)
        keep = (q, kv, rel, li, st, ps, ptrs, out)
        return lambda _keep=keep: build.check(entry(
            *ptr_args, b, m, k, c, tile, width, plan.blocks, plan.threads, plan.rows, plan.chunk,
            plan.smem, stream), name)
    if name == "cbl_stats_bwd":
        features, meta, li, stats, g, temperature, tile, width, window = args
        f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
        b, m, c = f.shape
        k = lii.shape[-1]
        coef = torch.empty((b, m, k), dtype=torch.float32, device=f.device)
        lands = torch.empty((b, m, k), dtype=torch.int32, device=f.device)
        ops = (f, mt, lii, stats.contiguous(), g.contiguous(), coef, lands, torch.empty_like(f))
        return call(lib.cbl_stats_bwd, ops, b, m, k, c, tile, width, window,
                    cd._inv_t(temperature), cd.bwd_plan(b, m, tile)[1])
    if name == "cbl_tile2_fwd":
        features, meta, li, temperature, tile, width, window = args
        b, m, c = features.shape
        f, mt, lii = c2.v2_operands(features, meta, li, tile, width)
        plan = c2.fwd_plan(b, m, lii.shape[-1], c)
        ops = (f, mt, lii, torch.empty((b, m, 8), device=f.device))
        return call(lib.cbl_tile2_fwd, ops, b, m, lii.shape[-1], plan.channels, tile, width,
                    window, float(temperature), plan.label_rows, plan.row_rows)
    if name == "cbl_tile2_bwd":
        features, meta, li, stats, g, temperature, tile, width, window = args
        b, m, c = features.shape
        f, mt, lii, st, gl = c2.v2_operands(features, meta, li, tile, width, stats, g)
        k = lii.shape[-1]
        plan = c2.bwd_plan(b, m, k, c, tile)
        scratch = (torch.empty((b, m, k), device=f.device),
                   torch.empty((b, m, k), dtype=torch.int32, device=f.device), torch.empty_like(f))
        return call(lib.cbl_tile2_bwd, (f, mt, lii, st, gl) + scratch, b, m, k,
                    plan.pass1.channels, tile, width, window, float(temperature),
                    plan.pass1.row_rows, plan.scatter_rows)
    raise ValueError(f"no bare entry for {name}")


@torch.no_grad()
def time_spread(calls, dev, names, reps=20):
    """The spread of one launch's time: the largest recorded call of each
    kernel (level 0; window_topk by rows times k) timed reps times alone,
    each after an L2 flush, through its wrapper and through its bare C
    entry; for the dense and the v2 CBL backward, how their scatter's terms
    (slots with a coefficient != 0) spread over the support tiles, one
    block's work each at level 0."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)
    for name in names:
        args, kw, _ = max(calls[name], key=lambda call: call[0][0].numel() * (
            call[0][2] if name == "window_topk" else 1))
        mod, attr, _ = WRAPPERS[name]
        for what, fn in (("wrapper", lambda: getattr(mod, attr)(*args, **kw)),
                         ("bare C entry", bare_entry(name, args, kw))):
            ts = sorted(time_ms(fn, flush_buf, reps=1) for _ in range(reps))
            print(f"  {name} {tuple(args[0].shape)} {kw}, {what}, {reps} runs: min {ts[0]:.4f} ms, median "
                  f"{statistics.median(ts):.4f} ms, max {ts[-1]:.4f} ms", flush=True)
        if name == "cbl_stats_bwd":
            features, meta, li, _, _, _, tile, width, window = args
            m = features.shape[1]
            starts = torch.as_tensor(cd.self_window_starts(m, tile, width, window), device=dev)
            rows, member = tg._rows(li, starts, tile, width, m)
            hit = member & (cd.cbl_bwd_cd_plain(*args)[0] != 0)
            per_tile = torch.bincount(rows[hit] // tile, minlength=features.shape[0] * m // tile)
            print(f"  {name} {tuple(features.shape)}: {int(hit.sum())} scatter terms on "
                  f"{per_tile.numel()} support tiles, per tile min {int(per_tile.min())}, mean "
                  f"{float(per_tile.float().mean()):.1f}, max {int(per_tile.max())}", flush=True)
        if name == "cbl_tile2_bwd":
            features, meta, li, stats, g, temperature, tile, width, window = args
            coef, rows = c2.grad_coefs_plain(features, meta[..., 0], meta[..., 1], li, stats,
                                             g, temperature, tile, width, window)
            per_tile = torch.bincount(rows[coef != 0] // tile,
                                      minlength=features.shape[0] * features.shape[1] // tile)
            print(f"  {name} {tuple(features.shape)}: {int((coef != 0).sum())} scatter terms on "
                  f"{per_tile.numel()} support tiles, per tile min {int(per_tile.min())}, mean "
                  f"{float(per_tile.float().mean()):.1f}, max {int(per_tile.max())}", flush=True)


def check_cbl_kernels(dev, pallas) -> list:
    """Phase 14: every v2 call of the recorded cbl-pallas step against its
    plain version and timed; v1 at that step's level-0 shape ([its soft
    labels | its latents], K = 35) against its plain version and against v2
    on the same inputs; gather_rows exact on x [131072, 128] f32 with
    131072 random rows, torch.index_select timed beside it. The launches
    of v1 and gather_rows are those of the cbl-pallas step (0: no path runs
    them); their direct calls here are counted apart."""
    names = ("cbl_tile2_fwd", "cbl_tile2_bwd", "cbl_tile_fwd", "cbl_tile_bwd", "gather_rows")
    max_err = {name: 0.0 for name in names}
    summary = time_calls(pallas["calls"], dev, pallas["launches"], max_err, names[:2], reps=5)
    time_spread(pallas["calls"], dev, names[:2])

    features, label_soft, li, temperature, tile, width, window = pallas["stage_inputs"][0]
    ncls = label_soft.shape[-1]
    fused = torch.cat([label_soft, features], -1).contiguous()
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(B), dtype=torch.float32,
                        device=dev)
    reset_counts()
    stats1 = c1.cbl_tile_fwd(fused, li, ncls, temperature, tile, width, window)
    dfused = c1.cbl_tile_bwd(fused, li, stats1, g, ncls, temperature, tile, width, window)
    torch.cuda.synchronize()
    direct = read_counts()
    meta = cd.row_meta(label_soft)
    stats2 = c2.cbl_tile2_fwd(features, meta, li, temperature, tile, width, window)
    dx2 = c2.cbl_tile2_bwd(features, meta, li, stats2, g, temperature, tile, width, window)
    sums1, sums2 = stats1[..., 5].sum(-1), stats2[..., 5].sum(-1)
    rel = float(((sums1 - sums2).abs() / sums2.abs()).max())
    print(f"  v1 vs v2 kernels at {tuple(fused.shape)}, K={li.shape[-1]}: loss sums "
          f"{sums1.tolist()} vs {sums2.tolist()} (rel {rel:.3g})", flush=True)
    require(torch.equal(stats1[..., [3, 4, 6]], stats2[..., [3, 4, 6]]), "v1 and v2 counts differ")
    require(rel <= 1e-5, "v1 and v2 loss sums differ")
    compare_scaled("v1 vs v2 feature gradient", dfused[..., ncls:], dx2, 1e-4)
    v1_calls = {
        "cbl_tile_fwd": [((fused, li, ncls, temperature, tile, width, window), {}, stats1)],
        "cbl_tile_bwd": [((fused, li, stats1, g, ncls, temperature, tile, width, window), {},
                          dfused)],
    }
    summary += time_calls(v1_calls, dev, pallas["no_path"], max_err, names[2:4], reps=5)

    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((131072, 128), dtype=np.float32), device=dev)
    idx = torch.as_tensor(rng.integers(0, 131072, 131072, dtype=np.int32), device=dev)
    reset_counts()
    out = gd.gather_rows(x, idx)
    direct["gather_rows"] = read_counts()["gather_rows"]
    require(torch.equal(out, x[idx.long()]), "gather_rows differs from x[idx]")
    print(f"  gather_rows {tuple(out.shape)}: equal to x[idx]", flush=True)
    summary += time_calls({"gather_rows": [((x, idx), {}, out)]}, dev, pallas["no_path"],
                          max_err, names[4:])
    for entry in summary[2:]:  # no path runs them: launches made here
        entry["direct_launches"] = direct[entry["name"]]
    return summary


def serve(dev, batch, bn_mode="batch", ref_probs=None) -> dict:
    """Phases 3 and 7: the checkpoint served with flax batch BN or stale BN
    on one B x N batch: one request with the launch counts reset just before
    and read just after (each kernel of the path > 0) and its calls
    recorded, the running statistics untouched, three timed requests, probs
    against the plain versions' (and against ``ref_probs`` where given:
    eval-mode BN is the same function in both modes), crop OA."""
    kernels = SERVE_KERNELS if bn_mode == "batch" else STALE_SERVE_KERNELS
    model, trained = load_model(bn_mode)
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES)

    def predict(bt):
        probs, _ = step(bt)
        return probs.cpu().numpy()

    before = buffers(model)
    predict(batch)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    with recording() as calls:
        probs, conf = step(batch)
        torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if k in kernels}
    print(f"launches in one request ({bn_mode} BN): {launches}", flush=True)
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    require(bool(torch.isfinite(probs).all()) and probs.shape == (B, N, NUM_CLASSES),
            f"probs {tuple(probs.shape)} not finite")
    require(all(torch.equal(v, before[k]) for k, v in buffers(model).items()),
            "a request changed the running statistics")

    torch.cuda.reset_peak_memory_stats()
    lat = []
    for _ in range(3):
        t0 = time.perf_counter()
        predict(batch)
        lat.append(time.perf_counter() - t0)
    med = statistics.median(lat)
    print(f"request latency ({bn_mode} BN) median {med * 1e3:.3f} ms over "
          f"{[round(x * 1e3, 3) for x in lat]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B", flush=True)

    with plain_kernels():
        p_plain, _ = step(batch)
    refs = {"plain versions": p_plain}
    if ref_probs is not None:
        refs["batch-BN model"] = ref_probs
    for what, ref in refs.items():
        d = float((probs - ref).abs().max())
        agree = float((probs.argmax(-1) == ref.argmax(-1)).float().mean())
        print(f"kernels vs {what}: max|dprobs| {d:.3g}, argmax agreement {agree:.6f}", flush=True)
        require(d <= 1e-3 and agree >= 0.999, f"probs disagree with the {what}")
    conf = conf.cpu().numpy()
    oa = float(np.trace(conf) / conf.sum())
    print(f"crop OA {oa:.4f} ({'trained' if trained else 'random'} weights)", flush=True)
    if trained:
        require(oa >= 0.5, f"crop OA {oa:.4f} < 0.5")
    return dict(step=step, predict=predict, calls=calls, launches=launches, probs=probs, med=med)


def voting(predict, what="request") -> None:
    """Phase 6: VotingEvaluator over room 0 for three requests."""
    ev = VotingEvaluator(room0(), predict, NUM_CLASSES, N, batch_size=B,
                         voxel_size=0.04, num_votes=20, seed=0)
    t0 = time.perf_counter()
    m = ev.run(max_steps=3)
    per = (time.perf_counter() - t0) / 3
    print(f"voting: {per * 1e3:.3f} ms per {what} over 3 requests "
          f"(sub mIoU so far {m['sub']['mIoU']:.4f})", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    with phase("build"):
        print(f"card: {card_line()}", flush=True)
        t0 = time.perf_counter()
        lib_path = build.build()
        build.library()
        print(f"built {lib_path.relative_to(ROOT)} in {time.perf_counter() - t0:.3f} s", flush=True)

    ev_serve = VotingEvaluator(room0(), None, NUM_CLASSES, N, batch_size=B, voxel_size=0.04, seed=0)
    _, batch = ev_serve.next_batch(np.random.default_rng(0), ev_serve.clouds)
    del ev_serve

    with phase("kernels"):
        grid = grid_cloud(np.random.default_rng(1), B, N)
        topk_err = check_kernels(dev, [("integer grid", grid, True),
                                       ("synthetic crop", batch["points"], False)])
        check_topk_modes(dev, grid)
        check_gather_widths(dev)

    with phase("serve"):
        served = serve(dev, batch)
        step, predict, launches = served["step"], served["predict"], served["launches"]
        calls = served.pop("calls")

    with phase("timing"):
        max_err = {"window_topk": topk_err, "window_gather": 0.0}
        serve_summary = time_calls(calls, dev, launches, max_err, SERVE_KERNELS)
        time_spread(calls, dev, ("window_topk",))
        del calls

    with phase("profile"):
        pts_dev = torch.as_tensor(batch["points"], device=dev)
        pyr_ms = time_ms(lambda: build_pyramid(pts_dev, PyramidSpec()), reps=3)
        step_ms = time_ms(lambda: step(batch), reps=3)
        print(f"device time: pyramid {pyr_ms:.3f} ms, whole step {step_ms:.3f} ms", flush=True)
        profile_request(step, batch)

    with phase("voting"):
        voting(predict)

    with phase("stale-serve"):
        stale_served = serve(dev, batch, "stale", served["probs"])
        n_fwd = stale_served["launches"]["pt_attn_fwd"]
        require(n_fwd == ATTENTION_LAYERS, f"pt_attn_fwd: {n_fwd} launches, not {ATTENTION_LAYERS}")
        print(f"stale request median {stale_served['med'] * 1e3:.3f} ms beside the batch-BN "
              f"request's {served['med'] * 1e3:.3f} ms", flush=True)
        voting(stale_served["predict"], "stale request")
        records = []
        stale_summary = time_calls(stale_served.pop("calls"), dev, stale_served["launches"],
                                   {"pt_attn_fwd": 0.0}, ("pt_attn_fwd",), records=records)
        print_widths(records)
    del served, stale_served, step, predict
    torch.cuda.empty_cache()

    with phase("train"), cbl_route_env("dense"):
        train = run_train(dev)

    with phase("train-kernels"), cbl_route_env("dense"):
        train_summary = check_train_kernels(dev, train)
    batch_launches, batch_peak = train["launches"], train["peak"]
    dense_med, dense_metrics = train["med"], train["metrics"]
    del train
    torch.cuda.empty_cache()

    with phase("stale-train"), cbl_route_env("dense"):
        stale = run_train(dev, "stale")
        launches = stale["launches"]
        for name in ("pt_attn_fwd", "pt_attn_bwd"):
            require(launches[name] == ATTENTION_LAYERS,
                    f"{name}: {launches[name]} launches, not {ATTENTION_LAYERS}")
        for name in ("window_gather", "window_gather_bwd"):
            require(launches[name] == batch_launches[name] - ATTENTION_LAYERS,
                    f"{name}: {launches[name]} launches under stale BN vs "
                    f"{batch_launches[name]} under batch BN")
        print(f"peak memory of the stale step {stale['peak']} B vs the batch step {batch_peak} B",
              flush=True)

    with phase("stale-kernels"), cbl_route_env("dense"):
        train_summary += check_stale_kernels(dev, stale)
    del stale
    torch.cuda.empty_cache()

    route_metrics = {"dense": dense_metrics}
    with phase("cbl-xla"), cbl_route_env("xla"):
        xla = run_train(dev, route="xla")
        for name in ("window_gather", "window_gather_bwd"):
            require(xla["launches"][name] == batch_launches[name] + STAGES,
                    f"{name}: {xla['launches'][name]} launches on the XLA tile route vs "
                    f"{batch_launches[name]} on the dense route")
        print(f"XLA tile route: step median {xla['med'] * 1e3:.3f} ms vs the dense route's "
              f"{dense_med * 1e3:.3f} ms, peak memory {xla['peak']} B vs {batch_peak} B",
              flush=True)
        route_metrics["xla"] = xla["metrics"]
    del xla
    torch.cuda.empty_cache()

    with phase("cbl-pallas"), cbl_route_env("pallas"):
        pallas = run_train(dev, route="pallas")
        for name in PATH_KERNELS:
            require(pallas["launches"][name] == batch_launches[name],
                    f"{name}: {pallas['launches'][name]} launches on the v2 route vs "
                    f"{batch_launches[name]} on the dense route")
        print(f"v2 route: step median {pallas['med'] * 1e3:.3f} ms vs the dense route's "
              f"{dense_med * 1e3:.3f} ms, peak memory {pallas['peak']} B vs {batch_peak} B",
              flush=True)
        route_metrics["pallas"] = pallas["metrics"]
        check_routes(route_metrics)

    with phase("cbl-kernels"):
        train_summary += check_cbl_kernels(dev, pallas)
    del pallas
    torch.cuda.empty_cache()

    with phase("plan-shapes"):
        check_plan_shapes(dev)

    summary = []
    for entry in train_summary:
        per_request = next(
            (e for e in serve_summary + stale_summary if e["name"] == entry["name"]), None)
        if per_request is None:
            summary.append(entry)
        else:
            summary.append({**per_request, "train": {k: entry[k] for k in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})

    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
