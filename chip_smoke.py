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
           slots, which allows for near-ties).
3. serve   the trained flagship (full width, float32) on B=2 x N=65536
           crops of synthetic val room 0: one request with the launch counts
           reset just before and read just after (both must be > 0), three
           timed requests, and one with both kernels swapped for their plain
           versions (probs within 1e-3, argmax agreeing on >= 99.9% of
           points); crop overall accuracy must be >= 0.5.
4. timing  every kernel launch of that request replayed: kernel, plain
           version and one PyTorch library call, each with L2 flushed, beside
           its bound (bytes at 3.35 TB/s or FP32 operations at 67 TFLOP/s,
           the H100 SXM data sheet, whichever is larger).
5. profile the request split: pyramid alone and whole step (CUDA events),
           and one torch.profiler trace: device time by kernel and the
           device's busy share of the request.
6. voting  VotingEvaluator over room 0 for three requests.
7. train   the flagship train step (train/trainer.py::make_train_step: the
           training pyramid, the model in train mode, CE + 5-stage CBL,
           backward, SGD lr 0.05) from the checkpoint on B=2 x N=65536 crops
           of synthetic train rooms: one step with every launch count reset
           just before and read just after (all five kernels must be > 0; the
           searches wider than 2048 rows, plain PyTorch by the reference's
           width rule, are counted apart); one step with the kernels and one
           with the plain versions from the same weights and batch (loss rel
           <= 1e-4, global gradient norm rel <= 1e-3); five steps on that
           batch (every loss finite, the last below the first), the median
           of the three warm ones on the host clock, points/s and
           max_memory_allocated; one step under torch.profiler.
8. train-kernels every kernel call of that step against its plain version:
           window_topk and window_gather as in phase 2, window_gather_bwd
           max-abs <= 1e-5 of the output's scale (atomics reorder the sums)
           and exact on integer cotangents, cbl_stats_fwd counts exact and
           sums rel <= 1e-5, cbl_stats_bwd max-abs <= 1e-4 of the output's
           scale; the same on one step over integer-grid clouds. Then each
           call timed as in phase 4 (5 runs each).

It prints the card's name and power limit, one JSON line of per-kernel
numbers (times are sums over the launches of one run of a path: the two
serving kernels' numbers are per serving request, with those of one train
step under "train"; the three training kernels' numbers are per train step),
and as its last line {"ok": true, "device": {...}}. Without CUDA it exits with 2
before doing anything.
"""
from __future__ import annotations

import copy
import json
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
from contrastboundary_tpu_torch.ops import PyramidSpec, build_pyramid, knn
from contrastboundary_tpu_torch.ops.cuda import cbl_dense as cd
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from contrastboundary_tpu_torch.ops.cuda import win_topk as wt
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
}
# each kernel's wrapper (module, attribute) and its plain version
WRAPPERS = {
    "window_topk": (wt, "window_topk", wt.window_topk_plain),
    "window_gather": (tg, "window_gather", tg.window_gather_plain),
    "window_gather_bwd": (tg, "window_gather_bwd", tg.window_gather_bwd_plain),
    "cbl_stats_fwd": (cd, "cbl_stats_fwd", cd.cbl_stats_fwd_plain),
    "cbl_stats_bwd": (cd, "cbl_stats_bwd", cd.cbl_stats_bwd_plain),
}
SERVE_KERNELS = ("window_topk", "window_gather")
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


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


@contextmanager
def recording():
    """Record every call (arguments and the kernel's outputs) of the five
    kernel wrappers made through the ops modules while active."""
    calls = {name: [] for name in WRAPPERS}
    with ExitStack() as stack:
        for name, (mod, attr, _) in WRAPPERS.items():
            def rec(*args, _fn=getattr(mod, attr), _name=name, **kw):
                out = _fn(*args, **kw)
                calls[_name].append((args, kw, out))
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
    knn.wide_calls = 0


def read_counts() -> dict:
    return {"window_topk": wt.launches, "window_gather": tg.launches,
            "window_gather_bwd": tg.bwd_launches, "cbl_stats_fwd": cd.fwd_launches,
            "cbl_stats_bwd": cd.bwd_launches}


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
    """Atomics reorder the sums: 1e-5 of the output's scale; and exact on
    integer-valued cotangents at the same geometry (small integers sum
    exactly in any order)."""
    (g, li, starts, tile, width, ns), _, out = call
    err = compare_scaled("window_gather_bwd", out, tg.window_gather_bwd_plain(*call[0]), 1e-5)
    g_int = torch.randint_like(g, -3, 4)
    require(torch.equal(tg.window_gather_bwd(g_int, li, starts, tile, width, ns),
                        tg.window_gather_bwd_plain(g_int, li, starts, tile, width, ns)),
            f"window_gather_bwd {tuple(g.shape)} not exact on integer cotangents")
    return err


def compare_stats_fwd(call) -> float:
    """Counts exact, the rest rel 1e-5 (the same arithmetic; exp and the
    sums over slots may round differently)."""
    args, _, out = call
    out = out.detach()
    ref = cd.cbl_stats_fwd_plain(*args)
    require(torch.equal(out[..., 3:], ref[..., 3:]), f"cbl_stats_fwd {tuple(out.shape)}: counts differ")
    err = float((out[..., :3] - ref[..., :3]).abs().max())
    require(bool(torch.allclose(out[..., :3], ref[..., :3], rtol=1e-5, atol=1e-7)),
            f"cbl_stats_fwd {tuple(out.shape)}: max|d|={err:.3g}")
    return err


def compare_call(name, call, exact_topk=False) -> float:
    if name == "window_topk":
        return compare_topk(call, exact_topk)
    if name == "window_gather":
        return compare_gather(call)
    if name == "window_gather_bwd":
        return compare_gather_bwd(call)
    if name == "cbl_stats_fwd":
        return compare_stats_fwd(call)
    args, _, out = call
    return compare_scaled(name, out, cd.cbl_stats_bwd_plain(*args), 1e-4)


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


def load_model():
    model = PointTransformerSeg(num_classes=NUM_CLASSES)
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
        n_bytes = 4 * (g.numel() + li.numel() + starts.numel() + 2 * out.numel())
        shape = dict(g=list(g.shape), Ns=ns, W=tile * width)
        return kern, plain, gather_bwd_library_call(*args), n_bytes, float(g.numel()), shape
    # stats: inputs read once, outputs written once (dx read and written by
    # the backward's atomics); per valid listed slot about 4C + 12 FP32
    # operations forward and 8C + 16 backward
    features, meta, li = args[:3]
    temperature, tile, width, window = args[-4:]
    valid = float(cd.cbl_stats_fwd_plain(features, meta, li, temperature, tile, width, window)[..., 4].sum())
    c = features.shape[-1]
    n_bytes = 4 * (features.numel() + meta.numel() + li.numel())
    if name == "cbl_stats_fwd":
        n_bytes += 4 * out.numel()
        n_ops = valid * (4 * c + 12)
    else:
        n_bytes += 4 * (args[3].numel() + 2 * out.numel())
        n_ops = valid * (8 * c + 16)
    shape = dict(features=list(features.shape), K=li.shape[-1], tile=tile, width=width,
                 valid_slots=int(valid))
    return kern, plain, None, n_bytes, n_ops, shape


@torch.no_grad()
def time_calls(calls, dev, launches, max_err, names, reps=10) -> list:
    """Hold each recorded launch against the plain version, then time it;
    per-kernel sums over the recorded run."""
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


def run_train(dev) -> dict:
    """Phase 7: the flagship train step at B x N from the checkpoint."""
    model, trained = load_model()
    opt = make_optimizer(model.parameters(), TRAIN_LR)
    cfg = TrainStepConfig(num_classes=NUM_CLASSES, spec=TRAIN_SPEC, contrast=ContrastConfig())
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
    print(f"train step median of 3 warm steps {med * 1e3:.3f} ms over "
          f"{[round(x * 1e3, 3) for x in secs]}, {B * N / med:.1f} points/s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B", flush=True)
    require(all(np.isfinite(losses)), f"losses {losses}")
    require(losses[-1] < losses[0], f"5 steps on one batch did not lower the loss: {losses}")
    busy_ms = profile_request(step, batch, what="train step")
    print(f"device busy {busy_ms:.3f} ms of the unprofiled median step "
          f"{med * 1e3:.3f} ms: busy share {busy_ms / (med * 1e3):.3f}", flush=True)
    pts_dev = torch.as_tensor(batch["points"], device=dev)
    pyr_ms = time_ms(lambda: build_pyramid(pts_dev, TRAIN_SPEC), reps=3)
    print(f"device time of the training pyramid alone {pyr_ms:.3f} ms", flush=True)

    restore(model, opt, snap0)
    torch.cuda.synchronize()
    reset_counts()
    wide_args, wide_fn = [], knn.window_topk_wide

    def rec_wide(*args, **kw):
        wide_args.append((args, kw))
        return wide_fn(*args, **kw)

    with recording() as calls, mock.patch.object(knn, "window_topk_wide", rec_wide):
        m = step(batch)
        torch.cuda.synchronize()
    launches, wide = read_counts(), knn.wide_calls
    print(f"launches in one train step: {launches}; wide-window searches "
          f"(plain PyTorch): {wide}", flush=True)
    require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
    for args, kw in wide_args:
        t = time_ms(lambda: wide_fn(*args, **kw), reps=3)
        print(f"  wide-window search k={args[2]} M={args[0].shape[1]} "
              f"W={kw['width'] * kw['tile']}: {t:.4f} ms", flush=True)
    loss_k, gn_k = float(m["loss"]), grad_norm(model)
    require(np.isfinite(loss_k) and np.isfinite(gn_k), f"loss {loss_k}, grad norm {gn_k}")
    restore(model, opt, snap0)
    with plain_kernels():
        m = step(batch)
    loss_p, gn_p = float(m["loss"]), grad_norm(model)
    print(f"kernels vs plain, same weights and batch: loss {loss_k:.7f} vs {loss_p:.7f} "
          f"(rel {abs(loss_k - loss_p) / abs(loss_p):.3g}), gradient norm {gn_k:.7f} vs "
          f"{gn_p:.7f} (rel {abs(gn_k - gn_p) / gn_p:.3g})", flush=True)
    require(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p), "train losses disagree")
    require(abs(gn_k - gn_p) <= 1e-3 * gn_p, "gradient norms disagree")
    return dict(calls=calls, launches=launches, model=model, step=step)


def check_train_kernels(dev, train) -> list:
    """Phase 8: every kernel call of one train step on integer-grid clouds
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
    return time_calls(train["calls"], dev, train["launches"], max_err, tuple(WRAPPERS), reps=5)


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

    ds = room0()
    ev_serve = VotingEvaluator(ds, None, NUM_CLASSES, N, batch_size=B, voxel_size=0.04, seed=0)
    crops, batch = ev_serve.next_batch(np.random.default_rng(0), ev_serve.clouds)

    with phase("kernels"):
        grid = grid_cloud(np.random.default_rng(1), B, N)
        topk_err = check_kernels(dev, [("integer grid", grid, True),
                                       ("synthetic crop", batch["points"], False)])

    with phase("serve"):
        model, trained = load_model()
        step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=NUM_CLASSES)

        def predict(bt):
            probs, _ = step(bt)
            return probs.cpu().numpy()

        predict(batch)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        with recording() as calls:
            probs, conf = step(batch)
            torch.cuda.synchronize()
        launches = {k: v for k, v in read_counts().items() if k in SERVE_KERNELS}
        print(f"launches in one request: {launches}", flush=True)
        require(all(v > 0 for v in launches.values()), f"a kernel was not launched: {launches}")
        require(bool(torch.isfinite(probs).all()) and probs.shape == (B, N, NUM_CLASSES),
                f"probs {tuple(probs.shape)} not finite")

        torch.cuda.reset_peak_memory_stats()
        lat = []
        for _ in range(3):
            t0 = time.perf_counter()
            predict(batch)
            lat.append(time.perf_counter() - t0)
        med = statistics.median(lat)
        print(f"request latency median {med * 1e3:.3f} ms over {[round(x * 1e3, 3) for x in lat]}, "
              f"{B * N / med:.1f} points/s, max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} B", flush=True)

        with plain_kernels():
            p_plain, _ = step(batch)
        d = float((probs - p_plain).abs().max())
        agree = float((probs.argmax(-1) == p_plain.argmax(-1)).float().mean())
        print(f"kernels vs plain: max|dprobs| {d:.3g}, argmax agreement {agree:.6f}", flush=True)
        require(d <= 1e-3 and agree >= 0.999, "kernel and plain runs disagree")
        conf = conf.cpu().numpy()
        oa = float(np.trace(conf) / conf.sum())
        print(f"crop OA {oa:.4f} ({'trained' if trained else 'random'} weights)", flush=True)
        if trained:
            require(oa >= 0.5, f"crop OA {oa:.4f} < 0.5")

    with phase("timing"):
        max_err = {"window_topk": topk_err, "window_gather": 0.0}
        serve_summary = time_calls(calls, dev, launches, max_err, SERVE_KERNELS)
        del calls

    with phase("profile"):
        pts_dev = torch.as_tensor(batch["points"], device=dev)
        pyr_ms = time_ms(lambda: build_pyramid(pts_dev, PyramidSpec()), reps=3)
        step_ms = time_ms(lambda: step(batch), reps=3)
        print(f"device time: pyramid {pyr_ms:.3f} ms, whole step {step_ms:.3f} ms", flush=True)
        profile_request(step, batch)

    with phase("voting"):
        ev = VotingEvaluator(room0(), predict, NUM_CLASSES, N, batch_size=B,
                             voxel_size=0.04, num_votes=20, seed=0)
        t0 = time.perf_counter()
        m = ev.run(max_steps=3)
        per = (time.perf_counter() - t0) / 3
        print(f"voting: {per * 1e3:.3f} ms per request over 3 requests "
              f"(sub mIoU so far {m['sub']['mIoU']:.4f})", flush=True)

    del model, step, ev, ev_serve
    torch.cuda.empty_cache()
    with phase("train"):
        train = run_train(dev)

    with phase("train-kernels"):
        summary = []
        for entry in check_train_kernels(dev, train):
            serve = next((e for e in serve_summary if e["name"] == entry["name"]), None)
            if serve is None:
                summary.append(entry)
            else:
                summary.append({**serve, "train": {k: entry[k] for k in (
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
