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

It prints the card's name and power limit, one JSON line of per-kernel
numbers (times in ms per request: the sum over that request's launches),
and as its last line {"ok": true, "device": {...}}. Without CUDA it exits
with 2 before doing anything.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from contrastboundary_tpu_torch.data.synthetic import SyntheticSceneDataset
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator
from contrastboundary_tpu_torch.kernels import build
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, load_checkpoint, load_jax_variables,
)
from contrastboundary_tpu_torch.ops import PyramidSpec, build_pyramid
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from contrastboundary_tpu_torch.ops.cuda import win_topk as wt

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
}


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
    """Record every window_topk / window_gather call (arguments and the
    kernel's outputs) made through the ops modules while active."""
    calls = {"window_topk": [], "window_gather": []}
    topk, gather = wt.window_topk, tg.window_gather

    def rec_topk(query, support, k, **kw):
        out = topk(query, support, k, **kw)
        calls["window_topk"].append(((query, support, k), kw, out))
        return out

    def rec_gather(x, local_idx, starts, tile, width):
        out = gather(x, local_idx, starts, tile, width)
        calls["window_gather"].append(((x, local_idx, starts, tile, width), {}, out))
        return out

    with mock.patch.object(wt, "window_topk", rec_topk), \
            mock.patch.object(tg, "window_gather", rec_gather):
        yield calls


@contextmanager
def plain_kernels():
    """Swap both kernels for their plain PyTorch versions."""
    with mock.patch.object(wt, "window_topk", wt.window_topk_plain), \
            mock.patch.object(tg, "window_gather", tg.window_gather_plain):
        yield


def reset_counts():
    wt.launches = 0
    tg.launches = 0


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


def time_calls(calls, dev, launches, max_err) -> list:
    """Phase 4: hold each recorded launch of the request against the plain
    version, then time it; per-kernel sums per request."""
    flush_buf = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB > L2
    summary = []
    for name in ("window_topk", "window_gather"):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, t_bytes=0.0, t_ops=0.0)
        for call in calls[name]:
            args, kw, out = call
            if name == "window_topk":
                max_err[name] = max(max_err[name], compare_topk(call, exact=False))
                query, support, k = args
                kern = lambda: wt.window_topk(query, support, k, **kw)
                plain = lambda: wt.window_topk_plain(query, support, k, **kw)
                lib = topk_library_call(query, support, k, **kw)
                b, m, _ = query.shape
                w_sz = kw["width"] * kw["tile"]
                n_bytes = 4 * (query.numel() + support.numel()) + 8 * b * m * k
                n_ops = 10.0 * b * m * w_sz  # 9 FLOPs of distance + 1 compare a pair
                shape = dict(k=k, B=b, M=m, Ns=support.shape[1], W=w_sz, mode=kw.get("mode", "plain"))
            else:
                max_err[name] = max(max_err[name], compare_gather(call))
                x, li, starts, tile, width = args
                kern = lambda: tg.window_gather(x, li, starts, tile, width)
                plain = lambda: tg.window_gather_plain(x, li, starts, tile, width)
                lib = gather_library_call(*args)
                n_bytes = 4 * (x.numel() + li.numel() + starts.numel() + out.numel())
                n_ops = 0.0
                shape = dict(x=list(x.shape), idx=list(li.shape), W=tile * width)
            t_k, t_p, t_l = (time_ms(f, flush_buf) for f in (kern, plain, lib))
            bnd, t_b, t_o = bound_ms(n_bytes, n_ops)
            print(f"  {name} {shape}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                  f"library {t_l:.4f} ms, bound {bnd:.5f} ms", flush=True)
            for key, v in (("ms", t_k), ("plain_ms", t_p), ("library_ms", t_l),
                           ("bound_ms", bnd), ("t_bytes", t_b), ("t_ops", t_o)):
                tot[key] += v
        summary.append(dict(
            name=name, route="cuda", **KERNELS[name], launches=launches[name],
            max_abs_err=max_err[name], ms=tot["ms"], plain_ms=tot["plain_ms"],
            bound_ms=tot["bound_ms"],
            bound_by="operations" if tot["t_ops"] > tot["t_bytes"] else "bytes",
            library_ms=tot["library_ms"],
        ))
    return summary


def profile_request(step, batch, top=12):
    """One request under torch.profiler: device time by kernel name and the
    device's busy share of the request's wall time."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    events = sorted(kernels, key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"profiled request: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle share {1 - busy_ms / wall_ms:.3f})", flush=True)
    for e in events[:top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}", flush=True)


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
        launches = {"window_topk": wt.launches, "window_gather": tg.launches}
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
        summary = time_calls(calls, dev, launches, max_err)
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

    print(f"total {time.perf_counter() - t_start:.3f} s", flush=True)
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
