"""Same-call A/B of the port's cbl_stats_fwd, cbl_stats_bwd, pt_attn_fwd,
pt_attn_bwd, cbl_tile2_fwd, cbl_tile2_bwd, cbl_tile_fwd and cbl_tile_bwd
CUDA kernels against another checkout's, on one card.

    python3 scripts/ab_torch_kernels.py --parent DIR [--reps 10] [--ptxas]
        [--only PART ...]

from the repository root, on a machine with a CUDA card, nvcc and the
trained checkpoint; DIR is the root of another checkout of the repository
(for example the parent commit, unpacked with
``git archive <commit> | tar -x -C DIR`` into a directory .gitignore lists).
Its kernel package is copied beside it as ``cbt_parent`` and built from its
own sources. The script records the cbl_stats_fwd and cbl_stats_bwd calls of
one batch-BN flagship train step (dense CBL route), the pt_attn_fwd and
pt_attn_bwd calls of one stale-BN train step, the cbl_tile2_fwd and
cbl_tile2_bwd calls of one batch-BN step on the v2 route (CBL_DENSE=off,
ContrastConfig(impl='pallas')) and that step's five CBL stage inputs (v1
runs on [soft labels | latents] with a seeded cotangent, as a step on v1
would), B=2 x N=65536 from the checkpoint, and the pt_attn_fwd calls of one
stale-BN served request (chip_smoke.py's setup), then for each call runs the other checkout's kernel ("old") and this tree's
("new") through their bare C entries on the same operands, each with its
checkout's own entry signature and launch geometry, in the order old, new,
new, old, each the mean of --reps runs after an L2 flush. --only runs some
of the parts (stats_fwd, stats_bwd, attn, tile2, tile1; all by default). It
checks on every call:
- cbl_stats_fwd: the new stats equal bit for bit to the old kernel's (all
  eight lanes; only reported with --old-may-differ), to a second run of
  the new kernel and to the new kernel's L2 path (the window read through
  L2, as for windows beyond shared memory; timed against the staged path
  in the order staged, L2, L2, staged), counts exact and sums within rel
  1e-5 of the plain version;
- pt_attn_fwd: out, s1 and s2 of the new kernel within 1e-4 of their scale
  of the plain version's and the same bits twice;
- pt_attn_bwd: dq, dkv and the 12 parameter gradients of the new kernel within
  1e-4 of their scale of the plain version's, and dkv exact on integer
  cotangents (chip_smoke.py's checks);
- cbl_stats_bwd: the new gradient equal bit for bit to the old kernel's
  (both scatter without atomics, in slot order);
- cbl_tile2_fwd: the new stats equal bit for bit to the old kernel's on the
  rows of the loss mask (all eight lanes), and in lanes 3, 4 and 6 on every
  row, lane 5 equal in value (0 outside the mask; the old kernel wrote
  loss·0, -0 where the loss is -0); outside the mask the new lanes 0-2 are
  the fill (0, 0, 0); chip_smoke.py's checks against the plain version;
- cbl_tile2_bwd: the new gradient the same bits on a second run, and within
  1e-5 of its scale of the old kernel's (whose atomics reorder the sums);
  chip_smoke.py's checks against the plain version. The old kernel adds
  onto a gradient its wrapper zeroes first: that fill is timed beside it.
- cbl_tile_fwd (v1): the new stats equal bit for bit to the old kernel's in
  lanes 0-2 and 5 on the rows of the loss mask, and in lanes 3, 4 and 6
  (the counts and the mask) on every row; chip_smoke.py's checks against
  the plain version;
- cbl_tile_bwd (v1, both on the new forward's statistics): the new
  gradient the same bits on a second run and within 1e-5 of its scale of
  the old kernel's (whose atomics reorder the sums); chip_smoke.py's checks
  (the plain version, zero label columns, the feature columns v2's backward
  bit for bit). The old gradient's zero fill is timed beside it.
It prints one line a call, the sums a step or request (the attention per
width too), the level-0 attention, v2 and v1 calls 20 times each through the
old and the new wrapper (ops/cuda/pt_attn.py, ops/cuda/cbl_tile2.py,
ops/cuda/cbl_tile.py; v1 through both bare entries too) and,
for the attention forward, the autograd entry (ops/pt_attn.py::pt_attn,
which also makes the window starts), and the card's name and power limit;
any failed check raises. --ptxas first prints nvcc's register and spill
report of the sources.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import shutil
import subprocess
import sys
from collections import defaultdict
from contextlib import ExitStack
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from contrastboundary_tpu_torch.data.synthetic import SyntheticSceneDataset, train_batch  # noqa: E402
from contrastboundary_tpu_torch.eval.step import make_eval_step  # noqa: E402
from contrastboundary_tpu_torch.eval.voting import VotingEvaluator  # noqa: E402
from contrastboundary_tpu_torch.kernels import build  # noqa: E402
from contrastboundary_tpu_torch.losses import ContrastConfig  # noqa: E402
from contrastboundary_tpu_torch.ops.cuda import cbl_dense as cd  # noqa: E402
from contrastboundary_tpu_torch.ops.cuda import cbl_tile as c1  # noqa: E402
from contrastboundary_tpu_torch.ops.cuda import cbl_tile2 as c2  # noqa: E402
from contrastboundary_tpu_torch.ops import PyramidSpec  # noqa: E402
from contrastboundary_tpu_torch.ops import pt_attn as attn  # noqa: E402
from contrastboundary_tpu_torch.ops.cuda import pt_attn as pa  # noqa: E402
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step  # noqa: E402

OLD_PKG = "cbt_parent"
PARTS = ("stats_fwd", "stats_bwd", "attn", "tile2", "tile1")


def load_old(parent: Path):
    """The other checkout's kernel package, imported as cbt_parent from a copy
    under _local/ (its build lands in that copy)."""
    dest = ROOT / "_local" / "ab_parent"
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(parent / "contrastboundary_tpu_torch", dest / OLD_PKG,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    sys.path.insert(0, str(dest))
    names = ("kernels.build", "ops.cuda.cbl_dense", "ops.cuda.pt_attn", "ops.pt_attn",
             "ops.cuda.cbl_tile2", "ops.cuda.cbl_tile")
    return tuple(importlib.import_module(f"{OLD_PKG}.{name}") for name in names)


def ptxas_report():
    """nvcc's resource report (registers, spills, shared memory) of the two
    sources, compiled as the build compiles them."""
    for src in ("cbl_dense.cu", "pt_attn.cu", "cbl_tile2.cu"):
        res = subprocess.run(
            [build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
             "-Xptxas", "-v", "-c", "-o", "/dev/null", str(build.CSRC / src)],
            capture_output=True, text=True, timeout=600)
        print(f"ptxas {src} (rc {res.returncode}):", flush=True)
        for line in res.stderr.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "error" in line:
                print("  " + line.strip(), flush=True)


def record_request(dev) -> dict:
    """The kernel calls of one stale-BN served request (chip_smoke.py's
    phase stale-serve)."""
    model, _ = cs.load_model("stale")
    step = make_eval_step(model, PyramidSpec(), device=dev, num_classes=cs.NUM_CLASSES)
    ev = VotingEvaluator(cs.room0(), None, cs.NUM_CLASSES, cs.N, batch_size=cs.B,
                         voxel_size=0.04, seed=0)
    _, batch = ev.next_batch(np.random.default_rng(0), ev.clouds)
    step(batch)  # warm-up
    with cs.recording() as calls:
        step(batch)
        torch.cuda.synchronize()
    return calls


def record(dev, bn_mode: str, route: str = "dense", stage_inputs=None) -> dict:
    """The kernel calls of one flagship train step (on a CBL route of
    chip_smoke.CBL_ROUTES); on the v2 route, its CBL stage inputs appended
    to ``stage_inputs`` where given."""
    model, _ = cs.load_model(bn_mode)
    opt = make_optimizer(model.parameters(), cs.TRAIN_LR)
    cfg = TrainStepConfig(num_classes=cs.NUM_CLASSES, spec=cs.TRAIN_SPEC,
                          contrast=ContrastConfig(impl=cs.CBL_ROUTES[route][1]))
    step = make_train_step(model, cfg, opt, device=dev)
    rooms = SyntheticSceneDataset(num_rooms=16, points_per_room=120_000, seed=0, split="train")
    batch = train_batch(rooms, cs.B, cs.N, np.random.default_rng(0))
    v2_fn = cs.cbl_losses.cbl_tile_softnn2

    def rec_v2(*args, **kw):
        stage_inputs.append(cs.frozen(args))
        return v2_fn(*args, **kw)

    with cs.cbl_route_env(route):
        step(batch)  # warm-up
        with cs.recording() as calls, ExitStack() as stack:
            if stage_inputs is not None:
                stack.enter_context(mock.patch.object(cs.cbl_losses, "cbl_tile_softnn2", rec_v2))
            step(batch)
            torch.cuda.synchronize()
    return calls


def stats_entries(call, old_lib, old_cd):
    """(old entry, new entry, the new entry through L2, their outputs) of a
    cbl_stats_fwd call; the old entry with its own launch plan where it
    takes one (fwd_plan), the L2 one with the new plan but 0 shared bytes
    (the path of windows beyond shared memory)."""
    features, meta, li, temperature, tile, width, window = call[0]
    f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
    b, m, c = f.shape
    k = lii.shape[-1]
    inv_t = cd._inv_t(temperature)
    stream = torch.cuda.current_stream(f.device).cuda_stream
    out_old, out_new = torch.empty((b, m, 8), device=f.device), torch.empty((b, m, 8), device=f.device)
    blocks, threads, smem = cd.fwd_plan(b, m, k, tile, width)
    ptrs = (f.data_ptr(), mt.data_ptr(), lii.data_ptr())
    o_plan = old_cd.fwd_plan(b, m, k, tile, width) if hasattr(old_cd, "fwd_plan") else ()
    old = lambda: old_lib.cbl_stats_fwd(*ptrs, out_old.data_ptr(), b, m, k, c, tile, width,
                                        window, inv_t, *o_plan, stream)
    out_l2 = torch.empty_like(out_new)
    entry = lambda out, sm: (lambda: build.library().cbl_stats_fwd(
        *ptrs, out.data_ptr(), b, m, k, c, tile, width, window, inv_t, blocks, threads, sm,
        stream))
    new, l2 = entry(out_new, smem), entry(out_l2, 0)
    shape = dict(M=m, K=k, tile=tile, width=width, plan=(blocks, threads, smem))
    return old, new, l2, out_old, out_new, out_l2, shape


def _geometry(plan) -> tuple:
    """A tile plan's launch arguments (blocks, threads, rows a tile[, slots
    a chunk], shared bytes): a plan without chunks has no slot argument."""
    chunk = (plan.chunk,) if hasattr(plan, "chunk") else ()
    return (plan.blocks, plan.threads, plan.rows) + chunk + (plan.smem,)


def elem_arg(entry, q) -> tuple:
    """The element-size argument of an attention C entry that takes one
    (entries from before bfloat16 q and kv have one parameter fewer than
    build.SIGNATURES gives)."""
    full = len(build.SIGNATURES[entry.__name__])
    return (q.element_size(),) if len(entry.argtypes) == full else ()


def attn_entries(name, call, old_lib, old_pa):
    """(old entry, new entry, operands kept alive, shape) of a pt_attn_fwd or
    pt_attn_bwd call, each checkout with its own launch geometry: its tile
    plan, or for the old row-group forward its wrapper's grid and rows a
    group."""
    q, kv, rel, li, starts, tile, width, params = call[0][:8]
    (q, kv, rel, li, st), ps, (b, m, k, c, cs_) = pa._cuda_args(
        q, kv, rel, li, starts, tile, width, params)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (ctypes.c_void_p * 12)(*(p.data_ptr() for p in ps))
    head = (q.data_ptr(), kv.data_ptr(), rel.data_ptr(), li.data_ptr(), st.data_ptr(),
            ctypes.cast(ptrs, ctypes.c_void_p))
    dims = (b, m, k, c, tile, width)
    if name == "pt_attn_fwd":
        plan = pa.fwd_plan(b, m, k, c)
        if hasattr(old_pa, "fwd_plan"):
            o_plan = old_pa.fwd_plan(b, m, k, c)
            o_geo, o_rows = _geometry(o_plan), o_plan.blocks
        else:  # the row-group forward: its wrapper's grid and rows a group
            o_rpb = max(1, 256 // c)
            o_grid = min(-(-b * m // o_rpb), old_pa.SM_COUNT * (2048 // (c * o_rpb)))
            o_geo, o_rows = (o_grid, o_rpb), o_grid * o_rpb
        out = torch.empty_like(q)
        st_old = torch.empty((o_rows, 2 * c + 2 * cs_), device=q.device)
        st_new = torch.empty((plan.blocks, 2 * c + 2 * cs_), device=q.device)
        o_elem, elem = (elem_arg(lib.cbl_pt_attn_fwd, q) for lib in (old_lib, build.library()))
        old = lambda: old_lib.cbl_pt_attn_fwd(*head, out.data_ptr(), st_old.data_ptr(), *dims,
                                              *o_geo, *o_elem, stream)
        new = lambda: build.library().cbl_pt_attn_fwd(*head, out.data_ptr(), st_new.data_ptr(),
                                                      *dims, *_geometry(plan), *elem, stream)
        keep = (out, st_old, st_new)
    else:
        plan = pa.bwd_plan(b, m, k, c)
        o_plan = old_pa.bwd_plan(b, m, k, c)
        g = call[0][8].to(q.dtype).contiguous()
        prow = sum(pa._prow(c, cs_))
        # float32 dq and dk|dv (dkv is added to, not zeroed)
        dq = torch.empty_like(q, dtype=torch.float32)
        dkv = torch.zeros_like(kv, dtype=torch.float32)
        dp_old = torch.empty((o_plan.blocks, prow), device=q.device)
        dp_new = torch.empty((plan.blocks, prow), device=q.device)
        grads = (g.data_ptr(), dq.data_ptr(), dkv.data_ptr())
        o_elem, elem = (elem_arg(lib.cbl_pt_attn_bwd, q) for lib in (old_lib, build.library()))
        old = lambda: old_lib.cbl_pt_attn_bwd(*head, *grads, dp_old.data_ptr(), *dims,
                                              *_geometry(o_plan), *o_elem, stream)
        new = lambda: build.library().cbl_pt_attn_bwd(*head, *grads, dp_new.data_ptr(), *dims,
                                                      *_geometry(plan), *elem, stream)
        keep = (g, dq, dkv, dp_old, dp_new)
    keep += (q, kv, rel, li, st, ps, ptrs)
    return old, new, keep, dict(C=c, M=m, K=k, plan=tuple(plan))


@torch.no_grad()
def ab_attn(name, calls, old_lib, old_pa, flush, reps, what):
    """Each recorded call of the attention kernel ``name`` checked against
    the plain version and A/B-timed through the bare entries; the sums per
    width and over ``what``."""
    per_width = defaultdict(lambda: [0, 0.0, 0.0])
    for call in calls:
        if name == "pt_attn_fwd":
            cs.compare_pt_attn_fwd(call)
        else:
            cs.compare_pt_attn_bwd(call)
            cs.check_pt_attn_bwd_exact(call)
        old, new, keep, shape = attn_entries(name, call, old_lib, old_pa)
        t_old, t_new, t = ab_time(old, new, flush, reps)
        w = per_width[shape["C"], shape["M"], shape["K"]]
        w[0] += 1
        w[1] += t_old
        w[2] += t_new
        print(f"{name} {shape}: old {t_old:.4f} ms, new {t_new:.4f} ms "
              f"({t_old / t_new:.2f}x; runs {[round(x, 4) for x in t]})", flush=True)
        del keep
    tot_old = sum(w[1] for w in per_width.values())
    tot_new = sum(w[2] for w in per_width.values())
    for (c, m, k), (n, t_old, t_new) in sorted(per_width.items()):
        print(f"{name} C={c} M={m} K={k}: {n} launches, old {t_old:.4f} ms, new "
              f"{t_new:.4f} ms ({t_old / t_new:.2f}x)", flush=True)
    print(f"{name}, {len(calls)} calls {what}: old {tot_old:.4f} ms, new {tot_new:.4f} ms "
          f"({tot_old / tot_new:.2f}x)", flush=True)


def wrapper_times(calls, old_pa, old_attn, flush, reps=20):
    """The level-0 (largest) attention calls, old then new then new then
    old, each reps launches after an L2 flush: the forward and the backward
    through their wrappers, the forward through the autograd entry (window
    starts included); min and median of each."""
    def spread(fn):
        ts = sorted(cs.time_ms(fn, flush, reps=1) for _ in range(reps))
        return ts[0], ts[len(ts) // 2]

    fwd = max(calls["pt_attn_fwd"], key=lambda call: call[0][0].numel())[0]
    bwd = max(calls["pt_attn_bwd"], key=lambda call: call[0][0].numel())[0]
    q, kv, rel, li, _, tile, width, params = fwd
    cases = (
        ("pt_attn_fwd wrapper", lambda mod: (lambda: mod.pt_attn_fwd(*fwd)), (old_pa, pa)),
        ("pt_attn autograd entry", lambda mod: (lambda: mod.pt_attn(q, kv, rel, li, tile, width,
                                                                    params)), (old_attn, attn)),
        ("pt_attn_bwd wrapper", lambda mod: (lambda: mod.pt_attn_bwd(*bwd)), (old_pa, pa)),
    )
    with torch.no_grad():
        for what, make, (old_mod, new_mod) in cases:
            t = [spread(make(mod)) for mod in (old_mod, new_mod, new_mod, old_mod)]
            print(f"{what} {tuple(q.shape)}, {reps} runs each: old min/median "
                  f"{[round(x, 4) for x in t[0] + t[3]]} ms, new {[round(x, 4) for x in t[1] + t[2]]}"
                  f" ms", flush=True)


def stats_bwd_entries(call, old_lib, old_cd):
    """(old entry, new entry, their gradients, shape) of a cbl_stats_bwd
    call: the same C signature, each checkout's scatter rows."""
    features, meta, li, stats, g, temperature, tile, width, window = call[0]
    f, mt, lii = cd._cuda_args(features, meta, li, tile, width)
    b, m, c = f.shape
    k = lii.shape[-1]
    stream = torch.cuda.current_stream(f.device).cuda_stream
    ops = (f, mt, lii, stats.contiguous(), g.contiguous())
    outs = {}

    def entry(lib, rows, key):
        scratch = (torch.empty((b, m, k), device=f.device),
                   torch.empty((b, m, k), dtype=torch.int32, device=f.device), torch.empty_like(f))
        outs[key] = scratch[2]
        ptrs = [t.data_ptr() for t in ops + scratch]
        return lambda _keep=scratch: lib.cbl_stats_bwd(*ptrs, b, m, k, c, tile, width, window,
                                                      cd._inv_t(temperature), rows, stream)

    old = entry(old_lib, old_cd.bwd_plan(b, m, tile)[1], "old")
    new = entry(build.library(), cd.bwd_plan(b, m, tile)[1], "new")
    return old, new, outs, dict(M=m, K=k, tile=tile, width=width)


def tile2_entries(name, call, old_lib, old_c2):
    """(old entry, new entry, their outputs, shape) of a cbl_tile2_fwd or
    cbl_tile2_bwd call, each checkout through its own entry: the old single
    kernel (window starts as an operand, the gradient added with atomics
    onto a zeroed tensor) or the new plan's."""
    args = call[0]
    features, meta, li = args[:3]
    temperature, tile, width, window = args[-4:]
    b, m, c = features.shape
    k = li.shape[-1]
    stream = torch.cuda.current_stream(features.device).cuda_stream
    fwd = name == "cbl_tile2_fwd"
    others = () if fwd else (args[3], args[4])
    shape = (b, m, 8) if fwd else (b, m, c)
    out_old = torch.zeros(shape, device=features.device)
    if hasattr(old_c2, "fwd_plan"):  # a checkout of the new design
        old = new_tile2_entry(name, old_lib, old_c2, args, out_old)
    else:
        f, lii, starts, *ops = old_c2.cuda_args(features, li, tile, width, window, meta, *others)
        ptrs = [f.data_ptr(), ops[0].data_ptr(), lii.data_ptr(), starts.data_ptr()]
        ptrs += [t.data_ptr() for t in ops[1:]] + [out_old.data_ptr()]
        keep = (f, lii, starts, ops)
        old = lambda _keep=keep: getattr(old_lib, name)(*ptrs, b, m, k, c, tile, width,
                                                        float(temperature), stream)
    out_new = torch.empty(shape, device=features.device)
    new = new_tile2_entry(name, build.library(), c2, args, out_new)
    return old, new, out_old, out_new, dict(M=m, K=k, C=c, tile=tile, width=width)


def new_tile2_entry(name, lib, mod, args, out):
    """The bare C entry of the new v2 design (module ``mod``'s plans and
    operands) writing ``out``."""
    features, meta, li = args[:3]
    temperature, tile, width, window = args[-4:]
    b, m, c = features.shape
    k = li.shape[-1]
    stream = torch.cuda.current_stream(features.device).cuda_stream
    if name == "cbl_tile2_fwd":
        ops = mod.v2_operands(features, meta, li, tile, width)
        plan = mod.fwd_plan(b, m, k, c)
        ptrs = [t.data_ptr() for t in ops] + [out.data_ptr()]
        return lambda _keep=ops: lib.cbl_tile2_fwd(
            *ptrs, b, m, k, plan.channels, tile, width, window, float(temperature),
            plan.label_rows, plan.row_rows, stream)
    ops = mod.v2_operands(features, meta, li, tile, width, args[3], args[4])
    plan = mod.bwd_plan(b, m, k, c, tile)
    scratch = (torch.empty((b, m, k), device=out.device),
               torch.empty((b, m, k), dtype=torch.int32, device=out.device))
    ptrs = [t.data_ptr() for t in ops + scratch] + [out.data_ptr()]
    return lambda _keep=(ops, scratch): lib.cbl_tile2_bwd(
        *ptrs, b, m, k, plan.pass1.channels, tile, width, window, float(temperature),
        plan.pass1.row_rows, plan.scatter_rows, stream)


def run_once(fn, what):
    build.check(fn(), what)
    torch.cuda.synchronize()


def ab_stats_bwd(dev, old_lib, old_cd, flush, reps):
    """cbl_stats_bwd, whose scatter moved into csrc/slot_scatter.cuh: the
    same bits as the old kernel on the five dense calls, and the times."""
    calls = record(dev, "batch")["cbl_stats_bwd"]
    with torch.no_grad():
        _ab_stats_bwd(calls, old_lib, old_cd, flush, reps)


def _ab_stats_bwd(calls, old_lib, old_cd, flush, reps):
    tot_old = tot_new = 0.0
    for call in calls:
        old, new, outs, shape = stats_bwd_entries(call, old_lib, old_cd)
        run_once(old, "old cbl_stats_bwd")
        run_once(new, "new cbl_stats_bwd")
        same = torch.equal(outs["old"].view(torch.int32), outs["new"].view(torch.int32))
        cs.require(same, f"cbl_stats_bwd {shape}: not the old kernel's bits")
        t_old, t_new, t = ab_time(old, new, flush, reps)
        tot_old, tot_new = tot_old + t_old, tot_new + t_new
        print(f"cbl_stats_bwd {shape}: old {t_old:.4f} ms, new {t_new:.4f} ms "
              f"({t_new / t_old - 1:+.2%}; runs {[round(x, 4) for x in t]}), the old kernel's bits",
              flush=True)
    print(f"cbl_stats_bwd, {len(calls)} calls a step: old {tot_old:.4f} ms, new {tot_new:.4f} ms "
          f"({tot_new / tot_old - 1:+.2%})", flush=True)


def ab_tile2(dev, old_lib, old_c2, flush, reps):
    """The v2 kernels on the calls of one impl='pallas' step: the checks of
    the module docstring, the times per call (one call a level) and a step,
    and the level-0 calls through both checkouts' wrappers."""
    calls = record(dev, "batch", "pallas")
    with torch.no_grad():
        _ab_tile2(calls, old_lib, old_c2, flush, reps)


def _ab_tile2(calls, old_lib, old_c2, flush, reps):
    for name in ("cbl_tile2_fwd", "cbl_tile2_bwd"):
        tot_old = tot_new = tot_fill = 0.0
        for call in calls[name]:
            if name == "cbl_tile2_fwd":
                cs.compare_tile_stats(name, call)
            else:
                cs.compare_tile_grad(name, call)
            old, new, out_old, out_new, shape = tile2_entries(name, call, old_lib, old_c2)
            run_once(old, f"old {name}")
            run_once(new, f"new {name}")
            if name == "cbl_tile2_fwd":
                bits = lambda x: x.view(torch.int32)
                mask = out_new[..., 6] > 0
                cs.require(torch.equal(bits(out_new[mask]), bits(out_old[mask])),
                           f"{name} {shape}: masked rows not the old kernel's bits")
                cs.require(torch.equal(bits(out_new[..., [3, 4, 6]]), bits(out_old[..., [3, 4, 6]]))
                           and torch.equal(out_new[..., 5], out_old[..., 5]),
                           f"{name} {shape}: lanes 3-6 differ from the old kernel's")
                cs.require(not out_new[~mask][:, :3].any(), f"{name} {shape}: not the fill")
                note = f"{int(mask.sum())} masked rows the old kernel's bits, lanes 3-6 on all"
            else:
                first = out_new.clone()
                run_once(new, f"new {name}")
                cs.require(torch.equal(first.view(torch.int32), out_new.view(torch.int32)),
                           f"{name} {shape}: runs differ")
                err = cs.compare_scaled(f"{name} {shape} vs the old kernel", out_new, out_old, 1e-5)
                note = f"the same bits twice, max|d| {err:.3g} from the old kernel"
            t_old, t_new, t = ab_time(old, new, flush, reps)
            tot_old, tot_new = tot_old + t_old, tot_new + t_new
            if name == "cbl_tile2_bwd" and not hasattr(old_c2, "fwd_plan"):
                # the old kernel adds onto a gradient its wrapper zeroes first
                fill = cs.time_ms(lambda: out_old.zero_(), flush, reps)
                tot_fill += fill
                note += f"; the old gradient's zero fill {fill:.4f} ms"
            print(f"{name} {shape}: old {t_old:.4f} ms, new {t_new:.4f} ms "
                  f"({t_old / t_new:.2f}x; runs {[round(x, 4) for x in t]}); {note}", flush=True)
        print(f"{name}, {len(calls[name])} calls a step: old {tot_old:.4f} ms, new {tot_new:.4f} ms "
              f"({tot_old / tot_new:.2f}x)" + (f"; the old with its zero fills {tot_old + tot_fill:.4f}"
                                             f" ms ({(tot_old + tot_fill) / tot_new:.2f}x)"
                                             if tot_fill else ""), flush=True)
    spread = lambda fn: sorted(cs.time_ms(fn, flush, reps=1) for _ in range(20))
    for name in ("cbl_tile2_fwd", "cbl_tile2_bwd"):
        args = max(calls[name], key=lambda call: call[0][0].numel())[0]
        t = [spread(lambda: getattr(mod, name)(*args)) for mod in (old_c2, c2, c2, old_c2)]
        print(f"{name} wrapper {tuple(args[0].shape)}, 20 runs each: old min/median "
              f"{[round(x[0], 4) for x in (t[0], t[3])]} / {[round(x[10], 4) for x in (t[0], t[3])]}"
              f" ms, new {[round(x[0], 4) for x in (t[1], t[2])]} / "
              f"{[round(x[10], 4) for x in (t[1], t[2])]} ms", flush=True)


def tile1_entries(args, g, old_lib, old_c2):
    """(old fwd, new fwd, old bwd, new bwd, outputs, operands) of a v1 call
    on fused rows: the old kernels through their entries (window starts from
    the old module's table; the old backward adds onto a gradient its
    wrapper zeroes, not zeroed between timed runs), the new ones through
    theirs with the split's and the backward's scratch. Both backward
    entries read ``out['stats']``, which the caller sets."""
    fused, li, ncls, temperature, tile, width, window = args
    b, m, columns = fused.shape
    k, c = li.shape[-1], columns - ncls
    dev, temp = fused.device, float(temperature)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lii = li.to(torch.int32).contiguous()
    starts = old_c2.window_starts_on(m, tile, width, window, dev)
    plan = c1.launch_plan(b, m, k, columns, ncls, tile)
    ch = plan.pass1.channels
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)
    out = dict(stats=empty(b, m, 8), st_old=empty(b, m, 8), st_new=empty(b, m, 8),
               dx_old=torch.zeros_like(fused), dx_new=torch.empty_like(fused))
    split = (empty(b, m, ch), empty(b, m, 8))
    scratch = split + (empty(b, m, k), empty(b, m, k, dtype=torch.int32), empty(b, m, ch))
    g = g.contiguous()
    p = lambda t: t.data_ptr()
    old_fwd = lambda: old_lib.cbl_tile_fwd(p(fused), p(lii), p(starts), p(out["st_old"]), b, m,
                                           k, c, ncls, tile, width, temp, stream)
    new_fwd = lambda: build.library().cbl_tile_fwd(
        p(fused), p(lii), *map(p, split), p(out["st_new"]), b, m, k, c, ncls, tile, width,
        window, temp, plan.pass1.label_rows, plan.pass1.row_rows, stream)
    old_bwd = lambda: old_lib.cbl_tile_bwd(p(fused), p(lii), p(starts), p(out["stats"]), p(g),
                                           p(out["dx_old"]), b, m, k, c, ncls, tile, width, temp,
                                           stream)
    new_bwd = lambda: build.library().cbl_tile_bwd(
        p(fused), p(lii), p(out["stats"]), p(g), *map(p, scratch), p(out["dx_new"]), b, m, k, c,
        ncls, tile, width, window, temp, plan.pass1.row_rows, plan.scatter_rows, stream)
    return old_fwd, new_fwd, old_bwd, new_bwd, out, (lii, starts, split, scratch, g)


def ab_tile1(dev, old_lib, old_c1, old_c2, flush, reps):
    """v1 on the five CBL stage inputs of one impl='pallas' step ([soft
    labels | latents], a seeded cotangent): the checks of the module
    docstring, the times per stage and summed, and the level-0 calls through
    both checkouts' wrappers and bare entries."""
    inputs = []
    record(dev, "batch", "pallas", inputs)
    with torch.no_grad():
        _ab_tile1(inputs, old_lib, old_c1, old_c2, flush, reps)


def _ab_tile1(inputs, old_lib, old_c1, old_c2, flush, reps):
    bits = lambda t: t.contiguous().view(torch.int32)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(cs.B), dtype=torch.float32,
                        device=inputs[0][0].device)
    tot = defaultdict(float)
    level0 = None
    for features, label_soft, li, temperature, tile, width, window in inputs:
        ncls = label_soft.shape[-1]
        fused = torch.cat([label_soft.float(), features.float()], -1).contiguous()
        args = (fused, li, ncls, temperature, tile, width, window)
        old_fwd, new_fwd, old_bwd, new_bwd, out, keep = tile1_entries(args, g, old_lib, old_c2)
        run_once(old_fwd, "old cbl_tile_fwd")
        run_once(new_fwd, "new cbl_tile_fwd")
        new, old = out["st_new"], out["st_old"]
        mask = new[..., 6] > 0
        cs.compare_tile_stats("cbl_tile_fwd", (args, {}, new))
        cs.require(torch.equal(bits(new[mask][:, [0, 1, 2, 5]]), bits(old[mask][:, [0, 1, 2, 5]])),
                   f"cbl_tile_fwd {tuple(fused.shape)}: masked rows not the old kernel's bits")
        cs.require(torch.equal(bits(new[..., [3, 4, 6]]), bits(old[..., [3, 4, 6]])),
                   f"cbl_tile_fwd {tuple(fused.shape)}: counts or mask differ from the old kernel's")
        out["stats"].copy_(new)
        run_once(old_bwd, "old cbl_tile_bwd")
        run_once(new_bwd, "new cbl_tile_bwd")
        first = out["dx_new"].clone()
        run_once(new_bwd, "new cbl_tile_bwd")
        cs.require(torch.equal(bits(first), bits(out["dx_new"])),
                   f"cbl_tile_bwd {tuple(fused.shape)}: runs differ")
        err = cs.compare_scaled(f"cbl_tile_bwd {tuple(fused.shape)} vs the old kernel",
                                out["dx_new"], out["dx_old"], 1e-5)
        bwd_args = (fused, li, out["stats"], g, ncls, temperature, tile, width, window)
        cs.compare_tile_grad("cbl_tile_bwd", (bwd_args, {}, out["dx_new"]))
        t_fwd = ab_time(old_fwd, new_fwd, flush, reps)
        t_bwd = ab_time(old_bwd, new_bwd, flush, reps)
        fill = cs.time_ms(lambda: out["dx_old"].zero_(), flush, reps)
        for key, v in (("fwd_old", t_fwd[0]), ("fwd_new", t_fwd[1]), ("bwd_old", t_bwd[0]),
                       ("bwd_new", t_bwd[1]), ("fill", fill)):
            tot[key] += v
        print(f"cbl_tile {tuple(fused.shape)} K={li.shape[-1]}, {int(mask.sum())} masked rows: "
              f"fwd old {t_fwd[0]:.4f} ms, new {t_fwd[1]:.4f} ms ({t_fwd[0] / t_fwd[1]:.2f}x; runs "
              f"{[round(x, 4) for x in t_fwd[2]]}), masked rows the old kernel's bits in lanes "
              f"0-2 and 5, counts and mask on every row; bwd old {t_bwd[0]:.4f} ms + zero fill "
              f"{fill:.4f} ms, new {t_bwd[1]:.4f} ms ({(t_bwd[0] + fill) / t_bwd[1]:.2f}x with the "
              f"fill; runs {[round(x, 4) for x in t_bwd[2]]}), the same bits twice, max|d| "
              f"{err:.3g} from the old kernel", flush=True)
        if level0 is None:
            level0 = (args, bwd_args, old_fwd, new_fwd, old_bwd, new_bwd, out, keep)
        else:
            del out, keep
    print(f"cbl_tile, {len(inputs)} stage inputs a step: fwd old {tot['fwd_old']:.4f} ms, new "
          f"{tot['fwd_new']:.4f} ms ({tot['fwd_old'] / tot['fwd_new']:.2f}x); bwd old "
          f"{tot['bwd_old']:.4f} ms + zero fills {tot['fill']:.4f} ms, new {tot['bwd_new']:.4f} ms "
          f"({tot['bwd_old'] / tot['bwd_new']:.2f}x bare, {(tot['bwd_old'] + tot['fill']) / tot['bwd_new']:.2f}x"
          f" with the fills)", flush=True)
    args, bwd_args, old_fwd, new_fwd, old_bwd, new_bwd, _, _ = level0
    spread = lambda fn: sorted(cs.time_ms(fn, flush, reps=1) for _ in range(20))
    check = lambda fn: (lambda: build.check(fn(), "entry"))
    cases = (("cbl_tile_fwd wrapper", lambda mod: (lambda: mod.cbl_tile_fwd(*args))),
             ("cbl_tile_bwd wrapper", lambda mod: (lambda: mod.cbl_tile_bwd(*bwd_args))))
    for what, make in cases:
        t = [spread(make(mod)) for mod in (old_c1, c1, c1, old_c1)]
        print(f"{what} {tuple(args[0].shape)}, 20 runs each: old min/median "
              f"{[round(x[0], 4) for x in (t[0], t[3])]} / {[round(x[10], 4) for x in (t[0], t[3])]}"
              f" ms, new {[round(x[0], 4) for x in (t[1], t[2])]} / "
              f"{[round(x[10], 4) for x in (t[1], t[2])]} ms", flush=True)
    for what, old, new in (("cbl_tile_fwd bare entry", old_fwd, new_fwd),
                           ("cbl_tile_bwd bare entry", old_bwd, new_bwd)):
        t = [spread(check(fn)) for fn in (old, new, new, old)]
        print(f"{what} {tuple(args[0].shape)}, 20 runs each: old min/median "
              f"{[round(x[0], 4) for x in (t[0], t[3])]} / {[round(x[10], 4) for x in (t[0], t[3])]}"
              f" ms, new {[round(x[0], 4) for x in (t[1], t[2])]} / "
              f"{[round(x[10], 4) for x in (t[1], t[2])]} ms", flush=True)


def ab_time(old, new, flush, reps):
    """old, new, new, old: each the mean of reps launches after an L2 flush."""
    check = lambda fn: (lambda: build.check(fn(), "entry"))
    t = [cs.time_ms(check(fn), flush, reps) for fn in (old, new, new, old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def ab_stats_fwd(dev, old_lib, old_cd, flush, args):
    """cbl_stats_fwd on the five dense calls (the module docstring's checks)."""
    calls = record(dev, "batch")["cbl_stats_fwd"]
    sums = [0.0, 0.0, 0.0, 0.0]
    for call in calls:
        cs.compare_stats_fwd(call)
        old, new, l2, out_old, out_new, out_l2, shape = stats_entries(call, old_lib, old_cd)
        t_old, t_new, t = ab_time(old, new, flush, args.reps)
        t_staged, t_l2, t2 = ab_time(new, l2, flush, args.reps)
        first = out_new.clone()
        build.check(new(), "cbl_stats_fwd")
        torch.cuda.synchronize()
        bits = lambda x: x.view(torch.int32)
        same_old = torch.equal(bits(out_new), bits(out_old))
        cs.require(torch.equal(bits(out_new), bits(first)), f"cbl_stats_fwd {shape}: runs differ")
        cs.require(same_old or args.old_may_differ, f"cbl_stats_fwd {shape}: not the old kernel's bits")
        cs.require(torch.equal(bits(out_l2), bits(out_new)),
                   f"cbl_stats_fwd {shape}: the L2 path differs from the staged path")
        for i, v in enumerate((t_old, t_new, t_staged, t_l2)):
            sums[i] += v
        print(f"cbl_stats_fwd {shape}: old {t_old:.4f} ms, new {t_new:.4f} ms "
              f"({t_old / t_new:.2f}x; runs {[round(x, 4) for x in t]}), all lanes the old "
              f"kernel's bits: {same_old}, the same bits twice; new staged {t_staged:.4f} ms, "
              f"through L2 {t_l2:.4f} ms (staged, L2, L2, staged "
              f"{[round(x, 4) for x in t2]}), the same bits", flush=True)
    print(f"cbl_stats_fwd, {len(calls)} calls a step: old {sums[0]:.4f} ms, new {sums[1]:.4f} ms "
          f"({sums[0] / sums[1]:.2f}x); new staged {sums[2]:.4f} ms, through L2 {sums[3]:.4f} ms "
          f"({sums[3] / sums[2]:.2f}x the staged)", flush=True)


def ab_attn_all(dev, old_lib, old_pa, old_attn, flush, reps):
    """pt_attn_fwd and pt_attn_bwd on a stale step's calls, their level-0
    wrappers, and pt_attn_fwd on a stale request's calls."""
    calls = record(dev, "stale")
    for name in ("pt_attn_fwd", "pt_attn_bwd"):
        ab_attn(name, calls[name], old_lib, old_pa, flush, reps, "a step")
    wrapper_times(calls, old_pa, old_attn, flush)
    del calls
    torch.cuda.empty_cache()
    ab_attn("pt_attn_fwd", record_request(dev)["pt_attn_fwd"], old_lib, old_pa, flush, reps,
            "a request")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS)
    ap.add_argument("--old-may-differ", action="store_true",
                    help="report, and do not require, that the old stats equal the new bit for bit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_torch_kernels: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)
    if args.ptxas:
        ptxas_report()
    old_build, old_cd, old_pa, old_attn, old_c2, old_c1 = load_old(args.parent.resolve())
    old_lib = old_build.library()
    build.library()
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)

    if "tile2" in args.only:
        ab_tile2(dev, old_lib, old_c2, flush, args.reps)
        torch.cuda.empty_cache()
    if "tile1" in args.only:
        ab_tile1(dev, old_lib, old_c1, old_c2, flush, args.reps)
        torch.cuda.empty_cache()
    if "stats_bwd" in args.only:
        ab_stats_bwd(dev, old_lib, old_cd, flush, args.reps)
        torch.cuda.empty_cache()
    if "stats_fwd" in args.only:
        ab_stats_fwd(dev, old_lib, old_cd, flush, args)
        torch.cuda.empty_cache()
    if "attn" in args.only:
        ab_attn_all(dev, old_lib, old_pa, old_attn, flush, args.reps)
    print(f"card: {cs.card_line()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
