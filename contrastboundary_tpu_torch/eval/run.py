"""Eval entry points: voting with the boundary suite, offline re-analysis,
and the enumeration protocol (counterparts of contrastboundary_tpu/main.py::
run_eval, ::run_boundary_suite, ::analyze and ::run_enumerate_eval, with
explicit arguments in place of a config, a mesh and a logger).

Each ``predict`` closure runs the eval step on the device and copies each of
its results to the host once per request. Across the ranks of a process
group each rank runs its rows of the request (parallel/mesh.py::
local_rows, the request's size a multiple of the world size) and the rows
of every rank are gathered back, so that every rank accumulates the same
votes: the counterpart of the JAX package's batch-sharded eval step and
its device_get. Defaults are the flagship's
(s3dis_pt_cbl): voxel 0.04 m, voxel_max 80000, n_points 65536, base radius
0.1 m, 2 votes, smoothing 0.95, 4 crops a request.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.pyramid import PyramidSpec
from ..parallel.mesh import gather_rows, local_rows
from .boundary import BoundaryEvaluator, load_eval_h5, save_eval_h5
from .enumerate import EnumerateEvaluator
from .step import make_eval_step
from .voting import VotingEvaluator


def _gathered(x):
    """Every rank's rows of ``x`` on the host, in rank order."""
    return gather_rows(x).cpu().numpy()


def zero_labels(batch) -> dict:
    """The eval step's inputs: a request carries no labels to score."""
    return {"points": batch["points"], "features": batch["features"],
            "labels": np.zeros(np.shape(batch["points"])[:2], np.int32)}


def predict_request(eval_step: Callable, batch, with_features: bool = False):
    """One request through ``eval_step`` on this rank's rows of it → the
    step's probs (or logits) of every rank's rows on the host, and with
    ``with_features`` the latents {name: [B, N, d]} as well."""
    out = eval_step(zero_labels(local_rows(batch)))
    if with_features:
        return _gathered(out[0]), {k: _gathered(v) for k, v in out[2].items()}
    return _gathered(out[0])


def run_voting_eval(model: torch.nn.Module, spec: PyramidSpec, dataset, *,
                    num_classes: int = 13, n_points: int = 65536, batch_size: int = 4,
                    voxel_size: float = 0.04, num_votes: float = 2.0, smooth: float = 0.95,
                    seed: int = 0, crop_mode: str = "count", in_radius: float = 2.0,
                    base_radius: float = 0.1, extra_ops: str = "", h5_path: str = "",
                    max_steps: int = 10_000, device="cuda", ctx: Optional[dict] = None,
                    log: Callable = print) -> dict:
    """Voting evaluation over every room of ``dataset``. 'feature' in
    ``extra_ops`` extracts the per-stage latents for the feature distances;
    'boundary' runs the boundary suite on the voted clouds ('stat' adds the
    error tables), and ``h5_path`` saves coord, label and prob per cloud.
    Pass a dict as ``ctx`` to keep the eval step and the evaluator across
    calls: each call then starts a new vote round over the accumulated
    probs."""
    ctx = ctx if ctx is not None else {}
    with_features = "feature" in extra_ops
    if "eval_step" not in ctx:
        ctx["eval_step"] = make_eval_step(model, spec, device, num_classes=num_classes,
                                          with_features=with_features)
    eval_step = ctx["eval_step"]

    def predict(batch):
        return predict_request(eval_step, batch, with_features)

    if "evaluator" not in ctx:
        ctx["evaluator"] = VotingEvaluator(
            dataset, predict, num_classes, n_points, batch_size=batch_size,
            voxel_size=voxel_size, num_votes=num_votes, smooth=smooth, seed=seed,
            crop_mode=crop_mode, in_radius=in_radius)
    ev = ctx["evaluator"]
    ev.predict_fn = predict
    ev.reset_potentials()
    m = ev.run(max_steps=max_steps,
               progress=lambda s, p: log(f"  vote step {s}, min_pot {p:.2f}"))
    log(f"val: sub mIoU {m['sub']['mIoU']:.4f} OA {m['sub']['OA']:.4f} "
        f"mACC {m['sub']['mACC']:.4f} | full mIoU {m['full']['mIoU']:.4f} "
        f"OA {m['full']['OA']:.4f}")
    if "boundary" in extra_ops:
        clouds = [{"coord": cs.coord, "label": cs.label, "prob": cs.probs,
                   "features": cs.features or None} for cs in ev.clouds]
        m.update(run_boundary_suite(clouds, num_classes, base_radius, extra_ops, log=log))
        if h5_path:
            save_eval_h5(h5_path, [{k: c[k] for k in ("coord", "label", "prob")}
                                   for c in clouds])
            log(f"saved eval artifacts to {h5_path}")
    return m


def _log_stat(st: dict, log: Callable) -> None:
    for mask_n in ("label", "pred"):
        log(f"  stat[{mask_n}]: {st[f'pct_err_on_bound_{mask_n}'] * 100:5.1f}% of error on "
            f"bound ({st[f'err_bound_{mask_n}']} bound / {st[f'err_plain_{mask_n}']} plain / "
            f"{st['err_total']} total)")


def run_boundary_suite(clouds, num_classes: int = 13, radius: float = 0.1,
                       extra_ops: str = "boundary", log: Callable = print) -> dict:
    """The boundary suite over per-cloud {coord, label, prob[, features]}
    dicts, shared by the voting eval and the offline re-analysis →
    {'boundary': ..., ['stat': ...]}."""
    bev = BoundaryEvaluator(num_classes, radius=radius)
    for c in clouds:
        bev.add_cloud(np.asarray(c["coord"]), np.asarray(c["label"]).astype(np.int64),
                      np.asarray(c["prob"]), features=c.get("features") or None)
    m: dict = {}
    br = m["boundary"] = bev.results()
    log(f"boundary: B-IoU {br['B-IoU']:.4f}")
    for which in ("bound", "plain", "ideal"):
        s = br[f"conf_{which}_label"]
        log(f"  conf_{which}: mIoU {s['mIoU']:.4f} OA {s['OA']:.4f} mACC {s['mACC']:.4f}")
    for key in ["dist_prob:kl"] + sorted(k for k in br if k.startswith("dist_latent")):
        d = br[key]
        log(f"  {key}: pos {d['pos']:.4f} neg {d['neg']:.4f} bound {d['bound_mean']:.4f} "
            f"plain {d['plain_mean']:.4f}")
    if "stat" in extra_ops:
        st = m["stat"] = bev.stat()
        _log_stat(st, log)
        for mask_n in ("label", "pred"):
            for err_t in ("FP", "FN"):
                with np.printoptions(linewidth=200):
                    log(f"  stat {mask_n} bound {err_t}: {st[f'{mask_n}-bound'][err_t]}")
                    log(f"  stat {mask_n} plain {err_t}: {st[f'{mask_n}-plain'][err_t]}")
    return m


def analyze(h5_path: str, num_classes: int = 13, radius: float = 0.1,
            extra_ops: str = "boundary-stat", log: Callable = print) -> dict:
    """Offline re-analysis: the boundary suite from an h5 file written by
    ``run_voting_eval``, without a model; the same numbers as the run that
    wrote it."""
    if not h5_path:
        raise ValueError("analyze needs the path of a saved eval h5 file")
    clouds = load_eval_h5(h5_path)
    log(f"analyze: {len(clouds)} clouds from {h5_path}")
    if "boundary" not in extra_ops:
        extra_ops = "boundary-" + extra_ops
    return run_boundary_suite(clouds, num_classes, radius, extra_ops, log=log)


def run_enumerate_eval(model: torch.nn.Module, spec: PyramidSpec, dataset, *,
                       num_classes: int = 13, n_points: int = 65536, voxel_size: float = 0.04,
                       voxel_max: int = 80000, batch_size: int = 4, seed: int = 0,
                       base_radius: float = 0.1, extra_ops: str = "", device="cuda",
                       ctx: Optional[dict] = None, log: Callable = print) -> dict:
    """The whole-scene enumeration protocol: every point of every room gets
    a prediction, logits accumulated across passes. 'boundary' in
    ``extra_ops`` runs the boundary suite on the softmax of the accumulated
    logits ('stat' adds the error tables). ``ctx``, where given, receives
    the eval step and the evaluator (a step already in it is used)."""
    ctx = ctx if ctx is not None else {}
    if "eval_step" not in ctx:
        ctx["eval_step"] = make_eval_step(model, spec, device, num_classes=num_classes,
                                          output="logits")
    eval_step = ctx["eval_step"]

    def predict(batch):
        return predict_request(eval_step, batch)

    ev = ctx["evaluator"] = EnumerateEvaluator(
        dataset, predict, num_classes, n_points, batch_size=batch_size,
        voxel_size=voxel_size, voxel_max=voxel_max, seed=seed)
    m = ev.run(progress=lambda r, p: log(f"  room {r}: {p} parts predicted"))
    log(f"enumerate val: full mIoU {m['full']['mIoU']:.4f} OA {m['full']['OA']:.4f} "
        f"mACC {m['full']['mACC']:.4f}")
    if "boundary" in extra_ops:
        bev = BoundaryEvaluator(num_classes, radius=base_radius)
        for coord, lab, lg in zip(ev.coords, ev.labels, ev.logits):
            e = np.exp(lg - lg.max(-1, keepdims=True))
            bev.add_cloud(coord, lab, e / e.sum(-1, keepdims=True))
        br = m["boundary"] = bev.results()
        log(f"enumerate boundary: B-IoU {br['B-IoU']:.4f}")
        if "stat" in extra_ops:
            m["stat"] = bev.stat()
            _log_stat(m["stat"], log)
    return m
