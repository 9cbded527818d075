"""Checkpointing: periodic and best snapshots, partial restore with regex
select/except patterns, latest/best discovery (counterpart of
contrastboundary_tpu/train/checkpoint.py).

The layout is the JAX package's: ``snap-<step>`` every save, the best
snapshot named by ``best.json`` ({"step", "mIoU"}; the reference's
``snap-best``), ``max_to_keep`` snapshots kept besides the best, and
``find_best_snapshot`` across the ``Log_*`` runs of an experiment. A
snapshot is one ``torch.save`` file of the model's parameters and buffers
(running and stale BN statistics), the optimizer's state and the step; it
is read back with ``map_location='cpu'`` and copied into the live model and
optimizer, so a snapshot written on the card loads on the CPU. Across the
ranks of a process group rank 0 writes (the ranks hold the same state) and
every rank waits for it; every rank restores.

The JAX package's snapshots are orbax directories, which the port does not
read; the JAX trainer's flax ``.pkl`` checkpoints load through
models/convert.py::load_checkpoint.
"""
from __future__ import annotations

import json
import os
import re
from typing import List, Optional, Sequence, Tuple

import torch

from ..models.convert import flax_path
from ..parallel.mesh import barrier, process_index
from .debug import tree_finite


def find_best_snapshot(exp_dir: str) -> Optional[dict]:
    """Globally best snapshot across the runs of an experiment directory:
    each run records its best in ``checkpoints/best.json`` at save time;
    this scans ``exp_dir`` itself and its ``Log_*`` runs and returns
    {'path', 'step', 'mIoU', 'run'} for the highest recorded mIoU, or None.
    Markers without a recorded mIoU rank lowest but still count."""
    exp_dir = os.path.abspath(exp_dir)
    run_dirs = [exp_dir] + sorted(
        os.path.join(exp_dir, d)
        for d in (os.listdir(exp_dir) if os.path.isdir(exp_dir) else [])
        if d.startswith("Log_") and os.path.isdir(os.path.join(exp_dir, d))
    )
    best = None
    for run in run_dirs:
        marker = os.path.join(run, "checkpoints", "best.json")
        if not os.path.exists(marker):
            continue
        try:
            with open(marker) as f:
                info = json.load(f)
        except (OSError, ValueError):
            continue
        path = os.path.join(run, "checkpoints", f"snap-{int(info['step'])}")
        if not os.path.exists(path):
            continue
        miou = float(info.get("mIoU", float("-inf")))
        if best is None or miou > best["mIoU"]:
            best = {"path": path, "step": int(info["step"]), "mIoU": miou, "run": run}
    return best


def _state_names(model: torch.nn.Module, optimizer) -> Tuple[dict, List[str]]:
    """{state_dict key: flax name} of the model ('params/…', 'batch_stats/…')
    and the flax path (without its collection) of each optimizer parameter
    index, in the order of the optimizer's state_dict."""
    names = {k: "/".join(flax_path(model, k)) for k in model.state_dict()}
    if optimizer is None:
        return names, []
    by_id = {id(p): k for k, p in model.named_parameters()}
    params = [p for group in optimizer.param_groups for p in group["params"]]
    return names, ["/".join(flax_path(model, by_id[id(p)])[1:]) for p in params]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, tag) -> str:
        return os.path.join(self.directory, f"snap-{tag}")

    def save(self, step: int, model: torch.nn.Module, optimizer=None, best: bool = False,
             metric: Optional[float] = None, check_finite: bool = True) -> str:
        """Save the model's parameters and buffers, the optimizer's state and
        the step as ``snap-<step>`` (written to a temporary file, then
        renamed); mark it best where ``best``, with ``metric`` (the
        validation mIoU) recorded for cross-run discovery. ``check_finite``
        (default on) refuses to write a snapshot with a non-finite
        parameter or statistic. Rank 0 writes, then every rank waits for it.
        Returns the snapshot's path."""
        if check_finite and not tree_finite(model.state_dict().values()):
            raise FloatingPointError(
                f"refusing to save snap-{int(step)}: non-finite values in the parameters or "
                "statistics (pass check_finite=False to override; see train.debug.nan_report)")
        path = self._path(int(step))
        if process_index() == 0:
            payload = {"step": int(step), "model": model.state_dict(),
                       "optimizer": None if optimizer is None else optimizer.state_dict()}
            torch.save(payload, path + ".tmp")
            os.replace(path + ".tmp", path)
            if best:
                marker = {"step": int(step)}
                if metric is not None:
                    marker["mIoU"] = float(metric)
                with open(os.path.join(self.directory, "best.json"), "w") as f:
                    json.dump(marker, f)
            self._gc()
        barrier()
        return path

    def best_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "best.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(json.load(f)["step"])

    def _gc(self):
        keep_best = self.best_step()
        for s in self.steps()[: -self.max_to_keep]:
            if s != keep_best:
                os.remove(self._path(s))

    def steps(self) -> Sequence[int]:
        out = []
        for d in os.listdir(self.directory):
            m = re.match(r"^snap-(\d+)$", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def resolve(self, which: str = "auto") -> Optional[str]:
        """'auto' → latest step snapshot; 'best' → the best.json step's; else
        a path (None where it does not exist)."""
        if which == "best":
            s = self.best_step()
            if s is None:
                return None
            p = self._path(s)
            return p if os.path.exists(p) else None
        if which in ("auto", "latest", ""):
            steps = self.steps()
            return self._path(steps[-1]) if steps else None
        return which if os.path.exists(which) else None

    def load(self, which: str = "auto") -> dict:
        """The snapshot's payload {"step", "model", "optimizer"} on the CPU."""
        path = self.resolve(which)
        if path is None:
            raise FileNotFoundError(f"no checkpoint for {which!r} in {self.directory}")
        if os.path.isdir(path):
            raise NotImplementedError(
                f"{path} is an orbax snapshot of the JAX package, which the port does not read; "
                "load a flax .pkl checkpoint with models/convert.py::load_checkpoint")
        return torch.load(path, map_location="cpu", weights_only=True)

    def restore(self, model: torch.nn.Module, optimizer=None, which: str = "auto",
                select: Optional[Sequence[str]] = None,
                except_: Optional[Sequence[str]] = None) -> Tuple[int, List[str]]:
        """Copy a snapshot into ``model`` (and ``optimizer``) in place →
        (the snapshot's step, or None where 'step' is not taken; the skipped
        names).

        select/except_: regex lists searched in each leaf's flax name (the
        JAX package's names: 'step', 'params/<module path>/kernel|bias|scale',
        'batch_stats/<module path>/mean|var', and each optimizer state
        tensor as 'opt_state/<state key>/<module path>/<leaf>', e.g.
        'opt_state/momentum_buffer/enc0_down/Dense_0/kernel'). A leaf is
        taken if some select pattern matches and no except pattern does;
        the others keep their current values and are reported, as the JAX
        version reports them."""
        payload = self.load(which)
        sel = [re.compile(p) for p in (select or [".*"])]
        exc = [re.compile(p) for p in (except_ or [])]
        skipped: List[str] = []

        def take(name: str) -> bool:
            ok = any(p.search(name) for p in sel) and not any(p.search(name) for p in exc)
            if not ok:
                skipped.append(name)
            return ok

        names, opt_paths = _state_names(model, optimizer)
        current = model.state_dict()
        loaded = payload["model"]
        if set(loaded) != set(current):
            raise ValueError(f"snapshot and model differ in {sorted(set(loaded) ^ set(current))}")
        step = payload["step"] if take("step") else None
        model.load_state_dict({k: loaded[k] if take(names[k]) else v
                               for k, v in current.items()})
        if optimizer is not None and payload["optimizer"] is not None:
            sd = optimizer.state_dict()
            merged = {i: dict(s) for i, s in sd["state"].items()}
            for i, state in payload["optimizer"]["state"].items():
                for key, v in state.items():
                    if take(f"opt_state/{key}/{opt_paths[i]}"):
                        merged.setdefault(i, {})[key] = v
            optimizer.load_state_dict({"state": merged, "param_groups": sd["param_groups"]})
        return step, skipped
