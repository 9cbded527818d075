"""NaN debugging: per-variable non-finite shares and reproducer dumps
(counterpart of contrastboundary_tpu/train/debug.py). When a non-finite
loss appears, the share of non-finite entries of every parameter, running
statistic and input is reported and a reproducer (the batch, the
parameters under their flax names, the step) is pickled for offline
analysis.
"""
from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch

from ..models.convert import to_jax_variables


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree: Any, prefix: Tuple = ()) -> Iterable[Tuple[Tuple, Any]]:
    """(path, leaf) of a nested mapping (a flax tree, a batch)."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def tree_finite(tensors: Iterable[torch.Tensor]) -> bool:
    """True iff every floating tensor is entirely finite: one reduction on
    the device, one scalar copied back."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


def nan_report(tree: Any, prefix: str = "") -> Dict[str, float]:
    """Share of non-finite entries per floating leaf of a nested mapping of
    arrays or tensors (only leaves with any), under '/'-joined names."""
    out: Dict[str, float] = {}
    for path, leaf in _leaves(tree):
        arr = _host(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        bad = float(np.mean(~np.isfinite(arr)))
        if bad > 0:
            out[prefix + "/".join(path)] = bad
    return out


def dump_nan_state(out_dir: str, model: torch.nn.Module, step: int, batch: Mapping,
                   metrics: Mapping, logger=None) -> str:
    """Write the report and pickle a reproducer, ``nan_dump.pkl`` in
    ``out_dir``: {"report", "batch" (numpy), "params" (the flax tree of
    models/convert.py::to_jax_variables), "step"}. Returns the dump's path."""
    os.makedirs(out_dir, exist_ok=True)
    variables = to_jax_variables(model)
    host_batch = {k: _host(v) for k, v in batch.items()}
    report = {}
    report.update(nan_report(variables["params"], "params/"))
    report.update(nan_report(variables["batch_stats"], "batch_stats/"))
    report.update(nan_report(host_batch, "batch/"))
    report.update({f"metric/{k}": float(v) for k, v in metrics.items() if np.ndim(_host(v)) == 0})
    path = os.path.join(out_dir, "nan_dump.pkl")
    with open(path, "wb") as f:
        pickle.dump({"report": report, "batch": host_batch, "params": variables["params"],
                     "step": int(step)}, f)
    log = logger.info if logger else print
    log(f"NaN detected at step {int(step)}; dumped reproducer to {path}")
    for k, v in sorted(report.items()):
        log(f"  {k}: {100 * v:.2f}% non-finite")
    return path
