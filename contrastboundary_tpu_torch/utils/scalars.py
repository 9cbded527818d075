"""Scalar summary export (counterpart of
contrastboundary_tpu/utils/scalars.py, the same file format, so each package
reads the other's series).

The writer emits one JSONL row per scalar batch, ``{"step": int, "wall":
float, "tag1": v1, ...}``, to ``scalars.jsonl`` in the experiment
directory: one buffered append a row, no tensorboard dependency.
``read_scalars`` returns ``{tag: (steps, values)}`` and tolerates a
truncated last line (a killed run must never corrupt the series).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Iterable, List, Tuple


class ScalarWriter:
    """Append-only JSONL scalar series, one file per run."""

    def __init__(self, exp_dir: str, filename: str = "scalars.jsonl"):
        os.makedirs(exp_dir, exist_ok=True)
        self.path = os.path.join(exp_dir, filename)
        self._fh = open(self.path, "a", buffering=1)  # line-buffered

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        row = {"step": int(step), "wall": time.time()}
        for k, v in scalars.items():
            v = float(v)
            # JSON has no NaN/Inf literals; encode as strings so a diverged
            # run's series stays loadable (the NaN sentinel halts the run,
            # but the last rows before the halt are forensic evidence)
            row[k] = v if v == v and abs(v) != float("inf") else repr(v)
        self._fh.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _rows(path: str) -> Iterable[dict]:
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                return  # truncated tail (killed run) — stop cleanly


def read_scalars(path: str) -> Dict[str, Tuple[List[int], List[float]]]:
    """Load a scalars.jsonl into {tag: (steps, values)} (NaN/Inf strings
    decode back to floats)."""
    out: Dict[str, Tuple[List[int], List[float]]] = {}
    for row in _rows(path):
        step = row.get("step", 0)
        for k, v in row.items():
            if k in ("step", "wall"):
                continue
            if isinstance(v, str):
                v = float(v)
            steps, vals = out.setdefault(k, ([], []))
            steps.append(int(step))
            vals.append(float(v))
    return out
