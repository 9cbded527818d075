"""Tracing, profiling and memory probes (counterpart of
contrastboundary_tpu/utils/profiling.py): a ``torch.profiler`` trace (CPU
and, where there is a card, CUDA activity) written as a Chrome trace, host
RSS and the card's allocator statistics, and a per-step data/compute timer.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block into
    ``<log_dir>/trace_<pid>_<ns>.json`` (open with Perfetto or
    chrome://tracing); yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def memory_stats() -> Dict[str, float]:
    """Host RSS and, per card, the allocator's bytes in use and peak, in MB."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    out["host_rss_mb"] = float(line.split()[1]) / 1024
    except OSError:
        pass
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"cuda{i}_used_mb"] = stats.get("allocated_bytes.all.current", 0) / 1e6
            out[f"cuda{i}_peak_mb"] = stats.get("allocated_bytes.all.peak", 0) / 1e6
    return out


class StepTimer:
    """Per-step wall-clock split into data / compute, with running averages
    (the reference's batch-time/data-time meters)."""

    def __init__(self):
        self.data_time = 0.0
        self.step_time = 0.0
        self.count = 0
        self._t = time.time()

    def data_ready(self):
        now = time.time()
        self._data = now - self._t
        self._t = now

    def step_done(self):
        now = time.time()
        self.data_time += self._data
        self.step_time += now - self._t
        self.count += 1
        self._t = now

    def summary(self) -> Dict[str, float]:
        c = max(self.count, 1)
        return {
            "data_ms": 1000 * self.data_time / c,
            "step_ms": 1000 * self.step_time / c,
        }
