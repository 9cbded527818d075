"""cbl_loss with nce, 'mask' and 'rand8' across two ranks of a gloo group
(tests/torch_cbl_ranks.py, each a spawned process with one torch thread)
against world size 1 in this process: the rand<k> rows of a rank are its
rows of the global batch's draw, and the flat mean over positive terms is
taken over the global batch, so the ranks' shares of the loss and of each
stage sum to the world-size-1 values and their feature gradients, stacked,
are its gradient. No model and no JAX. Tolerance 1e-6 of scale (float32
sums over other row groupings)."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import torch_cbl_ranks as case
from test_torch_parallel import _close, _free_port

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2


def test_cbl_nce_mask_rand_matches_world_size_1(tmp_path):
    port = _free_port()
    env = {**os.environ, "CBL_COORDINATOR": f"localhost:{port}",
           "CBL_NUM_PROCESSES": str(WORLD), "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_cbl_ranks.py"), str(tmp_path)],
        env={**env, "CBL_PROCESS_ID": str(r)}, stdout=open(tmp_path / f"rank{r}.log", "w"),
        stderr=subprocess.STDOUT, cwd=ROOT) for r in range(WORLD)]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ref = case.run()
    finally:
        torch.set_num_threads(before)
    for r, p in enumerate(procs):
        assert p.wait(timeout=300) == 0, (tmp_path / f"rank{r}.log").read_text()[-3000:]
    got = [pickle.load(open(tmp_path / f"rank{r}.pkl", "rb")) for r in range(WORLD)]
    _close(sum(g["loss"] for g in got), ref["loss"], 1e-6, "loss")
    for k, v in ref["stages"].items():
        _close(sum(g["stages"][k] for g in got), v, 1e-6, k)
    for i, v in enumerate(ref["grads"]):
        _close(np.concatenate([g["grads"][i] for g in got]), v, 1e-6, f"grad {i}")
    assert float(ref["loss"]) > 0 and np.abs(ref["grads"][0]).max() > 0
