"""The CBL case of tests/test_torch_cbl_ranks.py, run by each rank of a
gloo group of CPU processes and, on the whole global batch, by the test's
own process at world size 1: cbl_loss with nce, the flat mean over
positive terms ('mask') and 8 random rows a point ('rand8'), on the tiny
flagship pyramid (tests/torch_parallel_cases.py::TINY_SPEC) of 4 clouds of
256 points on the 1/64 m grid, random stage features, the key of update 0.
Each rank takes its clouds' rows (``mine``) and returns its share of the
loss, its stages' shares and the gradient of its features. Run as a
script, it is one rank (``CBL_COORDINATOR``, ``CBL_NUM_PROCESSES``,
``CBL_PROCESS_ID``); the results go to ``<out>/rank<r>.pkl``:

    python tests/torch_cbl_ranks.py <out>
"""
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_parallel_cases import TINY_SPEC, grid_clouds, host, mine  # noqa: E402
from contrastboundary_tpu_torch import parallel  # noqa: E402
from contrastboundary_tpu_torch.losses.contrast import ContrastConfig, cbl_loss  # noqa: E402
from contrastboundary_tpu_torch.ops.pyramid import build_pyramid  # noqa: E402
from contrastboundary_tpu_torch.train.trainer import cbl_key  # noqa: E402

CFG = ContrastConfig(contrast="nce", mask_mode=True, extra_neg_rand=8)


def run() -> dict:
    """→ {'loss', 'stages': {name: share}, 'grads': [per-stage gradient]}
    of this rank's rows."""
    batch = grid_clouds(4, 256, seed=21)
    pyr = build_pyramid(torch.as_tensor(mine(batch["points"])), TINY_SPEC)
    labels = torch.gather(torch.as_tensor(mine(batch["labels"])).long(), 1, pyr.order0)
    rng = np.random.RandomState(22)
    feats = [mine(torch.as_tensor(rng.randn(4, p.shape[1], 16).astype(np.float32)))
             .clone().requires_grad_(True) for p in pyr.points]
    total, stages = cbl_loss(feats, pyr, labels, 13, CFG, key=cbl_key(0))
    total.backward()
    return {"loss": host(total), "stages": {k: host(v) for k, v in stages.items()},
            "grads": [host(f.grad) for f in feats]}


if __name__ == "__main__":
    torch.set_num_threads(1)
    out = Path(sys.argv[1])
    info = parallel.maybe_initialize_distributed("cpu")
    result = run()
    with open(out / f"rank{info['process_index']}.pkl", "wb") as f:
        pickle.dump(result, f)
    torch.distributed.destroy_process_group()
