"""The port's data parallelism (parallel/) on the CPU: two ranks of a gloo
group, each a spawned process with one torch thread
(tests/torch_parallel_cases.py), against the world-size-1 port on the
global batch in this process, and the flagship's steps against JAX's
make_train_step on a 2-device mesh with the batch sharded (the JAX
package's data parallelism: XLA's all-reduces under its sharded jit).

Tolerances, each with its reason:
- BatchNorm, StaleBatchNorm, the loss means, voting (the ranks' rows
  stacked or their shares summed, against world size 1): 1e-6 of scale;
  only float32 sums over other row groupings differ.
- ConvNet step (W = 2 against W = 1): metrics rtol 1e-6; parameters and
  statistics within 1e-2 of the step's change, as below: from flax's init
  one ReLU input of the 12,288 at level 0 lies within 1e-6 of zero and
  flips sign with the sums' grouping, which moves the update by 1.2e-3 of
  its norm (with float64 BN statistics the W = 1 gradient moves by 1e-6).
- Flagship steps against JAX's sharded step from the same state: loss and
  metrics rtol 2e-4 (the JAX package's own sharded-vs-unsharded bound,
  tests/test_train.py), the confusion as tests/test_torch_train.py holds
  it, parameters within 1e-2 of the update (tests/test_torch_train.py's
  bound: ReLU kinks flip with sum order), BN statistics elementwise to
  rtol 1e-5 plus 1e-5 of the leaf's RMS: a mean near zero carries the
  rounding of its channel's sum of O(RMS) values (the second batch-BN
  step's dec3_up/linear1_bn/mean, channel 44: |Δ| 7.3e-8 on 2.0e-5,
  4.4e-7 of the leaf's RMS 0.165; the widest element of any leaf uses 0.38
  of this bound).
- Across ranks: parameters and statistics bit for bit.
"""
import os
import pickle
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from contrastboundary_tpu_torch import parallel
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.models import PointTransformerSeg
from contrastboundary_tpu_torch.models.blocks import BatchNorm
from contrastboundary_tpu_torch.utils import read_scalars
import torch_parallel_cases as cases
from test_torch_main import write_rooms

ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
LOSSES = ("ce", "ce_class", "sigmoid", "cbl_global_cnt", "cbl_global_kl", "cbl_tile", "cbl_v2",
          "cbl_dense")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(out: Path):
    port = _free_port()
    env = {**os.environ, "CBL_COORDINATOR": f"localhost:{port}",
           "CBL_NUM_PROCESSES": str(WORLD), "PYTHONPATH": f"{ROOT}{os.pathsep}{ROOT / 'tests'}",
           "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_parallel_cases.py"), str(out)],
        env={**env, "CBL_PROCESS_ID": str(r)}, stdout=open(out / f"rank{r}.log", "w"),
        stderr=subprocess.STDOUT, cwd=ROOT) for r in range(WORLD)]


def _jax_steppers(first, pool):
    """JAX's train step on a 2-device mesh for each BN mode, lowered on the
    mode's first run and compiled in ``pool``'s threads (XLA compiles
    outside the GIL, so the caller's work goes on meanwhile): {mode: step},
    where step(run) takes the state before one of the port's steps and its
    global batch, sharded, → (metrics, variables after)."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from contrastboundary_tpu.losses.contrast import ContrastConfig as JaxContrast
    from contrastboundary_tpu.models import PointTransformerSeg as JaxSeg
    from contrastboundary_tpu.parallel import make_mesh, replicated_sharding, shard_batch
    from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
    from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
    from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
    from test_torch_train import _jax_state

    mesh = make_mesh(jax.devices()[:WORLD])
    tx = jax_make_optimizer(cases.LR, momentum=0.9, weight_decay=1e-4)
    spec = ge._flagship(256, tiny=True)[1]

    def inputs(run):
        state = jax.device_put(
            _jax_state(run["before"]["variables"], run["before"]["momentum"], tx),
            replicated_sharding(mesh))
        return state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in run["batch"].items()})

    lowered = {mode: jax_make_train_step(
        JaxSeg(num_classes=13, blocks=cases.FLAGSHIP_BLOCKS, bn_mode=mode),
        JaxStepConfig(num_classes=13, spec=spec, contrast=JaxContrast()),
    ).lower(*inputs(run)) for mode, run in first.items()}
    compiling = {mode: pool.submit(low.compile) for mode, low in lowered.items()}

    def stepper(exe):
        def step(run):
            state, metrics = exe.result()(*inputs(run))
            return jax.device_get(metrics), {"params": jax.device_get(state.params),
                                             "batch_stats": jax.device_get(state.batch_stats)}
        return step
    return {mode: stepper(exe) for mode, exe in compiling.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, this process's world-size-1 results, and JAX's
    steps from rank 0's states (the first from the starting weights every
    run shares: JAX compiles while the ranks and the world-size-1 cases
    run)."""
    import jax

    out = tmp_path_factory.mktemp("parallel")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trees = cases.flagship_trees()
        with open(out / "trees.pkl", "wb") as f:
            pickle.dump(trees, f)
        write_rooms(out / "data")
        procs = _spawn(out)
        assert parallel.process_count() == 1
        first = {mode: {"before": {"variables": tree, "momentum": jax.tree_util.tree_map(
                            np.zeros_like, tree["params"])},
                        "batch": cases.grid_clouds(2, cases.FLAGSHIP_N,
                                                   seed=cases.STEP_SEEDS[mode][0])}
                 for mode, tree in trees.items()}
        with ThreadPoolExecutor(len(first)) as pool:
            steppers = _jax_steppers(first, pool)
            single = cases.run_all(trees)
            single["main"] = cases.main_case(out, exp="exp_w1", val=False)
            jax_runs = {mode: [step(first[mode])] for mode, step in steppers.items()}
        ranks = []
        for r, p in enumerate(procs):
            p.wait(timeout=600)
            log = (out / f"rank{r}.log").read_text()
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
            with open(out / f"rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        for mode, step in steppers.items():
            start = ranks[0]["flagship"][mode][0]["before"]
            for part in ("variables", "momentum"):  # JAX's first step started there too
                a, b = dict(_leaves(first[mode]["before"][part])), dict(_leaves(start[part]))
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            jax_runs[mode] += [step(run) for run in ranks[0]["flagship"][mode][1:]]
    finally:
        torch.set_num_threads(before)
    return {"out": out, "ranks": ranks, "single": single, "jax": jax_runs}


def _close(got, ref, tol, what=""):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - ref).max())
    assert err <= tol * scale, (what, err, scale)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _dist(a, b, keys):
    return float(np.sqrt(sum(np.sum((a[k].astype(np.float64) - b[k]) ** 2) for k in keys)))


def test_ranks_joined_one_gloo_group(runs):
    for r, res in enumerate(runs["ranks"]):
        assert res["backend"] == "gloo"
        assert res["info"] == {"process_index": str(r), "process_count": str(WORLD),
                               "device": "cpu"}


def test_initialization_without_a_launcher_is_a_no_op(monkeypatch):
    for var in ("CBL_COORDINATOR", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.maybe_initialize_distributed("cpu") == {
        "process_index": 0, "process_count": 1, "device": torch.device("cpu")}
    monkeypatch.setenv("CBL_COORDINATOR", f"localhost:{_free_port()}")
    monkeypatch.setenv("CBL_NUM_PROCESSES", "1")
    monkeypatch.setenv("CBL_PROCESS_ID", "0")
    info = parallel.maybe_initialize_distributed("cpu")
    assert info["process_count"] == 1 and not torch.distributed.is_initialized()


def test_a_rank_takes_a_card_of_its_own_host(monkeypatch):
    """Under the CBL_* launch of 2 hosts of 4 cards, rank 5 takes the second
    host's card 1; torchrun's LOCAL_RANK wins; a named device or the CPU is
    kept."""
    from contrastboundary_tpu_torch.parallel.distributed import rank_device

    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_device("cuda", 5) == torch.device("cuda", 1)
    assert rank_device("cuda", 3) == torch.device("cuda", 3)
    assert rank_device("cuda:2", 5) == torch.device("cuda", 2)
    assert rank_device("cpu", 5) == torch.device("cpu")
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert rank_device("cuda", 5) == torch.device("cuda", 3)


@pytest.mark.parametrize("name", [f"{c}{n}" for c in ("BatchNorm", "StaleBatchNorm")
                                  for n in (3, 4)])
def test_batchnorm_matches_world_size_1(runs, name):
    """Train-mode BN on [B, N, C] (3) and [B, N, K, C] (4): each rank's rows
    of the output and the input gradient, the parameter gradients summed
    over ranks, and the running statistics of every rank, against BN on the
    global batch."""
    ref = runs["single"]["bn"][name]
    got = [r["bn"][name] for r in runs["ranks"]]
    _close(np.concatenate([g["y"] for g in got]), ref["y"], 1e-6, "y")
    _close(np.concatenate([g["dx"] for g in got]), ref["dx"], 1e-6, "dx")
    for k in ("dweight", "dbias"):
        _close(sum(g[k] for g in got), ref[k], 1e-6, k)
    for k in ("running_mean", "running_var"):
        for g in got:
            _close(g[k], ref[k], 1e-6, k)
        np.testing.assert_array_equal(got[0][k], got[1][k])


@pytest.mark.parametrize("name", LOSSES)
def test_loss_means_match_world_size_1(runs, name):
    """Each rank's loss is its share of the global mean (the shares sum to
    the loss of the global batch), and each rank's input rows get the
    global loss's gradient."""
    ref = runs["single"]["losses"][name]
    got = [r["losses"][name] for r in runs["ranks"]]
    _close(sum(g["loss"] for g in got), ref["loss"], 1e-6, "loss")
    _close(np.concatenate([g["grad"] for g in got]), ref["grad"], 1e-6, "grad")
    assert float(ref["loss"]) > 0 and np.abs(ref["grad"]).max() > 0


def test_convnet_step_matches_world_size_1(runs):
    ref = runs["single"]["conv"]
    got = [r["conv"] for r in runs["ranks"]]
    for k, v in ref["metrics"].items():
        for g in got:
            np.testing.assert_allclose(g["metrics"][k], v, rtol=1e-6, err_msg=k)
    start = load_config("synthetic_conv_tiny", cases.CONV_SETS).build_model(
        device="cpu", generator=torch.Generator().manual_seed(0)).state_dict()
    keys = sorted(ref["state"])
    start = {k: start[k].numpy() for k in keys}
    change = _dist(ref["state"], start, keys)
    assert _dist(got[0]["state"], ref["state"], keys) <= 1e-2 * change
    for k in keys:
        np.testing.assert_array_equal(got[0]["state"][k], got[1]["state"][k], err_msg=k)


@pytest.mark.parametrize("mode,step", [("batch", 0), ("batch", 1), ("stale", 0)])
def test_flagship_step_matches_jax_sharded_step(runs, mode, step):
    port = runs["ranks"][0]["flagship"][mode][step]
    jm, jafter = runs["jax"][mode][step]
    keys = {"ce", "cbl", "loss"} | {f"cbl_stage{i}" for i in range(5)}
    assert set(port["metrics"]) == set(jm) == keys | {"confusion"}
    for k in keys:
        np.testing.assert_allclose(float(port["metrics"][k]), float(jm[k]), rtol=2e-4,
                                   err_msg=k)
    tc, jc = port["metrics"]["confusion"], np.asarray(jm["confusion"])
    np.testing.assert_array_equal(tc.sum(1), jc.sum(1))
    assert np.abs(tc - jc).sum() <= 2 * 4, np.abs(tc - jc).sum()
    before = dict(_leaves(port["before"]["variables"]["params"]))
    after = dict(_leaves(port["after"]["params"]))
    ref = dict(_leaves(jafter["params"]))
    keys = sorted(ref)
    assert set(after) == set(ref)
    assert _dist(after, ref, keys) <= 1e-2 * _dist(ref, before, keys)
    stats, ref_stats = (dict(_leaves(t)) for t in (port["after"]["batch_stats"],
                                                  jafter["batch_stats"]))
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        rms = float(np.sqrt(np.mean(np.square(v, dtype=np.float64))))
        np.testing.assert_allclose(stats[k], v, rtol=1e-5, atol=1e-5 * rms, err_msg=k)


@pytest.mark.parametrize("mode", ["batch", "stale"])
def test_ranks_hold_the_same_state(runs, mode):
    a, b = (r["flagship"][mode] for r in runs["ranks"])
    for ra, rb in zip(a, b):
        for coll in ("params", "batch_stats"):
            la, lb = dict(_leaves(ra["after"][coll])), dict(_leaves(rb["after"][coll]))
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
        for k in ra["metrics"]:
            np.testing.assert_array_equal(ra["metrics"][k], rb["metrics"][k], err_msg=k)


@pytest.mark.parametrize("mode", ["batch", "stale"])
def test_step_issues_only_all_reduces(runs, mode):
    """The counterpart of tests/test_multihost.py::
    test_sharded_train_step_hlo_only_allreduce_collectives. At W = 2 a step
    issues all-reduces only: under batch BN two a BatchNorm (its statistics
    forward, their cotangents backward); under stale BN one a BatchNorm
    outside the fused attention layers and one a fused layer (no gradient
    passes through stale statistics); then one for the cross-entropy's
    count, one for each of the 5 CBL stages' counts, one for the gradients
    and one for the metrics. At W = 1 it issues none."""
    model = PointTransformerSeg(num_classes=13, blocks=cases.FLAGSHIP_BLOCKS, bn_mode=mode)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    attn = len(cases.FLAGSHIP_BLOCKS)
    assert (len(bns), attn) == (49, 5)
    nparams = sum(p.numel() for p in model.parameters())
    stats = sum(4 * (2 * m.weight.numel() + 1) for m in bns)
    tail = 4 * (1 + 5 + nparams + 8 + 13 * 13)  # counts, gradients, metrics
    if mode == "batch":
        calls, nbytes = 2 * len(bns) + 8, 2 * stats + tail
    else:
        fused = [layer for layer in model.modules() if hasattr(layer, "w_bn1")]
        inside = sum(4 * (2 * m.weight.numel() + 1)
                     for layer in fused for m in (layer.p_bn, layer.w_bn1, layer.w_bn2))
        # a fused layer's pack: the kernel's two statistics pairs (w_bn1's,
        # w_bn2's), rel's sum (3) and second moments (9), and the row count
        packs = sum(4 * (2 * layer.w_bn1.weight.numel() + 2 * layer.w_bn2.weight.numel() + 13)
                    for layer in fused)
        calls, nbytes = len(bns) - 3 * attn + attn + 8, stats - inside + packs + tail
    assert (calls, mode) in ((106, "batch"), (47, "stale"))
    for r in runs["ranks"]:
        for run in r["flagship"][mode]:
            counts = run["counts"]
            assert counts["all_reduce"] == {"calls": calls, "bytes": nbytes}
            assert all(counts[k]["calls"] == 0 for k in counts if k != "all_reduce")
    for run in runs["single"]["flagship"][mode]:
        assert all(v == {"calls": 0, "bytes": 0} for v in run["counts"].values())


def test_voting_matches_world_size_1(runs):
    """Every rank runs its crop of each 2-crop request and gathers the
    other's: every rank's votes are the world-size-1 votes."""
    ref = runs["single"]["voting"]
    for r in runs["ranks"]:
        got = r["voting"]
        assert got["requests"] == ref["requests"] > 1
        assert got["mIoU"] == pytest.approx(ref["mIoU"], abs=1e-6)
        for a, b in zip(got["probs"], ref["probs"]):
            _close(a, b, 1e-6, "probs")


def test_main_trains_and_restores_across_ranks(runs):
    """main.py --mode train at W = 2 under the CBL_* variables: both ranks
    exit 0 (the fixture) with the same trained parameters and statistics;
    rank 0 alone writes the log file, the scalars and the snapshot; --mode
    val restores the snapshot on both ranks."""
    exp = runs["out"] / "exp"
    a, b = (r["main"] for r in runs["ranks"])
    for k in a["trained"]:
        np.testing.assert_array_equal(a["trained"][k], b["trained"][k], err_msg=k)
        np.testing.assert_array_equal(a["restored"][k], a["trained"][k], err_msg=k)
        np.testing.assert_array_equal(b["restored"][k], a["trained"][k], err_msg=k)
    assert a["best_miou"] == b["best_miou"]
    assert a["val"]["full"]["mIoU"] == b["val"]["full"]["mIoU"] == a["best_miou"]
    log = (exp / "log_train.txt").read_text()
    assert "(rank 0 of 2)" in log and "(rank 1 of 2)" not in log
    # 2 train rooms, loop 4, batch 2 a rank: two steps an epoch on each rank
    assert len(read_scalars(str(exp / "scalars.jsonl"))["train/loss"][0]) == 2
    assert sorted(os.listdir(exp / "checkpoints")) == ["best.json", "snap-2"]
    assert "collectives over 2 steps: {'all_reduce': {'calls': " in log
    assert "2 steps/epoch a rank" in log
    rank_logs = [(runs["out"] / f"rank{r}.log").read_text() for r in range(WORLD)]
    assert all("(rank 1 of 2)" in t for t in rank_logs[1:])


def _first_drop(lrs):
    """The fraction of the run's steps before the learning rate first
    drops."""
    drops = [i for i, lr in enumerate(lrs) if lr < lrs[0]]
    assert drops, lrs
    return drops[0] / len(lrs)


def test_learning_rate_drops_at_the_same_fraction_at_w2(runs):
    """The multistep schedule (one milestone at half of the one epoch)
    sized by the steps a rank takes: each rank of the W = 2 run (2 steps)
    takes the drop at the same fraction of its steps as the W = 1 run (4
    steps) of the same config, global batch and rooms."""
    ref = runs["single"]["main"]["lrs"]
    assert len(ref) == 4 and _first_drop(ref) == 0.5
    for r in runs["ranks"]:
        lrs = r["main"]["lrs"]
        assert len(lrs) == 2
        assert _first_drop(lrs) == _first_drop(ref)
        assert lrs[-1] == ref[-1]


def test_exponential_schedule_counts_a_rank_s_steps(monkeypatch):
    """main.py's setup sizes the exponential schedule with the steps a rank
    takes an epoch: at W = 2 the rate decays once after that many steps."""
    import contrastboundary_tpu_torch.main as entry

    monkeypatch.setattr(entry, "process_count", lambda: 2)
    cfg = load_config("synthetic_conv_tiny", "data.num_rooms:2;data.points_per_room:3000;"
                      "data.loop:4;optim.batch_size:2;model.base_fdim:12;model.strides:[1,4]")
    assert cfg.optim.schedule == "exponential"
    *_, schedule, train_ds, steps = entry.setup(cfg, entry.setup_logger(), "cpu")
    assert (len(train_ds), steps) == (8, 2)
    base = np.float32(cfg.optim.base_lr)
    assert schedule(steps - 1) == base
    assert schedule(steps) == float(np.float32(base * np.float32(cfg.optim.decay_rate)))


def test_batches_must_split_over_the_ranks(runs):
    for r in runs["ranks"]:
        assert "is not a multiple of the world size 2" in r["indivisible"]
