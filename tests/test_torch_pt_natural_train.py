"""One train step of the point transformer on the natural layout
(synthetic_tiny widths, one block a level, N = 2048: the top level's 8
points fewer than its self search's k = 16) against JAX's make_train_step
from the same state, under batch and stale BN, on the CPU with one torch
thread.

Tolerances: ce, cbl, each stage's CBL and the loss rtol 1e-5 (float32 sums
in another order); params within 1e-2 and batch_stats within 2e-5 of the
step's change, tests/test_torch_train.py's STEP_RTOL (ReLU kinks that flip
with the sum order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.models import load_jax_variables, to_jax_variables
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from test_torch_pt_natural import MODEL_N, _batch, _configs, _stats_dist, compile_in_threads
from test_torch_train import STEP_RTOL, _jax_state, _momentum_tree, _perturbed

# one block a level: the decoder's attention layer at every level
STEP_BLOCKS = ";model.blocks:[1,1,1,1,1]"


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def train_runs():
    """One train step of the port and of JAX make_train_step from the same
    state (perturbed fresh weights, statistics and zero momentum) under
    each BN mode, JAX's two steps compiled in parallel threads: → {mode:
    (before, port metrics, port after, JAX metrics, JAX after)}."""
    batch = _batch(6, MODEL_N)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    setups, lowered = {}, {}
    for mode in ("batch", "stale"):
        cfg, jcfg = _configs(mode, STEP_BLOCKS)
        before = _perturbed(to_jax_variables(cfg.build_model(
            device="cpu", generator=torch.Generator().manual_seed(2))), np.random.RandomState(3))
        model = load_jax_variables(cfg.build_model(device="cpu"), before)
        opt = make_optimizer(model.parameters(), 0.05)
        tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
        state = _jax_state(before, _momentum_tree(model, opt), tx)
        jstep = jax_make_train_step(jcfg.build_model(), JaxStepConfig(
            num_classes=13, spec=jcfg.pyramid_spec(), contrast=jcfg.contrast))
        lowered[mode] = jstep.lower(state, jbatch)
        setups[mode] = (cfg, before, model, opt, state)
    out = {}
    for mode, exe in compile_in_threads(lowered).items():
        cfg, before, model, opt, state = setups[mode]
        state, jm = exe(state, jbatch)
        step = make_train_step(model, TrainStepConfig(
            num_classes=13, spec=cfg.pyramid_spec(), contrast=cfg.contrast), opt, device="cpu")
        m = step(batch)
        out[mode] = (before, {k: v.numpy() for k, v in m.items()}, to_jax_variables(model),
                     jax.device_get(jm), {"params": jax.device_get(state.params),
                                          "batch_stats": jax.device_get(state.batch_stats)})
    return out


@pytest.mark.parametrize("mode", ["batch", "stale"])
def test_train_step_metrics_match_jax(train_runs, mode):
    _, port, _, ref, _ = train_runs[mode]
    keys = {"ce", "cbl", "loss", "confusion"} | {f"cbl_stage{i}" for i in range(5)}
    assert set(port) == set(ref) == keys
    for k in keys - {"confusion"}:
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(port["confusion"].sum(1), np.asarray(ref["confusion"]).sum(1))


@pytest.mark.parametrize("mode", ["batch", "stale"])
@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_train_step_weights_match_jax(train_runs, mode, collection):
    before, _, port, _, ref = train_runs[mode]
    got = _stats_dist(port[collection], ref[collection])
    change = _stats_dist(ref[collection], before[collection])
    assert got <= STEP_RTOL[collection] * change, (got, change)
