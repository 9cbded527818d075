"""One train step of the natural point transformer with the pyramid options
(the windowed KNN, ``model.knn_window:1``, and the tile contrast search,
``model.contrast_mode:tile``) against JAX's make_train_step from the same
state, on the CPU with one torch thread: synthetic_tiny widths, one block a
level, N = 2048 (levels 2048 and 512 windowed on tiles of 256, the coarser
ones dense; every contrast search a tile search, the coarse levels one
tile each).

JAX's step (compiled once) takes its CPU CBL route, the XLA tile route. The
port's step on that route (CBL_DENSE=off, impl 'xla') is held at
tests/test_torch_pt_natural_train.py's limits: ce, cbl, each stage and the
loss rtol 1e-5; params within 1e-2 and batch_stats within 2e-5 of the
step's change (tests/test_torch_train.py's STEP_RTOL). On its default
dense-window route the CBL terms take the two routes' tolerance of
tests/test_torch_train.py (rtol 3e-5), the rest the same limits.
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
from test_torch_pt_natural import MODEL_N, _batch, _configs, _stats_dist
from test_torch_train import STEP_RTOL, _jax_state, _momentum_tree, _perturbed

OPTIONS = ";model.blocks:[1,1,1,1,1];model.knn_window:1;model.contrast_mode:tile"
CBL_RTOL = {"xla": 1e-5, "dense": 3e-5}


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def setup():
    """The batch, the port's config, the starting variables (perturbed
    fresh weights) and JAX's step from them: (metrics, after)."""
    batch = _batch(6, MODEL_N)
    cfg, jcfg = _configs("batch", OPTIONS)
    spec = cfg.pyramid_spec()
    assert (spec.knn_window, spec.contrast_mode, spec.layout) == (1, "tile", "natural")
    before = _perturbed(to_jax_variables(cfg.build_model(
        device="cpu", generator=torch.Generator().manual_seed(2))), np.random.RandomState(3))
    model = load_jax_variables(cfg.build_model(device="cpu"), before)
    opt = make_optimizer(model.parameters(), 0.05)
    tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
    state = _jax_state(before, _momentum_tree(model, opt), tx)
    jstep = jax_make_train_step(jcfg.build_model(), JaxStepConfig(
        num_classes=13, spec=jcfg.pyramid_spec(), contrast=jcfg.contrast))
    state, jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    ref_after = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
    return batch, cfg, before, jax.device_get(jm), ref_after


_RUNS = {}


def port_step(setup, route):
    """The port's step from the same state on a CBL route, once a process:
    (metrics, after)."""
    if route not in _RUNS:
        batch, cfg, before, _, _ = setup
        model = load_jax_variables(cfg.build_model(device="cpu"), before)
        step = make_train_step(model, TrainStepConfig(
            num_classes=13, spec=cfg.pyramid_spec(), contrast=cfg.contrast),
            make_optimizer(model.parameters(), 0.05), device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            if route == "dense":
                mp.delenv("CBL_DENSE", raising=False)
            else:
                mp.setenv("CBL_DENSE", "off")
            m = step(batch)
        _RUNS[route] = {k: v.numpy() for k, v in m.items()}, to_jax_variables(model)
    return _RUNS[route]


@pytest.mark.parametrize("route", ["xla", "dense"])
def test_options_train_step_metrics_match_jax(setup, route):
    ref = setup[3]
    port, _ = port_step(setup, route)
    keys = {"ce", "cbl", "loss", "confusion"} | {f"cbl_stage{i}" for i in range(5)}
    assert set(port) == set(ref) == keys
    for k in keys - {"confusion"}:
        rtol = 1e-5 if k == "ce" else CBL_RTOL[route]
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=rtol, err_msg=k)
    np.testing.assert_array_equal(port["confusion"].sum(1), np.asarray(ref["confusion"]).sum(1))


@pytest.mark.parametrize("route", ["xla", "dense"])
@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_options_train_step_weights_match_jax(setup, route, collection):
    before, ref_after = setup[2], setup[4]
    _, port = port_step(setup, route)
    got = _stats_dist(port[collection], ref_after[collection])
    change = _stats_dist(ref_after[collection], before[collection])
    assert got <= STEP_RTOL[collection] * change, (got, change)
