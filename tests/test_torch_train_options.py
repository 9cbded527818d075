"""One train step of the sorted flagship (``s3dis_pt_cbl``) with each of
two CBL option strings over it, against the JAX package's make_train_step
from the same state, on the CPU with one torch thread, at small widths (two
levels, planes 16-32, one block a level, N = 2048 crops on the 1/64 m grid,
tests/torch_parity.py):

- 'multi-Ua-concat-latent-sep|contrast-Ua-nce-latent-label_recur-l2square-
  mS-mask-nn4-rand8-projmlp-w.1': the contrast branch's own latent towers
  and projection MLPs, nce with its flat mean over positive terms and the
  separate positive term, the labels recursed from stage to stage, the nn4
  prefix forced positive and 8 random rows a point as negatives (the
  trainer's key of update 0);
- 'multi-Ua-concat-latent|contrast-Ua-softnn-probs-labelkl.5-nst-kl-p2-w.1':
  softnn over the branch logits' softmax with the kl distance, the kl
  positives on nearest-point labels, the loss squared.

Both run on the plain gathered route (no CBL kernel takes them). The JAX
steps are lowered in the main thread and compiled in parallel threads.

Tolerances: every loss rtol 1e-5 (float32 sums in another order); each
parameter leaf after the update within 1e-6 plus 2e-4 of the leaf's
largest change (string (a): 1.028e-6 on dec1_up/linear1_fc/kernel, whose
update reaches 7.5e-3: float32 sum order in its gradient, 1.4e-4 of it;
string (b): 1.3e-7 at most), and the batch statistics within 2e-5 of the
step's change (tests/test_torch_train.py's bound).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.models import load_jax_variables, to_jax_variables
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from test_torch_pt_natural import compile_in_threads
from test_torch_train import STEP_RTOL, _dist, _jax_state, _leaves, _momentum_tree, _perturbed
from torch_parity import synthetic_crops

N = 2048
SMALL = "model.planes:[16,32];model.blocks:[1,1];model.strides:[1,4];model.nsample:[8,16]"
STRINGS = {
    "a": "multi-Ua-concat-latent-sep|contrast-Ua-nce-latent-label_recur-l2square-mS-mask-nn4-"
         "rand8-projmlp-w.1",
    "b": "multi-Ua-concat-latent|contrast-Ua-softnn-probs-labelkl.5-nst-kl-p2-w.1",
}


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def step_runs():
    """For each string: (state before, the port's metrics, its variables
    after, JAX's metrics, JAX's variables after) of one step from the
    port's perturbed fresh weights."""
    pts, feats, labels = synthetic_crops(2, N, seed=5)
    labels[:, ::97] = -1
    batch = {"points": pts, "features": feats, "labels": labels}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
    setups, lowered = {}, {}
    for name, arch_out in STRINGS.items():
        sets = f'{SMALL};arch_out:"{arch_out}"'
        cfg, jcfg = load_config("s3dis_pt_cbl", sets), jax_load_config("s3dis_pt_cbl", sets)
        before = _perturbed(to_jax_variables(cfg.build_model(
            device="cpu", generator=torch.Generator().manual_seed(2))), np.random.RandomState(3))
        model = load_jax_variables(cfg.build_model(device="cpu"), before)
        opt = make_optimizer(model.parameters(), 0.05)
        kw = dict(num_classes=cfg.data.num_classes)
        port_cfg = TrainStepConfig(spec=cfg.pyramid_spec(), contrast=cfg.contrast, **kw)
        jax_cfg = JaxStepConfig(spec=jcfg.pyramid_spec(), contrast=jcfg.contrast, **kw)
        state = _jax_state(before, _momentum_tree(model, opt), tx)
        lowered[name] = jax_make_train_step(jcfg.build_model(), jax_cfg).lower(state, jbatch)
        setups[name] = (model, opt, port_cfg, before, state)
    out = {}
    for name, exe in compile_in_threads(lowered).items():
        model, opt, port_cfg, before, state = setups[name]
        state, jm = exe(state, jbatch)
        m = make_train_step(model, port_cfg, opt, device="cpu")(batch)
        out[name] = (before, {k: v.numpy() for k, v in m.items()}, to_jax_variables(model),
                     jax.device_get(jm), {"params": jax.device_get(state.params),
                                          "batch_stats": jax.device_get(state.batch_stats)})
    return out


@pytest.mark.parametrize("name", sorted(STRINGS))
def test_option_step_losses_match_jax(step_runs, name):
    _, port, _, ref, _ = step_runs[name]
    keys = {"ce", "cbl", "loss", "cbl_stage0", "cbl_stage1"}
    assert set(port) == set(ref) == keys | {"confusion"}
    for k in keys:
        assert np.isfinite(port[k]) and float(port[k]) > 0, k
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(port["confusion"].sum(1), np.asarray(ref["confusion"]).sum(1))


@pytest.mark.parametrize("name", sorted(STRINGS))
def test_option_step_parameters_match_jax(step_runs, name):
    before, _, port, _, ref = step_runs[name]
    got, ref, before = (dict(_leaves(v["params"])) for v in (port, ref, before))
    assert set(got) == set(ref) == set(before)
    for k in ref:
        err = float(np.abs(got[k] - ref[k]).max())
        assert err <= 1e-6 + 2e-4 * float(np.abs(ref[k] - before[k]).max()), (k, err)
    assert any(not np.array_equal(ref[k], before[k]) for k in ref)


@pytest.mark.parametrize("name", sorted(STRINGS))
def test_option_step_statistics_match_jax(step_runs, name):
    before, _, port, _, ref = step_runs[name]
    got, ref, before = (dict(_leaves(v["batch_stats"])) for v in (port, ref, before))
    assert set(got) == set(ref) == set(before)
    keys = sorted(ref)
    change = _dist([ref[k] for k in keys], [before[k] for k in keys])
    assert _dist([got[k] for k in keys], [ref[k] for k in keys]) <= \
        STEP_RTOL["batch_stats"] * change
