"""Serving the port's ConvNet family on the CPU, with one torch thread:
the eval step against JAX's make_eval_step (probs within 1e-5 of scale),
voting (with latents) and the enumeration protocol over a ConvNet with no
change of their own, and ``main.py -c synthetic_conv_tiny --mode
train|val`` (two steps, the epoch-end eval, the snapshot restored)."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import contrastboundary_tpu_torch.main as entry
from contrastboundary_tpu.train.state import create_train_state
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu_torch.data import SyntheticSceneDataset
from contrastboundary_tpu_torch.eval.run import run_enumerate_eval, run_voting_eval
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.models import to_jax_variables
from test_torch_convnet_train import CNT, TINY, _batch, _close, _configs


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_convnet_eval_step_matches_jax():
    batch = _batch(7)
    cfg, jcfg = _configs(CNT)
    model = cfg.build_model(device="cpu", generator=torch.Generator().manual_seed(4))
    jstep = jax_make_eval_step(jcfg.build_model(), JaxStepConfig(
        num_classes=13, spec=jcfg.pyramid_spec(), contrast=jcfg.contrast))
    state = create_train_state(to_jax_variables(model), jax_make_optimizer(0.05))
    ref, ref_conf = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})
    probs, conf = make_eval_step(model, cfg.pyramid_spec(), device="cpu")(batch)
    _close(probs.numpy(), ref, 1e-5, "probs")
    np.testing.assert_array_equal(conf.numpy().sum(1), np.asarray(ref_conf).sum(1))


def test_evaluators_serve_a_convnet():
    """Voting (with latents) and the enumeration protocol over a ConvNet,
    with no change of their own: every point of the room predicted."""
    cfg, _ = _configs(CNT)
    model = cfg.build_model(device="cpu")
    ds = SyntheticSceneDataset(num_rooms=1, points_per_room=3000, seed=2, split="val")
    kw = dict(num_classes=13, n_points=1024, voxel_size=0.04, device="cpu", log=lambda s: None)
    vote = run_voting_eval(model, cfg.pyramid_spec(), ds, batch_size=2, num_votes=0.3,
                           extra_ops="feature", **kw)
    assert 0.0 <= vote["full"]["OA"] <= 1.0
    ctx = {}
    enum = run_enumerate_eval(model, cfg.pyramid_spec(), ds, batch_size=2, voxel_max=3000,
                              ctx=ctx, **kw)
    assert 0.0 <= enum["full"]["OA"] <= 1.0
    ev = ctx["evaluator"]
    assert all((c > 0).all() for c in ev.pred_counts)
    assert all(np.isfinite(lg).all() for lg in ev.logits)


def test_main_trains_and_restores_a_convnet_preset(tmp_path):
    sets = ("data.num_rooms:2;data.points_per_room:3000;data.n_points:1024;"
            "data.voxel_max:3000;data.loop:1;optim.batch_size:1;optim.epochs:1;"
            "eval.batch_size:2;eval.num_votes:0.3;log_freq:1;" + TINY)
    argv = ["-c", "synthetic_conv_tiny", "--device", "cpu", "--set", sets,
            "--exp_dir", str(tmp_path / "exp")]
    entry.main(["--mode", "train"] + argv)
    log = (tmp_path / "exp" / "log_train.txt").read_text()
    assert "model convnet" in log and "step 2/2" in log and "nan" not in log.lower()
    assert os.listdir(tmp_path / "exp" / "checkpoints")
    entry.main(["--mode", "val", "--model_path", "auto"] + argv)
    assert "restored step 2" in (tmp_path / "exp" / "log_val.txt").read_text()
