"""Port model (contrastboundary_tpu_torch/models) against the flax model, in
float32 on the CPU: a small seeded model through from_jax_variables, then
the trained flagship checkpoint at full width through the whole eval step
(eval/step.py against the JAX make_eval_step) — the slice as a whole.
Tolerances: 1e-4 on logits and probs (float32 sums in another order)."""
import os
from typing import Any

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import struct

from contrastboundary_tpu.models import PointTransformerSeg as JaxSeg
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu.train.trainer import TrainStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, from_jax_variables, load_checkpoint, load_jax_variables,
)
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid
from torch_parity import synthetic_crops

CKPT = os.path.join(os.path.dirname(__file__), "..", "results", "ckpts", "parity_s0_fast_e15.pkl")
JAX_SPEC = JaxSpec(layout="sorted", sampler="strided")


@struct.dataclass
class _State:
    params: Any
    batch_stats: Any


def _perturbed(tree, rng):
    """Random BN statistics and affines, so BN is not the identity."""
    def walk(t, stats=False):
        out = {}
        for k, v in t.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif k == "var":
                out[k] = (np.abs(rng.randn(*v.shape)) + 0.5).astype(np.float32)
            else:
                out[k] = (np.asarray(v) + 0.1 * rng.randn(*v.shape)).astype(np.float32)
        return out
    return {"params": walk(tree["params"]), "batch_stats": walk(tree["batch_stats"])}


def test_small_model_logits_match_flax():
    planes, blocks = (16, 16, 32, 32, 32), (2, 1, 1, 1, 2)
    pts, feats, _ = synthetic_crops(2, 1024, seed=1)
    jpyr = jax_build_pyramid(jnp.asarray(pts), JAX_SPEC)
    jfeats = jnp.take_along_axis(jnp.asarray(feats), jpyr.order0[..., None], 1)
    jmodel = JaxSeg(num_classes=13, planes=planes, blocks=blocks)
    variables = jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jfeats, jpyr, train=False
    )
    variables = _perturbed(jax.device_get(variables), np.random.RandomState(0))
    ref = jax.jit(lambda v, f, p: jmodel.apply(v, f, p, train=False).logits)(
        variables, jfeats, jpyr
    )

    model = PointTransformerSeg(num_classes=13, planes=planes, blocks=blocks)
    load_jax_variables(model, variables).eval()
    tpyr = build_pyramid(torch.as_tensor(pts), PyramidSpec())
    tfeats = torch.as_tensor(feats)[torch.arange(2)[:, None], tpyr.order0]
    with torch.no_grad():
        out = model(tfeats, tpyr)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_converter_refuses_unknown_and_missing_leaves():
    ck = load_checkpoint(CKPT)
    model = PointTransformerSeg(num_classes=13)
    missing = {"params": dict(ck["params"]), "batch_stats": ck["batch_stats"]}
    del missing["params"]["multihead"]
    with pytest.raises(ValueError, match="unset in the model: .*multihead"):
        load_jax_variables(model, missing)
    extra = {"params": {**ck["params"], "cls_extra": {"kernel": np.zeros((2, 2), np.float32)}},
             "batch_stats": ck["batch_stats"]}
    with pytest.raises(ValueError, match="unconsumed leaves: .*cls_extra"):
        load_jax_variables(model, extra)
    with pytest.raises(ValueError, match="unknown params leaf"):
        from_jax_variables({"params": {"x": {"gamma": np.zeros(2, np.float32)}}})


def test_trained_checkpoint_eval_step_matches_jax():
    ck = load_checkpoint(CKPT)
    pts, feats, labels = synthetic_crops(1, 2048, seed=2)
    batch = {"points": pts, "features": feats, "labels": labels}

    jmodel = JaxSeg(num_classes=13)
    cfg = TrainStepConfig(num_classes=13, spec=JAX_SPEC)
    state = _State(params=ck["params"], batch_stats=ck["batch_stats"])
    j_probs, j_conf = jax_make_eval_step(jmodel, cfg)(
        state, {k: jnp.asarray(v) for k, v in batch.items()}
    )

    model = load_jax_variables(PointTransformerSeg(num_classes=13), ck)
    probs, conf = make_eval_step(model, PyramidSpec(), device="cpu")(batch)
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(probs.argmax(-1).numpy(), np.asarray(j_probs).argmax(-1))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(j_conf))
    # a trained model: well above the 1/13 of chance on its own data
    assert np.trace(conf.numpy()) / conf.numpy().sum() > 0.5
