"""Feature extraction from the port's bfloat16 model: make_eval_step(
output='logits', with_features=True) on PointTransformerSeg(dtype=
torch.bfloat16) under batch and stale BN, against the JAX package's bfloat16
eval step with features (contrastboundary_tpu/train/trainer.py::
make_eval_step), on the CPU at the sizes of tests/test_bf16.py
(tests/torch_bf16_parity.py; the seeded weights of tests/torch_eval_parity.py).

The JAX bfloat16 steps are compiled once a process through
torch_bf16_parity.References (excess precision off; the stale one with its
fused attention in interpret mode, PT_ATTN=interpret, under
bp.reference_sums, as tests/test_torch_bf16_stale.py lowers its eval). The
float32 feature step of tests/torch_eval_parity.py is the gap's other side:
eval-mode BN is one function under both BN modes in float32.

Tolerances, the bfloat16 serve tests' (tests/test_torch_bf16_model.py,
tests/test_torch_bf16_stale.py), each against JAX's own bfloat16-vs-float32
gap on the same inputs:
- logits: under batch BN max |port − JAX bf16| at most half of max |JAX
  bf16 − JAX f32|, under stale BN the same with the RMS in place of the
  maximum (single elements whose float32 attention output lies at a
  bfloat16 rounding boundary round one ulp apart);
- each latent, under both BN modes: the RMS at most half of the gap's RMS,
  and no element further than the gap's maximum. A latent is a bfloat16
  Dense, BN and ReLU off the decoder; a Dense product whose float32 sum
  (in another order in torch and in XLA) lies at a bfloat16 rounding
  boundary rounds one ulp apart (2^-7 at 1), and the BN scales it: under
  batch BN 214 of latent0's 65,536 elements differ by over 1e-3, the
  largest by 0.0132 against a gap of 0.0245, while the RMS is 0.07 of the
  gap's;
- the argmax of the logits agreeing with JAX bf16's on ≥ 99.5% of points;
  the confusion equal to the argmax's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_bf16_parity as bp
import torch_eval_parity as ep
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.models import load_jax_variables

HALF = 0.5
LATENTS = ["latent0", "latent1", "latent2"]


def feature_parts(bn_mode, dtype, tree, data):
    """JAX make_eval_step(with_features=True, output='logits') as (function,
    arguments, finish) for References.add → (logits, confusion, {latent})."""
    step = jax_make_eval_step(bp.jax_model(bn_mode, dtype),
                              JaxStepConfig(num_classes=bp.NUM_CLASSES, spec=bp.JAX_SPEC),
                              with_features=True, output="logits")
    state = bp._State(params=tree["params"], batch_stats=tree["batch_stats"])

    def finish(out):
        logits, conf, feats = jax.device_get(out)
        return (np.asarray(logits, np.float32), np.asarray(conf),
                {k: np.asarray(v, np.float32) for k, v in feats.items()})

    return step, (state, {k: jnp.asarray(v) for k, v in data.items()}), finish


@pytest.fixture(scope="module")
def runs():
    tree, data = ep.tree(), bp.batch(seed=6)
    refs = bp.References()
    refs.add("batch", feature_parts("batch", jnp.bfloat16, tree, data),
             key=("eval_features", "batch", "bfloat16"))
    with pytest.MonkeyPatch.context() as mp, bp.reference_sums():
        mp.setenv("PT_ATTN", "interpret")
        refs.add("stale", feature_parts("stale", jnp.bfloat16, tree, data),
                 key=("eval_features", "stale", "bfloat16"))
    out = refs.run()
    out["f32"] = ep.jax_features(data)
    for mode in ("batch", "stale"):
        model = load_jax_variables(bp.port_model(mode, torch.bfloat16), tree)
        step = make_eval_step(model, bp.SPEC, device="cpu", with_features=True, output="logits")
        logits, conf, feats = step(data)
        out[f"port_{mode}"] = (logits.numpy(), conf.numpy(),
                               {k: v.numpy() for k, v in feats.items()})
        out[f"port_probs_{mode}"] = make_eval_step(model, bp.SPEC, device="cpu")(data)[0].numpy()
    out["labels"] = data["labels"]
    return out


def _gap(got, ref, f32, bn_mode):
    if bn_mode == "batch":
        return np.abs(got - ref).max(), np.abs(ref - f32).max()
    return bp.rms(got, ref), bp.rms(ref, f32)


@pytest.mark.parametrize("bn_mode", ["batch", "stale"])
def test_bf16_feature_step_matches_jax(runs, bn_mode):
    logits, conf, feats = runs[f"port_{bn_mode}"]
    ref_logits, ref_conf, ref_feats = runs[bn_mode]
    f32_logits, _, f32_feats = runs["f32"]
    assert logits.dtype == np.float32 and np.isfinite(logits).all()
    got, gap = _gap(logits, ref_logits, f32_logits, bn_mode)
    assert got <= HALF * gap, ("logits", got, gap)
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).mean()
    assert agree >= 0.995, agree
    assert sorted(feats) == sorted(ref_feats) == LATENTS
    for k in LATENTS:
        assert feats[k].shape == ref_feats[k].shape == (ep.B, ep.N, 32), k
        assert feats[k].dtype == np.float32 and np.isfinite(feats[k]).all(), k
        got, gap = bp.rms(feats[k], ref_feats[k]), bp.rms(ref_feats[k], f32_feats[k])
        assert got <= HALF * gap, (k, got, gap)
        got, gap = (np.abs(feats[k] - ref_feats[k]).max(),
                    np.abs(ref_feats[k] - f32_feats[k]).max())
        assert got <= gap, (k, got, gap)
    # the confusion is the step's own argmax against the labels
    valid = runs["labels"] >= 0
    expect = np.zeros_like(conf)
    np.add.at(expect, (runs["labels"][valid], logits.argmax(-1)[valid]), 1)
    np.testing.assert_array_equal(conf, expect)
    assert ref_conf.sum() == conf.sum()


@pytest.mark.parametrize("bn_mode", ["batch", "stale"])
def test_bf16_feature_logits_are_the_served_probs(runs, bn_mode):
    """softmax of the feature step's logits = the served probs of the same
    bfloat16 model (max |d| ≤ 1e-6), the same argmax."""
    logits = runs[f"port_{bn_mode}"][0]
    probs = runs[f"port_probs_{bn_mode}"]
    np.testing.assert_allclose(torch.softmax(torch.as_tensor(logits), -1).numpy(), probs,
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(logits.argmax(-1), probs.argmax(-1))
