"""The port's feature eval step, make_eval_step(output='logits',
with_features=True), against the JAX package's on the CPU: a small float32
model (planes 16, 32, 64) from seeded flax weights, under batch BN and under
bn_mode='stale' (the fused attention's plain version), on seeded crops.

Tolerance: the eval step's 1e-4 (tests/test_torch_model.py) on the logits
and on every stage latent taken to level 0 in the caller's row order; the
confusion exact. Eval-mode BN is the same function under batch and stale
BN, so JAX's batch-BN step, compiled once, is the reference for both."""
import dataclasses

import numpy as np
import pytest
import torch

import torch_bf16_parity as bp
import torch_eval_parity as ep
from contrastboundary_tpu_torch.eval.run import run_enumerate_eval, run_voting_eval
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.ops.pyramid import build_pyramid

TOL = 1e-4


@pytest.fixture(scope="module")
def data():
    return bp.batch(seed=6)


@pytest.fixture(scope="module")
def jax_out(data):
    return ep.jax_features(data)


@pytest.mark.parametrize("bn_mode", ["batch", "stale"])
def test_feature_eval_step_matches_jax(data, jax_out, bn_mode):
    j_logits, j_conf, j_feats = jax_out
    model = ep.port_model(bn_mode)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    logits, conf, feats = make_eval_step(model, ep.SPEC, device="cpu", with_features=True,
                                         output="logits")(data)
    np.testing.assert_allclose(logits.numpy(), j_logits, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(logits.argmax(-1).numpy(), j_logits.argmax(-1))
    np.testing.assert_array_equal(conf.numpy(), j_conf)
    # every stage has a latent: planes 16, 32, 64 → base_fdim 32 at level 0
    assert sorted(feats) == sorted(j_feats) == ["latent0", "latent1", "latent2"]
    for k, v in feats.items():
        assert v.shape == (ep.B, ep.N, 32) and v.dtype == torch.float32, k
        np.testing.assert_allclose(v.numpy(), j_feats[k], rtol=TOL, atol=TOL, err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_feature_step_outputs_agree_with_each_other(data):
    """probs = softmax(logits); the features do not depend on ``output``;
    without features the step returns (probs, confusion) as before."""
    model = ep.port_model()
    logits, conf, feats = make_eval_step(model, ep.SPEC, device="cpu", with_features=True,
                                         output="logits")(data)
    probs, conf_p, feats_p = make_eval_step(model, ep.SPEC, device="cpu",
                                            with_features=True)(data)
    plain = make_eval_step(model, ep.SPEC, device="cpu")(data)
    assert len(plain) == 2
    torch.testing.assert_close(probs, torch.softmax(logits, -1), rtol=0, atol=1e-6)
    assert torch.equal(plain[0], probs) and torch.equal(plain[1], conf)
    assert torch.equal(conf_p, conf)
    assert feats_p.keys() == feats.keys()
    for k in feats:
        assert torch.equal(feats[k], feats_p[k])
    with pytest.raises(ValueError, match="output"):
        make_eval_step(model, ep.SPEC, device="cpu", output="argmax")


def test_eval_mode_model_returns_logits_unless_asked_for_latents(data):
    """In eval mode the model returns bare logits, as every caller before
    the feature step reads them; with_latents=True gives the same logits in
    a ModelOutput, with each stage's latent at its own level."""
    model = ep.port_model().eval()
    pts = torch.as_tensor(data["points"])
    pyr = build_pyramid(pts, dataclasses.replace(ep.SPEC, k_contrast=None, with_subscene=False))
    feats = torch.as_tensor(data["features"])[torch.arange(ep.B)[:, None], pyr.order0]
    with torch.no_grad():
        logits = model(feats, pyr)
        out = model(feats, pyr, with_latents=True)
    assert isinstance(logits, torch.Tensor) and torch.equal(out.logits, logits)
    assert [tuple(l.shape) for l in out.latents] == [
        (ep.B, p.shape[1], 32) for p in pyr.points]


@pytest.mark.parametrize("entry", [run_voting_eval, run_enumerate_eval])
def test_eval_entry_points_need_cuda_unless_cpu(monkeypatch, entry):
    """The eval entry points run the eval step on the card by default and raise
    without one, before any room is read."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry(ep.port_model(), ep.SPEC, None)
