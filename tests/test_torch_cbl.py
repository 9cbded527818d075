"""Port CBL (losses/contrast.py, ops/cuda/cbl_dense.py) and cross-entropy
(losses/segmentation.py) against the JAX reference on the CPU.

- The plain stats and their VJP against the JAX dense kernel
  (ops/pallas/cbl_dense.py::cbl_dense_stats) in interpret mode, on
  tests/test_cbl_dense.py's cases (duplicate rows, shadow rows and slots).
  Both take d² by the expansion |q|²+|s|²−2q·s, summed in other orders: on
  rows whose nearest valid slot is clear of the query (|m̂| > 1e-2) the
  stats agree to 1e-5; on rows with a coincident slot (the query itself or a
  duplicate) each side's d² there is cancellation noise, so m̂ is noise
  below 3e-3 on both and the sums agree to 1e-4. Counts are exact; the
  gradients agree to 1e-5 of their scale (both zero coincident pairs).
- cbl_stage_loss and cbl_loss against the reference's own CBL route
  (CBL_DENSE unset: elementwise (q − s)), at the tolerance that
  tests/test_cbl_dense.py and ROADMAP record for the two routes: loss rel
  3e-5, gradient 0.4% of its scale.
- subscene_labels exact, cross_entropy and its gradient 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.losses.contrast import ContrastConfig as JaxContrast
from contrastboundary_tpu.losses.contrast import cbl_loss as jax_cbl_loss
from contrastboundary_tpu.losses.contrast import cbl_stage_loss as jax_stage_loss
from contrastboundary_tpu.losses.contrast import subscene_labels as jax_subscene
from contrastboundary_tpu.losses.segmentation import cross_entropy as jax_ce
from contrastboundary_tpu.ops.pallas.cbl_dense import _row_meta as jax_row_meta
from contrastboundary_tpu.ops.pallas.cbl_dense import cbl_dense_stats as jax_stats
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu_torch.losses import (
    ContrastConfig, cbl_loss, cbl_stage_loss, cross_entropy, subscene_labels,
)
from contrastboundary_tpu_torch.ops.cuda import cbl_dense
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid
from test_cbl_dense import _case
from torch_parity import synthetic_crops

K_CONTRAST = (36, 24, 24, 24, 24)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("temperature", [1.0, 0.5])
@pytest.mark.parametrize("duplicates", [False, True])
def test_plain_stats_and_vjp_match_pallas_interpret(duplicates, temperature):
    feats, onehot, li, tile, width = _case(duplicates=duplicates, seed=3)
    window = (width - 1) // 2
    meta = jax_row_meta(onehot)
    np.testing.assert_array_equal(cbl_dense.row_meta(_t(onehot)).numpy(), np.asarray(meta))
    out, vjp = jax.vjp(
        lambda f: jax_stats(f, meta, li, temperature, tile, width, window, True), feats
    )
    g = np.random.RandomState(0).randn(*out.shape).astype(np.float32)
    ref, dref = np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])
    args = (_t(feats), _t(meta), _t(li))
    got = cbl_dense.cbl_stats_fwd_plain(*args, temperature, tile, width, window).numpy()
    dgot = cbl_dense.cbl_stats_bwd_plain(*args, torch.as_tensor(g), temperature, tile, width, window).numpy()

    np.testing.assert_array_equal(got[..., 3:], ref[..., 3:])
    clear = ref[..., 0] < -1e-2
    assert clear.any() and (~clear).any()
    np.testing.assert_allclose(got[clear][:, :3], ref[clear][:, :3], rtol=1e-5, atol=1e-6)
    assert np.abs(got[~clear][:, 0]).max() < 3e-3 and np.abs(ref[~clear][:, 0]).max() < 3e-3
    ratio = lambda s: s[..., 1] / np.maximum(s[..., 2], 1e-12)
    np.testing.assert_allclose(ratio(got[~clear]), ratio(ref[~clear]), rtol=1e-4)
    np.testing.assert_allclose(dgot, dref, rtol=0, atol=1e-5 * np.abs(dref).max())

    # the autograd Function runs the same two plain versions on the CPU
    ft = args[0].clone().requires_grad_()
    stats = cbl_dense.cbl_dense_stats(ft, *args[1:], temperature, tile, width, window)
    stats.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(stats.detach().numpy(), got)
    np.testing.assert_array_equal(ft.grad.numpy(), dgot)


def _close_to_reference_route(got, ref, dgot, dref):
    np.testing.assert_allclose(got, ref, rtol=3e-5)
    scale = np.abs(dref).max()
    np.testing.assert_allclose(dgot, dref, rtol=0, atol=4e-3 * scale)


@pytest.mark.parametrize("cfg_kw", [{}, {"temperature": 0.5}])
@pytest.mark.parametrize("case_kw", [{}, {"duplicates": True, "seed": 3}, {"seed": 5}])
def test_stage_loss_matches_reference_route(monkeypatch, cfg_kw, case_kw):
    monkeypatch.delenv("CBL_DENSE", raising=False)
    feats, onehot, li, tile, width = _case(**case_kw)
    if case_kw.get("seed") == 5:
        li = li.at[:, :3].set(width * tile)  # rows with every slot a shadow
    fn = lambda f: jax_stage_loss(f, li, onehot, JaxContrast(**cfg_kw), local=(tile, width))
    ref, dref = jax.value_and_grad(fn)(feats)
    ft = _t(feats).requires_grad_()
    got = cbl_stage_loss(ft, _t(li), _t(onehot), ContrastConfig(**cfg_kw), (tile, width))
    got.backward()
    _close_to_reference_route(float(got.detach()), float(ref), ft.grad.numpy(), np.asarray(dref))


def test_cbl_loss_over_five_stages_matches_reference_route(monkeypatch):
    monkeypatch.delenv("CBL_DENSE", raising=False)
    pts, _, labels = synthetic_crops(2, 2048, seed=8)
    labels[:, ::53] = -1
    jspec = JaxSpec(k_contrast=K_CONTRAST, with_subscene=True, layout="sorted", sampler="strided")
    jp = jax_build_pyramid(jnp.asarray(pts), jspec)
    tp = build_pyramid(_t(pts), PyramidSpec(k_contrast=K_CONTRAST, with_subscene=True))
    lab = np.take_along_axis(labels, np.asarray(jp.order0), 1)
    rng = np.random.RandomState(9)
    latents = [rng.randn(2, p.shape[1], 32).astype(np.float32) for p in jp.points]

    def fn(lat):
        total, per = jax_cbl_loss(lat, jp, jnp.asarray(lab), 13, JaxContrast())
        return total, per
    (ref, ref_per), dref = jax.jit(jax.value_and_grad(fn, has_aux=True))([jnp.asarray(x) for x in latents])
    lt = [_t(x).requires_grad_() for x in latents]
    got, per = cbl_loss(lt, tp, _t(lab).long(), 13, ContrastConfig())
    got.backward()
    assert set(per) == set(ref_per) == {f"cbl_stage{i}" for i in range(5)}
    for k in per:
        np.testing.assert_allclose(float(per[k].detach()), float(ref_per[k]), rtol=3e-5, err_msg=k)
    for i in range(5):
        _close_to_reference_route(float(got.detach()), float(ref), lt[i].grad.numpy(), np.asarray(dref[i]))


def test_subscene_labels_and_cross_entropy_match_jax():
    rng = np.random.RandomState(11)
    labels = rng.randint(-1, 13, (2, 300)).astype(np.int32)
    idx = rng.randint(0, 300, (2, 40, 16)).astype(np.int32)
    np.testing.assert_array_equal(
        subscene_labels(_t(labels), _t(idx), 13).numpy(),
        np.asarray(jax_subscene(jnp.asarray(labels), jnp.asarray(idx), 13)),
    )
    np.testing.assert_array_equal(
        subscene_labels(_t(labels), None, 13).numpy(),
        np.asarray(jax_subscene(jnp.asarray(labels), None, 13)),
    )
    logits = (rng.randn(2, 300, 13) * 3).astype(np.float32)
    weight = rng.rand(2, 300).astype(np.float32)
    for w in (None, weight):
        fn = lambda x: jax_ce(x, jnp.asarray(labels), -1, None if w is None else jnp.asarray(w))
        ref, dref = jax.value_and_grad(fn)(jnp.asarray(logits))
        lt = _t(logits).requires_grad_()
        got = cross_entropy(lt, _t(labels), -1, None if w is None else _t(w))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(ref), rtol=1e-6)
        np.testing.assert_allclose(lt.grad.numpy(), np.asarray(dref), rtol=1e-6, atol=1e-9)


def test_contrast_config_refuses_options_off_the_ported_route():
    assert ContrastConfig(temperature=0.5).temperature == 0.5
    # options of other option points are not fields
    for kw in ({"contrast": "nce"}, {"pos": "kl"}, {"extra_neg_rand": 8},
               {"label_infer": "nst"}, {"kl_threshold": 0.3}):
        with pytest.raises(TypeError):
            ContrastConfig(**kw)
    # dist and impl are fields, with the reference's defaults and the
    # flagship's values only
    assert (ContrastConfig().dist, ContrastConfig().impl) == (JaxContrast().dist, JaxContrast().impl)
    for kw in ({"dist": "kl"}, {"dist": "l2square"}, {"impl": "mosaic"}):
        with pytest.raises(ValueError):
            ContrastConfig(**kw)
    for t in (None, 0.0, -1.0):
        with pytest.raises(ValueError, match="temperature"):
            ContrastConfig(temperature=t)
