"""The port's CBL routes other than the dense window (losses/contrast.py
with CBL_DENSE=off): the XLA tile route (impl='xla') and the fused v2
kernel (impl='auto' | 'pallas'), against JAX's cbl_stage_loss and cbl_loss
with CBL_DENSE=off on the CPU (the train step on each route is in
tests/test_torch_train.py). JAX takes its XLA tile route there whatever
impl says (its v2 probe fails off a TPU), so the v2 route is also held
against the v2 Pallas kernel in interpret mode.

Tolerances. Both XLA routes compute the same expressions, elementwise
(q − s), and differ in float32 sum order only: loss rtol 1e-5 and gradient
1e-5 of its scale. The v2 route against JAX's XLA route adds the running
rescale of the sums (a few ulp): loss rtol 1e-5 and gradient 1e-5 of its
scale, as tests/test_cbl_pallas2.py holds the two in JAX (rtol 1e-5, atol
1e-6 on gradients of scale ~0.1).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.losses.contrast import ContrastConfig as JaxContrast
from contrastboundary_tpu.losses.contrast import cbl_loss as jax_cbl_loss
from contrastboundary_tpu.losses.contrast import cbl_stage_loss as jax_stage_loss
from contrastboundary_tpu.ops.pallas.cbl_tile2 import cbl_tile_softnn2 as jax_v2
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu_torch.losses import ContrastConfig, cbl_loss, cbl_stage_loss
from contrastboundary_tpu_torch.losses.contrast import dense_route
from contrastboundary_tpu_torch.ops.cuda import cbl_dense, cbl_tile2
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid
from test_cbl_dense import _case
from torch_parity import synthetic_crops

ROUTES = ("xla", "pallas")
K_CONTRAST = (36, 24, 24, 24, 24)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def dense_off(monkeypatch):
    monkeypatch.setenv("CBL_DENSE", "off")


def _close(got, ref, dgot, dref):
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    np.testing.assert_allclose(dgot, dref, rtol=0, atol=1e-5 * np.abs(dref).max())


def _normalized(f):
    return f / jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-12)


# (options, case): tests/test_cbl_dense.py's cases, duplicate feature rows
# (zero distances) and rows whose every slot is a shadow among them
STAGE_CASES = [
    ({}, {}),
    ({"temperature": 0.5}, {"duplicates": True, "seed": 3}),
    ({"dist": "norml2"}, {"seed": 5}),
    ({"dist": "norml2", "temperature": 0.5}, {"seed": 2}),
]


@pytest.mark.parametrize("impl", ROUTES)
@pytest.mark.parametrize("cfg_kw, case_kw", STAGE_CASES)
def test_stage_loss_routes_match_jax(dense_off, impl, cfg_kw, case_kw):
    feats, onehot, li, tile, width = _case(**case_kw)
    if case_kw.get("seed") == 5:
        li = li.at[:, :3].set(width * tile)  # rows with every slot a shadow
    fn = lambda f: jax_stage_loss(f, li, onehot, JaxContrast(**cfg_kw), local=(tile, width))
    ref, dref = jax.value_and_grad(fn)(feats)
    counts = (tg.launches, cbl_tile2.fwd_launches, cbl_dense.fwd_launches)
    ft = _t(feats).requires_grad_()
    got = cbl_stage_loss(ft, _t(li), _t(onehot), ContrastConfig(impl=impl, **cfg_kw), (tile, width))
    got.backward()
    assert counts == (tg.launches, cbl_tile2.fwd_launches, cbl_dense.fwd_launches)  # CPU: plain
    _close(float(got.detach()), float(ref), ft.grad.numpy(), np.asarray(dref))
    if impl == "pallas":  # the v2 kernel itself, in interpret mode
        temp = cfg_kw.get("temperature", 1.0)
        pre = _normalized if cfg_kw.get("dist") == "norml2" else (lambda f: f)

        def v2(f):
            ls, ms = jax_v2(pre(f), onehot, li, temp, tile, width, (width - 1) // 2, True)
            return jnp.sum(ls) / jnp.maximum(jnp.sum(ms), 1.0) * 0.1
        ref2, dref2 = jax.value_and_grad(v2)(feats)
        _close(float(got.detach()), float(ref2), ft.grad.numpy(), np.asarray(dref2))


def test_routes_follow_cbl_dense_and_impl(monkeypatch):
    """The reference's order: the dense route unless CBL_DENSE=off, then v2
    for impl 'auto' or 'pallas', else the tile route ('auto' has no
    fallback: it is v2)."""
    feats, onehot, li, tile, width = _case(seed=1)
    args = (_t(feats), _t(li), _t(onehot))
    calls = []
    for mod, name in ((cbl_dense, "cbl_stats_fwd"), (cbl_tile2, "cbl_tile2_fwd"),
                      (tg, "window_gather")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    expect = {("auto", "xla"): "cbl_stats_fwd", ("on", "pallas"): "cbl_stats_fwd",
              ("off", "xla"): "window_gather", ("off", "auto"): "cbl_tile2_fwd",
              ("off", "pallas"): "cbl_tile2_fwd"}
    for (mode, impl), route in expect.items():
        monkeypatch.setenv("CBL_DENSE", mode)
        calls.clear()
        cbl_stage_loss(*args, ContrastConfig(impl=impl), (tile, width))
        assert calls == [route], (mode, impl, calls)
    monkeypatch.delenv("CBL_DENSE")
    assert dense_route()
    monkeypatch.setenv("CBL_DENSE", "interpret")  # a JAX test hook
    with pytest.raises(ValueError, match="CBL_DENSE"):
        cbl_stage_loss(*args, ContrastConfig(), (tile, width))


@pytest.fixture(scope="module")
def five_stage_case():
    """A small pyramid, sorted labels and latents, and JAX's cbl_loss and
    its gradient on them (its XLA tile route)."""
    pts, _, labels = synthetic_crops(2, 2048, seed=8)
    labels[:, ::53] = -1
    jspec = JaxSpec(k_contrast=K_CONTRAST, with_subscene=True, layout="sorted", sampler="strided")
    jp = jax_build_pyramid(jnp.asarray(pts), jspec)
    tp = build_pyramid(_t(pts), PyramidSpec(k_contrast=K_CONTRAST, with_subscene=True))
    lab = np.take_along_axis(labels, np.asarray(jp.order0), 1)
    rng = np.random.RandomState(9)
    latents = [rng.randn(2, p.shape[1], 32).astype(np.float32) for p in jp.points]
    fn = lambda lat: jax_cbl_loss(lat, jp, jnp.asarray(lab), 13, JaxContrast())
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBL_DENSE", "off")
        (ref, ref_per), dref = jax.jit(jax.value_and_grad(fn, has_aux=True))(
            [jnp.asarray(x) for x in latents])
    return tp, lab, latents, ref, ref_per, dref


@pytest.mark.parametrize("impl", ROUTES)
def test_cbl_loss_over_five_stages_routes_match_jax(dense_off, five_stage_case, impl):
    tp, lab, latents, ref, ref_per, dref = five_stage_case
    lt = [_t(x).requires_grad_() for x in latents]
    got, per = cbl_loss(lt, tp, _t(lab).long(), 13, ContrastConfig(impl=impl))
    got.backward()
    assert set(per) == set(ref_per) == {f"cbl_stage{i}" for i in range(5)}
    for k in per:
        np.testing.assert_allclose(float(per[k].detach()), float(ref_per[k]), rtol=1e-5, err_msg=k)
    for i in range(5):
        _close(float(got.detach()), float(ref), lt[i].grad.numpy(), np.asarray(dref[i]))
