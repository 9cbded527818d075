"""The CBL on the natural layout's tile contrast search
(``contrast_mode='tile'``: each stage's latents and labels taken in the
level's Morton order, window-relative neighbours) against the JAX
package's cbl_loss on the CPU, and against the port's dense natural loss.

- Against JAX on its CPU route (the XLA tile route): the port's XLA tile
  route (CBL_DENSE=off, impl 'xla') and its v2 route (impl 'pallas') per
  stage rtol 1e-5 and gradients rtol 1e-4, atol 1e-6, as
  tests/test_tile_gather.py holds JAX's tile mode to its dense mode; the
  dense-window route (the default) at the two routes' tolerance of
  tests/test_torch_cbl.py (loss rel 3e-5, gradient 0.4% of its scale).
- Tile mode against the dense natural search on the same points, the
  contrast window covering every tile (the same neighbour sets; random
  coordinates, so no distance ties): per stage rtol 1e-5 and gradients
  rtol 1e-4, atol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.losses.contrast import ContrastConfig as JaxContrast
from contrastboundary_tpu.losses.contrast import cbl_loss as jax_cbl_loss
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu_torch.losses import ContrastConfig, cbl_loss
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid
from test_torch_cbl import _close_to_reference_route
from torch_parity import synthetic_crops

SPEC = dict(strides=(1, 4, 4), k_self=(8, 16, 16), k_down=(8, 16, 16), k_contrast=(24, 12, 12),
            with_subscene=True, sampler="fps", layout="natural", contrast_mode="tile",
            contrast_tile=64, contrast_window=1)
STAGES = (0, 1, 2)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def reference():
    """The grid crops, both pyramids, latents, labels and JAX's losses and
    latent gradients (one compile)."""
    pts, _, labels = synthetic_crops(2, 1024, seed=8)
    labels[:, ::53] = -1
    jp = jax_build_pyramid(jnp.asarray(pts), JaxSpec(**SPEC))
    tp = build_pyramid(_t(pts), PyramidSpec(**SPEC))
    rng = np.random.RandomState(9)
    latents = [rng.randn(2, p.shape[1], 32).astype(np.float32) for p in jp.points]
    cfg = JaxContrast(stages=STAGES)

    def fn(lat):
        return jax_cbl_loss(lat, jp, jnp.asarray(labels), 13, cfg)
    (_, per), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(
        [jnp.asarray(x) for x in latents])
    return dict(pts=pts, labels=labels, tp=tp, jp=jp, latents=latents,
                per={k: float(v) for k, v in per.items()}, grads=[np.asarray(g) for g in grads])


def _port_loss(pyramid, latents, labels, cfg):
    lt = [_t(x).requires_grad_() for x in latents]
    total, per = cbl_loss(lt, pyramid, _t(labels).long(), 13, cfg)
    total.backward()
    return {k: float(v.detach()) for k, v in per.items()}, [x.grad.numpy() for x in lt]


def test_the_pyramid_is_in_tile_mode(reference):
    tp = reference["tp"]
    assert [o is not None for o in tp.contrast_order] == [True] * 3
    assert tp.contrast_local == ((64, 3), (64, 3), (64, 1))
    for o, jo in zip(tp.contrast_order, reference["jp"].contrast_order):
        np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


@pytest.mark.parametrize("route", ["xla", "pallas", "dense"])
def test_tile_mode_cbl_matches_jax(reference, monkeypatch, route):
    if route == "dense":
        monkeypatch.delenv("CBL_DENSE", raising=False)
    else:
        monkeypatch.setenv("CBL_DENSE", "off")
    cfg = ContrastConfig(stages=STAGES, impl="xla" if route == "dense" else route)
    per, grads = _port_loss(reference["tp"], reference["latents"], reference["labels"], cfg)
    assert set(per) == set(reference["per"]) == {f"cbl_stage{i}" for i in STAGES}
    for i, k in enumerate(sorted(per)):
        if route == "dense":
            _close_to_reference_route(per[k], reference["per"][k], grads[i], reference["grads"][i])
            continue
        np.testing.assert_allclose(per[k], reference["per"][k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(grads[i], reference["grads"][i], rtol=1e-4, atol=1e-6)
    assert all(v > 0 for v in per.values())


def test_tile_mode_cbl_matches_the_dense_natural_loss(monkeypatch):
    """A contrast window over every tile: the tile search finds the dense
    search's neighbours, so the loss (a masked mean over rows, taken in
    another order) and its gradient are the dense natural loss's."""
    monkeypatch.setenv("CBL_DENSE", "off")
    rng = np.random.RandomState(4)
    pts = rng.rand(2, 1024, 3).astype(np.float32)
    labels = (pts[..., 0] * 3 + pts[..., 1] * 2).astype(np.int64) % 4
    dense = dict(SPEC, contrast_mode="dense")
    full = dict(SPEC, contrast_window=16)
    latents = [rng.randn(2, n, 32).astype(np.float32) for n in (1024, 256, 64)]
    cfg = ContrastConfig(stages=STAGES, weight=1.0)
    tile_pyr = build_pyramid(_t(pts), PyramidSpec(**full))
    assert tile_pyr.contrast_local == ((64, 16), (64, 4), (64, 1))
    per_t, g_t = _port_loss(tile_pyr, latents, labels, cfg)
    per_d, g_d = _port_loss(build_pyramid(_t(pts), PyramidSpec(**dense)), latents, labels, cfg)
    for k in per_d:
        np.testing.assert_allclose(per_t[k], per_d[k], rtol=1e-5, err_msg=k)
    for a, b in zip(g_t, g_d):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
