"""Port eval pyramid (contrastboundary_tpu_torch/ops/pyramid.py) against the
JAX build_pyramid under the flagship eval spec, plus its sampling and
interpolation pieces. Coordinates on a 1/64 m grid make every squared
distance exact in float32, so neighbour order cannot differ by summation
order: integer fields must be equal; rel and up_w agree to 1e-6."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.core.gather import shadow_gather as jax_shadow_gather
from contrastboundary_tpu.ops.interpolate import interpolation_weights as jax_idw
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu.ops.sampling import morton_code as jax_morton
from contrastboundary_tpu.ops.sampling import serialized_order as jax_order
from contrastboundary_tpu_torch.core.gather import shadow_gather
from contrastboundary_tpu_torch.ops.interpolate import interpolation_weights
from contrastboundary_tpu_torch.ops.pyramid import Pyramid, PyramidSpec, build_pyramid, strided_pick
from contrastboundary_tpu_torch.ops.sampling import morton_code, serialized_order
from torch_parity import synthetic_crops

FLOAT_FIELDS = ("self_rel", "down_rel", "up_w")


def _np(v):
    return None if v is None else np.asarray(v)


def test_eval_pyramid_matches_jax():
    pts, _, _ = synthetic_crops(2, 4096)
    jspec = JaxSpec(layout="sorted", sampler="strided")
    jp = jax_build_pyramid(jnp.asarray(pts), jspec)
    tp = build_pyramid(torch.as_tensor(pts), PyramidSpec())
    ported = {f.name for f in dataclasses.fields(Pyramid)}
    for f in dataclasses.fields(jp):
        jv = getattr(jp, f.name)
        if f.name not in ported:  # contrast / sub-scene: absent at eval
            assert all(v is None for v in jv), f.name
            continue
        tv = getattr(tp, f.name)
        if f.name == "order0":
            np.testing.assert_array_equal(tv.numpy(), _np(jv))
            continue
        assert len(tv) == len(jv), f.name
        for lvl, (a, b) in enumerate(zip(tv, jv)):
            if b is None or isinstance(b, tuple):
                assert a == b, (f.name, lvl)
            elif f.name in FLOAT_FIELDS:
                np.testing.assert_allclose(a.numpy(), _np(b), rtol=0, atol=1e-6, err_msg=f"{f.name}[{lvl}]")
            else:
                np.testing.assert_array_equal(a.numpy(), _np(b), err_msg=f"{f.name}[{lvl}]")


@pytest.mark.parametrize("n_prev,m", [(6, 3), (10, 5), (4096, 1024), (65536, 16384), (1024, 256), (12, 1), (999, 37)])
def test_strided_pick_matches_jnp_linspace(n_prev, m):
    ref = np.asarray(jnp.linspace(0, n_prev - 1, m).round().astype(jnp.int32))
    np.testing.assert_array_equal(strided_pick(n_prev, m), ref)


def test_morton_order_matches_jax():
    rng = np.random.RandomState(3)
    p = (rng.rand(2, 3000, 3) * np.array([7.0, 5.0, 3.0])).astype(np.float32)
    p[:, 100:200] = p[:, :100]  # equal codes: the stable sort keeps row order
    np.testing.assert_array_equal(morton_code(torch.as_tensor(p)).numpy(), np.asarray(jax_morton(jnp.asarray(p))))
    np.testing.assert_array_equal(serialized_order(torch.as_tensor(p)).numpy(), np.asarray(jax_order(jnp.asarray(p))))


def test_interpolation_weights_and_shadow_gather_match_jax():
    rng = np.random.RandomState(4)
    d2 = (rng.rand(2, 50, 3) * 0.1).astype(np.float32)
    d2[0, 0, 2] = np.inf  # shadow slot
    np.testing.assert_allclose(interpolation_weights(torch.as_tensor(d2)).numpy(), np.asarray(jax_idw(jnp.asarray(d2))), rtol=1e-6, atol=1e-7)
    x = rng.randn(2, 10, 4).astype(np.float32)
    idx = rng.randint(0, 11, (2, 6, 3)).astype(np.int32)  # 10 = shadow
    out, valid = shadow_gather(torch.as_tensor(x), torch.as_tensor(idx), fill=-2.0)
    j_out, j_valid = jax_shadow_gather(jnp.asarray(x), jnp.asarray(idx), fill=-2.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_out))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(j_valid))
