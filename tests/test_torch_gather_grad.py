"""Backward of the port's window gathers (ops/tile_gather.py, plain version
of ops/cuda/tile_gather.py::window_gather_bwd) against jax.vjp of the JAX
tile_window_gather and cross_window_gather (transposed one-hot matmuls).
Cotangents are small integers, so every sum is exact in float32 whatever
its order: the gradients must be equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.ops.tile_gather import cross_window_gather as jax_cross
from contrastboundary_tpu.ops.tile_gather import tile_window_gather as jax_tile
from contrastboundary_tpu_torch.ops import tile_gather
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg


def _idx(rng, b, m, k, w_sz):
    """Window-relative indices with repeats and shadow slots (w_sz)."""
    li = rng.randint(0, w_sz + 1, (b, m, k)).astype(np.int32)
    li[:, ::5, -1] = w_sz
    return li


@pytest.mark.parametrize("c", [3, 8])
def test_self_gather_grad_matches_jax(c):
    rng = np.random.RandomState(0)
    b, m, k, tile, width = 2, 64, 5, 16, 3
    x = rng.randint(-4, 5, (b, m, c)).astype(np.float32)
    li = _idx(rng, b, m, k, tile * width)
    g = rng.randint(-3, 4, (b, m, k, c)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jax_tile(v, jnp.asarray(li), tile, width), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])

    xt = torch.as_tensor(x).requires_grad_()
    out = tile_gather.tile_window_gather(xt, torch.as_tensor(li), tile, width)
    out.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(xt.grad.numpy(), ref)


@pytest.mark.parametrize("mq,ns,tile", [(64, 256, 16), (256, 64, 16), (32, 32, 8)])
def test_cross_gather_grad_matches_jax(mq, ns, tile):
    rng = np.random.RandomState(1)
    b, k, c, window = 2, 3, 4, 1
    gq, gs = mq // tile, ns // tile
    width = min(-(-gs // gq) + 2 * window, gs)
    x = rng.randint(-4, 5, (b, ns, c)).astype(np.float32)
    li = _idx(rng, b, mq, k, tile * width)
    g = rng.randint(-3, 4, (b, mq, k, c)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda v: jax_cross(v, jnp.asarray(li), ns, tile, width, window), jnp.asarray(x)
    )
    ref = np.asarray(vjp(jnp.asarray(g))[0])

    xt = torch.as_tensor(x).requires_grad_()
    out = tile_gather.cross_window_gather(xt, torch.as_tensor(li), ns, tile, width, window)
    out.backward(torch.as_tensor(g))
    np.testing.assert_array_equal(xt.grad.numpy(), ref)


def test_bwd_plain_is_the_transpose_of_the_forward():
    """<gather(x), g> == <x, gather_bwd(g)> on random floats (to float32
    rounding), and no backward launch is counted on the CPU."""
    rng = np.random.RandomState(2)
    b, m, k, c, tile, width = 2, 48, 4, 6, 16, 3
    x = torch.as_tensor(rng.randn(b, m, c).astype(np.float32))
    li = torch.as_tensor(_idx(rng, b, m, k, tile * width))
    starts = torch.as_tensor(tile_gather.window_starts(m // tile, width), dtype=torch.int32)
    g = torch.as_tensor(rng.randn(b, m, k, c).astype(np.float32))
    before = tg.bwd_launches
    lhs = (tg.window_gather_plain(x, li, starts, tile, width) * g).sum()
    rhs = (x * tg.window_gather_bwd_plain(g, li, starts, tile, width, m)).sum()
    assert tg.bwd_launches == before
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)
