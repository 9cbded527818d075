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


@pytest.mark.parametrize("width,c", [(4, 3), (5, 3), (6, 3), (6, 8)])
def test_bwd_plain_matches_pallas_bwd_on_wide_windows(width, c):
    """window_gather_bwd_plain against the backward of the Pallas kernel
    (tile_gather_pl.py::tile_window_gather_pl, interpret mode) on windows of
    4-6 tiles, the widths of the cross-level gathers, and at C = 3; integer
    cotangents, so the sums are exact in any order."""
    from contrastboundary_tpu.ops.pallas.tile_gather_pl import tile_window_gather_pl

    rng = np.random.RandomState(width * 10 + c)
    b, tile, k = 2, 16, 5
    m = tile * (width + 2)
    x = rng.randint(-4, 5, (b, m, c)).astype(np.float32)
    li = _idx(rng, b, m, k, tile * width)
    g = rng.randint(-3, 4, (b, m, k, c)).astype(np.float32)
    _, vjp = jax.vjp(
        lambda v: tile_window_gather_pl(v, jnp.asarray(li), tile, width, True), jnp.asarray(x)
    )
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    starts = torch.as_tensor(tile_gather.window_starts(m // tile, width), dtype=torch.int32)
    got = tg.window_gather_bwd_plain(torch.as_tensor(g), torch.as_tensor(li), starts, tile, width, m)
    np.testing.assert_array_equal(got.numpy(), ref)


# (query tiles, support tiles) of the flagship pyramid's gathers at
# N = 65536, tile 256 (self levels; TransitionDown; interpolation and the
# K = 1 gathers onto level 0), and small ones
GEOMETRIES = [(256, 256), (64, 64), (1, 1), (64, 256), (16, 64), (1, 4), (256, 64),
              (64, 16), (256, 16), (256, 4), (256, 1), (4, 1), (3, 8), (8, 3), (5, 5)]


@pytest.mark.parametrize("gq,gs", GEOMETRIES)
def test_covering_query_tiles_are_one_range(gq, gs):
    """The window-gather backward kernel finds the query tiles whose windows
    hold support tile s as one contiguous range, by two binary searches over
    the window starts (first start >= s - width + 1, first start > s). Held
    against a brute-force enumeration of the windows, for the self
    geometry's starts (gq == gs, every odd width) and the cross geometry's."""
    if gq == gs:
        cases = [(w, tile_gather.window_starts(gq, w)) for w in range(1, gq + 1, 2)]
    else:
        width = min(-(-gs // gq) + 2, gs)
        cases = [(width, tile_gather.cross_window_starts(gq, gs, width, 1))]
    for width, starts in cases:
        assert np.all(np.diff(starts) >= 0)
        for s in range(gs):
            brute = [g for g in range(gq) if starts[g] <= s < starts[g] + width]
            lo = int(np.searchsorted(starts, s - width + 1, side="left"))
            hi = int(np.searchsorted(starts, s + 1, side="left"))
            assert brute == list(range(lo, hi)), (width, s)


def test_bwd_plain_sums_in_slot_order():
    """On the CPU window_gather_bwd_plain is the sequential float32 sum of
    each row's slots in ascending slot order (q, then k), as np.add.at adds,
    bit for bit: the order the CUDA kernel sums in. Random floats of mixed
    magnitudes, so another order would round differently."""
    rng = np.random.RandomState(4)
    b, m, k, c, tile, width = 2, 64, 6, 5, 16, 3
    li = _idx(rng, b, m, k, tile * width)
    g = (rng.randn(b, m, k, c) * 10.0 ** rng.randint(-4, 5, (b, m, k, 1))).astype(np.float32)
    starts = tile_gather.window_starts(m // tile, width)
    got = tg.window_gather_bwd_plain(torch.as_tensor(g), torch.as_tensor(li),
                                     torch.as_tensor(starts, dtype=torch.int32), tile, width, m)
    ref = np.zeros((b, m, c), np.float32)
    rows = np.repeat(starts * tile, tile)[None, :, None] + li
    valid = li < tile * width
    bi = np.broadcast_to(np.arange(b)[:, None, None], li.shape)
    np.add.at(ref, (bi[valid], rows[valid]), g[valid])
    np.testing.assert_array_equal(got.numpy().view(np.int32), ref.view(np.int32))
