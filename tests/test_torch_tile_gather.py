"""Port tile gathers (contrastboundary_tpu_torch/ops/tile_gather.py, plain
version of the gather kernel on CPU) against the Pallas forward in
interpret mode and the JAX cross-window gather: row selections, so equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.ops.pallas.tile_gather_pl import tile_window_gather_pl
from contrastboundary_tpu.ops.tile_gather import cross_window_gather as jax_cross_gather
from contrastboundary_tpu.ops.tile_gather import cross_window_starts as jax_cross_starts
from contrastboundary_tpu.ops.tile_gather import window_starts as jax_window_starts
from contrastboundary_tpu_torch.ops import tile_gather as ttg


@pytest.mark.parametrize("g,tile,width,k,c", [(4, 32, 3, 5, 16), (1, 8, 1, 16, 3), (6, 16, 3, 8, 35)])
def test_tile_window_gather_matches_pallas(g, tile, width, k, c):
    rng = np.random.RandomState(g * c)
    m = g * tile
    x = rng.randn(2, m, c).astype(np.float32)
    li = rng.randint(0, width * tile + 1, (2, m, k)).astype(np.int32)  # W = shadow
    ref = tile_window_gather_pl(jnp.asarray(x), jnp.asarray(li), tile, width, True)
    out = ttg.tile_window_gather(torch.as_tensor(x), torch.as_tensor(li), tile, width)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize(
    "gq,gs,tile,window,k,c",
    [(4, 16, 16, 1, 16, 19), (16, 4, 16, 1, 3, 64), (64, 1, 8, 1, 1, 32), (1, 4, 8, 1, 16, 3)],
)
def test_cross_window_gather_matches_jax(gq, gs, tile, window, k, c):
    rng = np.random.RandomState(gq * gs + c)
    width = min(-(-gs // gq) + 2 * window, gs)
    x = rng.randn(2, gs * tile, c).astype(np.float32)
    li = rng.randint(0, width * tile + 1, (2, gq * tile, k)).astype(np.int32)
    ref = jax_cross_gather(jnp.asarray(x), jnp.asarray(li), gs * tile, tile, width, window)
    out = ttg.cross_window_gather(
        torch.as_tensor(x), torch.as_tensor(li), gs * tile, tile, width, window
    )
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_window_starts_match_jax():
    for g, width in [(16, 3), (1, 1), (2, 2), (7, 3)]:
        np.testing.assert_array_equal(ttg.window_starts(g, width), jax_window_starts(g, width))
    for gq, gs, width, window in [(4, 16, 6, 1), (16, 4, 3, 1), (256, 1, 1, 1), (1, 4, 4, 1)]:
        np.testing.assert_array_equal(
            ttg.cross_window_starts(gq, gs, width, window),
            jax_cross_starts(gq, gs, width, window),
        )
