"""Port window searches (contrastboundary_tpu_torch/ops/knn.py, plain
version of the window top-k kernel on CPU) against the JAX functions with
the Pallas window top-k kernel in interpret mode. Integer-grid clouds with
duplicated rows make every distance exact, so indices and values must be
equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.core.gather import batch_gather as jax_batch_gather
from contrastboundary_tpu.ops.knn import tile_cross_knn as jax_cross_knn
from contrastboundary_tpu.ops.knn import tile_self_knn as jax_self_knn
from contrastboundary_tpu.ops.sampling import serialized_order as jax_order
from contrastboundary_tpu_torch.ops import knn as tknn
from contrastboundary_tpu_torch.ops.pyramid import strided_pick


def grid_cloud(rng, b, n, side=16):
    """Morton-sorted integer-grid cloud [b, n, 3] with duplicated rows."""
    p = rng.randint(0, side, (b, n, 3)).astype(np.float32)
    dup = rng.randint(0, n, (b, n // 8))
    src = rng.randint(0, n, (b, n // 8))
    for bb in range(b):
        p[bb, dup[bb]] = p[bb, src[bb]]
    pj = jnp.asarray(p)
    return np.array(jax_batch_gather(pj, jax_order(pj)))


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("WIN_TOPK", "interpret")


@pytest.mark.parametrize(
    "n,tile,k,mode",
    [
        (2048, 256, 8, "ensure_self"),
        (2048, 256, 16, "exclude_self"),
        (1024, 128, 12, "plain"),
        (8, 8, 16, "ensure_self"),  # k > W: shadow padding
        (16, 8, 16, "exclude_self"),  # k == W with self excluded
    ],
)
def test_tile_self_knn_matches_jax(interpret, n, tile, k, mode):
    rng = np.random.RandomState(n + k)
    pts = grid_cloud(rng, 2, n)
    kw = dict(tile=tile, window=1, exclude_self=mode == "exclude_self",
              ensure_self=mode == "ensure_self", assume_sorted=True)
    _, j_idx, j_w = jax_self_knn(jnp.asarray(pts), k, **kw)
    _, t_idx, t_w = tknn.tile_self_knn(torch.as_tensor(pts), k, **kw)
    assert t_w == j_w
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


def test_tile_self_knn_sorts_unsorted_input(interpret):
    rng = np.random.RandomState(1)
    p = rng.randint(0, 16, (2, 512, 3)).astype(np.float32)
    j_order, j_idx, _ = jax_self_knn(jnp.asarray(p), 8, tile=128)
    t_order, t_idx, _ = tknn.tile_self_knn(torch.as_tensor(p), 8, tile=128)
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))


@pytest.mark.parametrize(
    "nq,ns,tile,k",
    [
        (512, 2048, 256, 16),  # down: level l queries, level l-1 support
        (2048, 512, 256, 3),  # up
        (4096, 256, 256, 1),  # near0
        (32, 128, 32, 16),  # deep down
        (2048, 8, 8, 1),  # near0 onto a one-tile level
        (8, 32, 8, 3),  # up with k < W at the deepest level
    ],
)
def test_tile_cross_knn_matches_jax(interpret, nq, ns, tile, k):
    rng = np.random.RandomState(nq + ns + k)
    big = grid_cloud(rng, 2, max(nq, ns))
    small = big[:, strided_pick(big.shape[1], min(nq, ns))]
    q, s = (big, small) if nq > ns else (small, big)
    j_idx, j_d2 = jax_cross_knn(jnp.asarray(q), jnp.asarray(s), k, tile=tile)
    t_idx, t_d2 = tknn.tile_cross_knn(torch.as_tensor(q), torch.as_tensor(s), k, tile=tile)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_d2.numpy(), np.asarray(j_d2))
