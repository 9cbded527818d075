"""The port's window top-k (plain version of ops/cuda/win_topk.py, which the
CUDA kernel matches bit for bit on the card) against the JAX Pallas kernel
contrastboundary_tpu/ops/pallas/win_topk.py::window_topk in interpret mode,
at the flagship pyramid's (tile = 256, width, k, mode) combinations: the
merged self+contrast search (k = 36), the eval self search with ensure_self,
the TransitionDown searches over 4 and 6 support tiles (and 5 between them),
an interpolation search, and k > W. One cloud, the fewest tiles that give
each width, on an integer grid with duplicated rows, so every distance is
exact and ties are common: indices and values must be equal. The JAX kernel
leaves an arbitrary index beside a -inf value, which its callers map to the
shadow W; the port returns (W, -inf) directly, so the JAX slots are mapped
the same way before the comparison."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.core.gather import batch_gather as jax_batch_gather
from contrastboundary_tpu.ops.pallas.win_topk import window_topk as jax_window_topk
from contrastboundary_tpu.ops.sampling import serialized_order as jax_order
from contrastboundary_tpu_torch.ops.cuda import win_topk as wt
from contrastboundary_tpu_torch.ops.knn import cross_width, self_width


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """One torch thread: the suite's six workers with torch's default of a
    thread a core oversubscribe the cores (as tests/test_torch_main.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TILE = 256


def grid_cloud(seed, n, side=12):
    """Morton-sorted integer-grid cloud [1, n, 3] with duplicated rows."""
    rng = np.random.RandomState(seed)
    p = rng.randint(0, side, (1, n, 3)).astype(np.float32)
    p[0, rng.randint(0, n, n // 8)] = p[0, rng.randint(0, n, n // 8)]
    pj = jnp.asarray(p)
    return np.array(jax_batch_gather(pj, jax_order(pj)))


def jax_shadowed(query, support, k, gs, **kw):
    idx, val = jax_window_topk(jnp.asarray(query), jnp.asarray(support), k, gs=gs,
                               interpret=True, **kw)
    idx, val = np.asarray(idx), np.asarray(val)
    return np.where(np.isinf(val), kw["width"] * kw["tile"], idx), val


@pytest.mark.parametrize(
    "m,k,mode",
    [
        (768, 36, "plain"),  # the training pyramid's merged self+contrast search
        (768, 36, "ensure_self"),
        (768, 16, "exclude_self"),
        (256, 260, "exclude_self"),  # k > W - 1: shadow slots after the window
    ],
)
def test_self_window_topk_plain_matches_pallas(m, k, mode):
    pts = grid_cloud(m + k, m)
    width = self_width(m // TILE, 1)
    kw = dict(tile=TILE, width=width, window=1, mode=mode)
    j_idx, j_val = jax_shadowed(pts, pts, k, None, **kw)
    t_idx, t_val = wt.window_topk_plain(torch.as_tensor(pts), torch.as_tensor(pts), k, **kw)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_val.numpy(), j_val)


@pytest.mark.parametrize(
    "m,ns,k",
    [
        (256, 1024, 16),  # TransitionDown onto the deepest level: 4 tiles
        (512, 2048, 16),  # TransitionDown elsewhere: 6 tiles (W = 1536)
        (512, 1536, 16),  # 5 tiles
        (3072, 768, 3),  # interpolation, 3 support tiles
        (256, 256, 300),  # k > W = 256: shadow slots
    ],
)
def test_cross_window_topk_plain_matches_pallas(m, ns, k):
    big = grid_cloud(m + ns + k, max(m, ns))
    q = big[:, :m] if m <= ns else big
    s = big[:, :ns] if ns <= m else big
    if m < ns:  # a strided pick of the support, as the pyramid's levels are
        q = big[:, np.linspace(0, ns - 1, m).astype(np.int64)]
    elif ns < m:
        s = big[:, np.linspace(0, m - 1, ns).astype(np.int64)]
    gq, gs = m // TILE, ns // TILE
    kw = dict(tile=TILE, width=cross_width(gq, gs, 1), window=1)
    j_idx, j_val = jax_shadowed(q, s, k, gs, **kw)
    t_idx, t_val = wt.window_topk_plain(torch.as_tensor(q), torch.as_tensor(s), k, **kw)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_array_equal(t_val.numpy(), j_val)
