"""Port training pyramid (contrastboundary_tpu_torch/ops/pyramid.py with
k_contrast and with_subscene) against the JAX build_pyramid with the Pallas
window top-k in interpret mode, and the port's wide-window search
(ops/knn.py, W > 2048) against JAX tile_cross_knn. Coordinates on a 1/64 m
grid make every squared distance exact in float32, so the neighbour lists
cannot differ by summation order: every integer field must be equal."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.ops.knn import tile_cross_knn as jax_tile_cross_knn
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu_torch.ops import knn
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid
from torch_parity import synthetic_crops


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """One torch thread: the suite's six workers with torch's default of a
    thread a core oversubscribe the cores (as tests/test_torch_main.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


K_CONTRAST = (36, 24, 24, 24, 24)
TRAIN_FIELDS = ("self_idx", "contrast_idx", "subscene_idx", "self_local", "contrast_local")


@pytest.fixture(scope="module")
def pyramids():
    pts, _, _ = synthetic_crops(2, 2048, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WIN_TOPK", "interpret")
        jax.clear_caches()  # the env var is read while tracing: no cached trace
        jp = jax_build_pyramid(jnp.asarray(pts), JaxSpec(
            k_contrast=K_CONTRAST, with_subscene=True, layout="sorted", sampler="strided",
        ))
    tp = build_pyramid(torch.as_tensor(pts), PyramidSpec(k_contrast=K_CONTRAST, with_subscene=True))
    return jp, tp


@pytest.mark.parametrize("field", TRAIN_FIELDS)
def test_train_pyramid_field_matches_jax(pyramids, field):
    jp, tp = pyramids
    jv, tv = getattr(jp, field), getattr(tp, field)
    assert len(tv) == len(jv) == 5
    for lvl, (a, b) in enumerate(zip(tv, jv)):
        if b is None or isinstance(b, tuple):
            assert a == b, (field, lvl)
        else:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"{field}[{lvl}]")


def test_contrast_lists_drop_self_and_keep_k_minus_one(pyramids):
    _, tp = pyramids
    for lvl, (ci, (tile, width)) in enumerate(zip(tp.contrast_idx, tp.contrast_local)):
        assert ci.shape[-1] == K_CONTRAST[lvl] - 1
        m = ci.shape[1]
        g = m // tile
        starts = np.clip(np.arange(g) - 1, 0, g - width)
        self_pos = torch.as_tensor(np.arange(m) - np.repeat(starts * tile, tile))
        assert not bool((ci == self_pos[None, :, None]).any()), lvl


@pytest.mark.parametrize("n_query,k", [(256, 16), (64, 64), (16, 256)])
def test_wide_window_search_matches_jax(n_query, k):
    pts, _, _ = synthetic_crops(2, 4096, seed=4)
    spec = PyramidSpec()
    tp = build_pyramid(torch.as_tensor(pts), spec)  # Morton-sorted level 0
    support = tp.points[0]
    pick = np.linspace(0, 4095, n_query).round().astype(np.int64)
    query = support[:, pick]
    tile = min(256, n_query)
    width = knn.cross_width(n_query // tile, 4096 // tile, 1)
    assert width * tile > knn.EXACT_TOPK_WIDTH
    before = knn.wide_calls
    idx, d2 = knn.tile_cross_knn(query, support, k, tile=tile, window=1)
    assert knn.wide_calls == before + 1
    j_idx, j_d2 = jax_tile_cross_knn(
        jnp.asarray(query.numpy()), jnp.asarray(support.numpy()), k, tile=tile, window=1,
    )
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(j_d2))


@pytest.mark.parametrize("mode", ["plain", "exclude_self", "ensure_self"])
def test_wide_search_equals_window_topk_plain(mode):
    """Below the width rule both searches run; they give the same lists,
    including k > W (shadow slots) and the self modes."""
    from contrastboundary_tpu_torch.ops.cuda import win_topk

    pts = torch.as_tensor(np.random.RandomState(5).randint(0, 8, (2, 64, 3)).astype(np.float32))
    for k in (5, 40):
        kw = dict(tile=16, width=2, window=1, mode=mode)
        a = knn.window_topk_wide(pts, pts, k, **kw)
        b = win_topk.window_topk_plain(pts, pts, k, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (mode, k)
