"""The port's windowed KNN (ops/knn.py::windowed_knn) and the top-1 tie rule
of its window top-k (ops/cuda/win_topk.py, last_ties) against the JAX
package's contrastboundary_tpu/ops/knn.py::windowed_knn on the CPU.

Coordinates sit on the 1/64 m grid (tests/torch_parity.py), so every
squared distance is exact in float32 in both packages and ties are real:
indices and d² must be equal bit for bit (d² compared as values: +0 and −0
are one value). The reference's windowed top-1 with a recall target is
``lax.approx_max_k``, whose CPU ties go to the last column; its other
searches are ``lax.top_k`` (first column), which the port keeps.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.ops.knn import windowed_knn as jax_windowed_knn
from contrastboundary_tpu_torch.ops import knn as port_knn
from contrastboundary_tpu_torch.ops.cuda import win_topk as wt
from contrastboundary_tpu_torch.ops.knn import self_width, windowed_knn
from torch_parity import synthetic_crops

N = 1024  # rows of a case's support unless it sets n (the cloud has 4096)
# name: (k, keyword arguments; "query" picks the query rows of a cross search)
CASES = {
    "self_plain": (8, dict(tile=64, window=1, recall=None)),
    "self_exclude": (11, dict(tile=64, window=1, exclude_self=True)),
    "self_ensure_radius": (16, dict(tile=64, window=2, ensure_self=True, radius=0.1)),
    "self_exclude_k_is_window": (32, dict(tile=16, window=1, exclude_self=True, recall=None,
                                         n=32)),
    "cross_down": (16, dict(tile=64, window=1, query=4)),
    "cross_up": (3, dict(tile=64, window=1, query=0.25)),
    "cross_radius": (16, dict(tile=64, window=2, radius=0.1, query=4)),
    "top1_recall": (1, dict(tile=64, window=1, query=0.25)),
    "top1_exact": (1, dict(tile=64, window=1, query=0.25, recall=None)),
    "top1_recall_exclude": (1, dict(tile=64, window=1, exclude_self=True)),
    "recall_k4": (4, dict(tile=64, window=1, query=0.25)),
    "subscene_k_over_tile": (128, dict(tile=64, window=1, query=16)),
    "wide_window": (8, dict(tile=256, window=4, ensure_self=True, n=4096)),
    "dense_dispatch": (8, dict(tile=100, window=1, ensure_self=True)),
}


@pytest.fixture(scope="module")
def cloud():
    return synthetic_crops(2, 4096, seed=4)[0]


def _inputs(cloud, kw):
    """(support, query) numpy rows of a case: the cloud's first n rows, and
    a stride of them (query = stride), their first rows (query < 1: the
    support is that fraction, the cross search from level 0 to a coarser
    level) or the support itself (a self search)."""
    pts = cloud[:, :kw.pop("n", N)]
    q = kw.pop("query", None)
    if q is None:
        return pts, None
    if q < 1:
        return np.ascontiguousarray(pts[:, :int(pts.shape[1] * q)]), pts
    return pts, np.ascontiguousarray(pts[:, ::q])


def _port(query, support, k, kw):
    s = torch.from_numpy(support)
    q = s if query is None else torch.from_numpy(query)
    return windowed_knn(q, s, k, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_windowed_knn_matches_jax(cloud, case):
    k, kw = CASES[case][0], dict(CASES[case][1])
    support, query = _inputs(cloud, kw)
    q = support if query is None else query
    ref_i, ref_d = jax_windowed_knn(jnp.asarray(q), jnp.asarray(support), k, **kw)
    before = port_knn.wide_calls
    idx, d2 = _port(query, support, k, kw)
    assert idx.dtype == torch.int32 and idx.shape == (2, q.shape[1], k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(ref_d))
    assert (port_knn.wide_calls > before) == (case == "wide_window")


def test_windowed_knn_k_over_the_window_raises_as_jax(cloud):
    pts = cloud[:, :64]
    with pytest.raises(ValueError, match="top_k"):
        jax_windowed_knn(jnp.asarray(pts), jnp.asarray(pts), 20, tile=16, window=0)
    with pytest.raises(ValueError, match="rows of a window"):
        t = torch.from_numpy(pts)
        windowed_knn(t, t, 20, tile=16, window=0)


def test_self_modes_need_query_is_support(cloud):
    t = torch.from_numpy(cloud)
    with pytest.raises(ValueError, match="query is support"):
        windowed_knn(t, t.clone(), 8, tile=64, window=1, exclude_self=True)


def test_jax_windowed_top1_with_a_recall_breaks_ties_to_the_last_row(cloud):
    """Pins the reference's rule on the CPU: its top-1 with a recall target
    takes the last of the tied rows, without one the first; the crop's
    cross search has such ties (the port's two rules differ on it)."""
    support, query = _inputs(cloud, dict(query=0.25))
    args = (jnp.asarray(query), jnp.asarray(support), 1)
    last = np.asarray(jax_windowed_knn(*args, tile=64, window=1, recall=0.95)[0])
    first = np.asarray(jax_windowed_knn(*args, tile=64, window=1, recall=None)[0])
    assert (last != first).any()
    sq, ss = torch.from_numpy(query), torch.from_numpy(support)
    np.testing.assert_array_equal(windowed_knn(sq, ss, 1, tile=64, window=1)[0].numpy(), last)
    np.testing.assert_array_equal(
        windowed_knn(sq, ss, 1, tile=64, window=1, recall=None)[0].numpy(), first)


def _grid(n, side=6):
    """Integer-grid cloud [1, n, 3] with many equal distances."""
    return torch.from_numpy(np.random.RandomState(0).randint(0, side, (1, n, 3))
                            .astype(np.float32))


@pytest.mark.parametrize("mode", ["plain", "exclude_self", "ensure_self"])
def test_last_ties_plain_version_equals_the_wide_search(mode):
    """The kernel's plain version with the tie bit (the kernel's reference
    on the card) against the sorted search of the wide windows, and, where
    slot 0 is a search's, against a numpy last-index argmax; the bit
    changes the pick on ties."""
    pts = _grid(512)
    kw = dict(tile=64, width=3, window=1, mode=mode)
    idx, val = wt.window_topk_plain(pts, pts, 1, last_ties=True, **kw)
    w_idx, w_val = port_knn.window_topk_wide(pts, pts, 1, last_ties=True, **kw)
    np.testing.assert_array_equal(idx.numpy(), w_idx.numpy())
    np.testing.assert_array_equal(val.numpy(), w_val.numpy())
    if mode == "ensure_self":
        return
    neg = wt.window_neg_d2(pts, pts, **kw)[0].numpy().reshape(1, 512, -1)
    last = neg.shape[-1] - 1 - np.argmax(neg[..., ::-1], -1)
    np.testing.assert_array_equal(idx.numpy()[..., 0], last)
    assert (wt.window_topk_plain(pts, pts, 1, **kw)[0] != idx).any()


def test_last_ties_is_the_top1_rule_only():
    pts = _grid(128)
    with pytest.raises(ValueError, match="top-1"):
        wt.window_topk(pts, pts, 2, tile=64, width=2, window=1, last_ties=True)


@pytest.mark.parametrize("tiles", range(1, 13))
def test_cbl_window_of_each_contrast_width_starts_where_the_search_did(tiles):
    """cbl_stage_loss takes window (width − 1) // 2 from the search's width:
    for every contrast_window, including widths clipped to the tile count,
    that window gives each query tile the search's start tile."""
    for window in range(0, 8):
        width = self_width(tiles, window)
        derived = (width - 1) // 2
        np.testing.assert_array_equal(wt.window_start_tiles(tiles, tiles, width, derived),
                                      wt.window_start_tiles(tiles, tiles, width, window))
