"""The pyramid options of ops/pyramid.py against the JAX package's
build_pyramid on the CPU: the windowed KNN (``knn_window``) on the natural
point transformer (fps, bucket_fps) and the ConvNet (voxel, radii), the
natural layout's tile contrast search (``contrast_mode='tile'``:
``contrast_idx``, ``contrast_local``, ``contrast_order``), the sorted
layout's contrast search on a window or tile of its own, and a
``knn_recall`` other than the presets'.

Coordinates sit on the 1/64 m grid (tests/torch_parity.py): every index
tensor must be equal, the IDW weights and relative positions within 1e-6.
Each spec is built, and compiled by JAX, once a process.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu_torch.ops import knn as port_knn
from contrastboundary_tpu_torch.ops import pyramid as port_pyramid
from torch_parity import synthetic_crops

PT = dict(strides=(1, 4, 4), k_self=(8, 16, 16), k_down=(8, 16, 16), k_contrast=(12, 8, 8),
          with_subscene=True)
CONV = dict(strides=(1, 4, 4), k_self=(16, 20, 24), k_down=(16, 16, 20), k_contrast=(12, 8, 8),
            with_subscene=True, sampler="voxel", radii=(0.1, 0.2, 0.4),
            down_radii=(0.1, 0.1, 0.2), voxel_sizes=(0.04, 0.08, 0.16))
# name: (points, spec fields of both packages, the port's layout)
SPECS = {
    "natural_window_fps": (1024, dict(PT, sampler="fps", knn_window=1, knn_tile=64), "natural"),
    "natural_window_bucket": (1024, dict(PT, sampler="bucket_fps", num_buckets=8, knn_window=2,
                                         knn_tile=64), "natural"),
    "conv_window": (1024, dict(CONV, knn_window=1, knn_tile=64), "natural"),
    "natural_tile_contrast": (1024, dict(PT, sampler="fps", contrast_mode="tile",
                                         contrast_tile=64, contrast_window=1), "natural"),
    # 1000 → 250 → 62 rows: levels 0 and 1 are no multiple of the contrast
    # tile (the global search), level 2 is one tile of 62; windowed where the
    # sizes allow (none here: no multiple of 64)
    "natural_tile_mixed": (1000, dict(PT, sampler="fps", contrast_mode="tile", contrast_tile=64,
                                      knn_window=1, knn_tile=64), "natural"),
    "natural_both_recall": (1024, dict(PT, sampler="bucket_fps", num_buckets=8, knn_window=1,
                                       knn_tile=64, contrast_mode="tile", contrast_tile=128,
                                       contrast_window=2, knn_recall=0.9), "natural"),
    "sorted_contrast_window": (2048, dict(PT, sampler="strided", contrast_window=2), "sorted"),
    # knn_window changes nothing on the sorted layout at multiples of the tile
    "sorted_contrast_tile": (2048, dict(PT, sampler="strided", contrast_tile=128, knn_window=3,
                                        knn_recall=0.9), "sorted"),
}
INDEX_FIELDS = ("sample_idx", "self_idx", "down_idx", "up_idx", "near0_idx", "contrast_idx",
                "subscene_idx", "contrast_order", "down_local", "up_local", "near0_local")
STATIC_FIELDS = ("contrast_local", "self_local", "down_meta", "up_meta", "near0_meta")


@pytest.fixture(scope="module")
def cloud():
    return synthetic_crops(2, 2048, seed=7)[0]


_BUILT = {}


def built(cloud, name):
    """(JAX pyramid, the port's) of a spec, built once a process."""
    if name not in _BUILT:
        n, kw, layout = SPECS[name]
        pts = np.ascontiguousarray(cloud[:, :n])
        ref = jax_pyramid.build_pyramid(jnp.asarray(pts),
                                        jax_pyramid.PyramidSpec(layout=layout, **kw))
        got = port_pyramid.build_pyramid(torch.from_numpy(pts),
                                         port_pyramid.PyramidSpec(layout=layout, **kw))
        _BUILT[name] = ref, got
    return _BUILT[name]


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pyramid_indices_equal_jax(cloud, name):
    ref, got = built(cloud, name)
    for field in INDEX_FIELDS:
        r, g = getattr(ref, field), getattr(got, field)
        assert len(r) == len(g), field
        for level, (a, b) in enumerate(zip(r, g)):
            if a is None:
                assert b is None, (field, level)
                continue
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{field}[{level}]")
    for field in STATIC_FIELDS:
        assert tuple(getattr(got, field)) == tuple(getattr(ref, field)), field
    np.testing.assert_array_equal(_np(got.order0), _np(ref.order0))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_pyramid_points_and_weights_match_jax(cloud, name):
    ref, got = built(cloud, name)
    for r, g in zip(ref.points, got.points):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for field in ("up_w", "self_rel", "down_rel"):
        for level, (r, g) in enumerate(zip(getattr(ref, field), getattr(got, field))):
            if r is None:
                assert g is None, (field, level)
                continue
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6,
                                       err_msg=f"{field}[{level}]")


def test_the_options_take_their_paths(cloud):
    """What each spec ran: the windowed natural searches (window-relative
    nowhere but in tile mode), the tile contrast levels (order set, local
    geometry), the separate sorted contrast geometry."""
    _, got = built(cloud, "natural_tile_mixed")
    assert got.contrast_order[:2] == (None, None) and got.contrast_local[:2] == (None, None)
    assert got.contrast_order[2].shape == (2, 62) and got.contrast_local[2] == (62, 1)
    _, got = built(cloud, "natural_both_recall")
    assert [c for c in got.contrast_local] == [(128, 5), (128, 2), (64, 1)]
    assert got.self_local == (None,) * 3 and got.order0 is None
    _, got = built(cloud, "sorted_contrast_window")
    assert got.self_local[0] == (256, 3) and got.contrast_local[0] == (256, 5)
    _, got = built(cloud, "sorted_contrast_tile")
    assert got.self_local[0] == (256, 3) and got.contrast_local[0] == (128, 3)
    assert all(o is None for o in got.contrast_order)


def test_windowed_natural_searches_run_the_window_search(cloud, monkeypatch):
    """With knn_window every natural search whose sizes are multiples of
    knn_tile goes through the window top-k (its plain version here); the
    contrast search of tile mode too."""
    calls = []
    top = port_knn.win_topk.window_topk

    def rec(*args, **kw):
        calls.append((args[2], kw["mode"], kw["last_ties"]))
        return top(*args, **kw)

    monkeypatch.setattr(port_knn.win_topk, "window_topk", rec)
    n, kw, layout = SPECS["natural_both_recall"]
    port_pyramid.build_pyramid(torch.from_numpy(np.ascontiguousarray(cloud[:, :n])),
                               port_pyramid.PyramidSpec(layout=layout, **kw))
    # 3 self + 2 down + 2 up + 2 near0 (ties to the last row) + 2 sub-scene
    # + 3 tile contrast
    assert len(calls) == 14, calls
    assert sorted(c for c in calls if c[0] == 1) == [(1, "plain", True)] * 2
    assert sum(mode == "exclude_self" for _, mode, _ in calls) == 3
    assert sum(mode == "ensure_self" for _, mode, _ in calls) == 3


@pytest.mark.parametrize("mode", ["cyclic", ""])
def test_unknown_contrast_mode_raises(mode):
    with pytest.raises(ValueError, match="contrast_mode"):
        port_pyramid.build_pyramid(torch.zeros(1, 256, 3),
                                   port_pyramid.PyramidSpec(contrast_mode=mode))
