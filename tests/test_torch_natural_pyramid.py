"""The natural-layout pyramid of the port (ops/voxel.py, ops/sampling.py::
voxel_sample, ops/knn.py::knn, ops/pyramid.py with layout='natural')
against the JAX package's on the CPU.

Coordinates sit on the 1/64 m grid (tests/torch_parity.py), so every
squared distance is exact in float32 in both packages and ties are real:
the searches must break them alike. Tolerances: every index equal; d2 and
the IDW weights within 1e-6; the voxel barycenters and mean features
within 1e-6 (segment sums in another order); majority labels equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu.ops.knn import knn as jax_knn
from contrastboundary_tpu.ops.sampling import voxel_sample as jax_voxel_sample
from contrastboundary_tpu.ops.voxel import voxel_grid_subsample as jax_grid_subsample
from contrastboundary_tpu.ops.voxel import voxelize_indices as jax_voxelize
from contrastboundary_tpu_torch.ops import pyramid as port_pyramid
from contrastboundary_tpu_torch.ops.knn import knn
from contrastboundary_tpu_torch.ops.sampling import voxel_sample
from contrastboundary_tpu_torch.ops.voxel import voxel_grid_subsample, voxelize_indices
from torch_parity import synthetic_crops

NATURAL = dict(strides=(1, 4, 4), k_self=(16, 20, 24), k_down=(16, 16, 20),
               sampler="voxel", radii=(0.1, 0.2, 0.4), down_radii=(0.1, 0.1, 0.2),
               voxel_sizes=(0.04, 0.08, 0.16))


@pytest.fixture(scope="module")
def crops():
    return synthetic_crops(2, 1024, seed=3)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("voxel_size", [0.04, 0.06, 0.16])
def test_voxelize_indices_match_jax(crops, voxel_size):
    pts = crops[0]
    np.testing.assert_array_equal(voxelize_indices(torch.from_numpy(pts), voxel_size).numpy(),
                                  np.asarray(jax_voxelize(jnp.asarray(pts), voxel_size)))


def test_voxel_hash_wraps_as_int32():
    """A cloud spanning the whole 2048-cell grid: the hash overflows int32
    and wraps as the reference's int32 arithmetic does."""
    rng = np.random.default_rng(0)
    pts = (np.round(rng.uniform(0, 100, (1, 4096, 3)) * 64) / 64).astype(np.float32)
    ref = np.asarray(jax_voxelize(jnp.asarray(pts), 0.04))
    assert ref.min() < 0  # wrapped
    np.testing.assert_array_equal(voxelize_indices(torch.from_numpy(pts), 0.04).numpy(), ref)


@pytest.mark.parametrize("max_voxels", [64, 700])
def test_voxel_grid_subsample_matches_jax(crops, max_voxels):
    pts, feats, labels = crops
    labels = labels.copy()
    labels[:, ::7] = -1
    ref = jax_grid_subsample(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(labels),
                             voxel_size=0.08, max_voxels=max_voxels, num_classes=13)
    out = voxel_grid_subsample(torch.from_numpy(pts), torch.from_numpy(feats),
                               torch.from_numpy(labels), voxel_size=0.08,
                               max_voxels=max_voxels, num_classes=13)
    np.testing.assert_array_equal(_np(out[3]), _np(ref[3]))
    for o, r in zip(out[:2], ref[:2]):
        np.testing.assert_allclose(_np(o), _np(r), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(out[2]), _np(ref[2]))
    pts_only = voxel_grid_subsample(torch.from_numpy(pts), voxel_size=0.08, max_voxels=max_voxels)
    assert pts_only[1] is None and pts_only[2] is None
    np.testing.assert_array_equal(pts_only[0].numpy(), out[0].numpy())


@pytest.mark.parametrize("m,voxel_size", [(256, 0.08), (64, 0.16), (1000, 0.16)])
def test_voxel_sample_matches_jax(crops, m, voxel_size):
    """Thinned (more voxels than m) and padded (fewer, rows repeat)."""
    pts = crops[0]
    ref = np.asarray(jax_voxel_sample(jnp.asarray(pts), m, voxel_size))
    got = voxel_sample(torch.from_numpy(pts), m, voxel_size)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


KNN_CASES = {
    "plain": dict(k=16),
    "exclude_self": dict(k=11, exclude_self=True),
    "ensure_self_radius": dict(k=26, ensure_self=True, radius=0.1),
    "radius": dict(k=20, radius=0.2),
    "k_over_n": dict(k=80, exclude_self=True, n=64),
    "support_mask": dict(k=9, mask=True),
    "cross": dict(k=3, cross=True),
    "cross_radius": dict(k=16, cross=True, radius=0.1),
    "top1_recall": dict(k=1, cross=True, recall=0.95),
    "top1_exact": dict(k=1, cross=True),
    "recall_k4": dict(k=4, cross=True, recall=0.95),
    "small_chunk": dict(k=8, chunk=100),
}


@pytest.mark.parametrize("case", sorted(KNN_CASES))
def test_knn_matches_jax(crops, case):
    kw = dict(KNN_CASES[case])
    k, n = kw.pop("k"), kw.pop("n", 1024)
    pts = crops[0][:, :n]
    query = pts
    if kw.pop("cross", False):
        query = np.ascontiguousarray(crops[0][:, ::3])
    mask = None
    if kw.pop("mask", False):
        mask = np.random.default_rng(1).random(pts.shape[:2]) > 0.3
    ref_i, ref_d = jax_knn(jnp.asarray(query), jnp.asarray(pts), k,
                           support_mask=None if mask is None else jnp.asarray(mask), **kw)
    idx, d2 = knn(torch.from_numpy(query), torch.from_numpy(pts), k,
                  support_mask=None if mask is None else torch.from_numpy(mask), **kw)
    assert idx.dtype == torch.int32 and idx.shape == (2, query.shape[1], k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
    ref_d = np.asarray(ref_d)
    np.testing.assert_array_equal(np.isinf(d2.numpy()), np.isinf(ref_d))
    fin = np.isfinite(ref_d)
    np.testing.assert_allclose(d2.numpy()[fin], ref_d[fin], rtol=0, atol=1e-6)


def test_top1_ties_break_as_the_reference_on_the_cpu(crops):
    """With a recall target the reference's top-1 (lax.approx_max_k on the
    CPU) takes the last of tied columns, its exact top-1 the first; the
    grid crops have such ties."""
    pts = torch.from_numpy(crops[0])
    q = pts[:, ::3].contiguous()
    last = knn(q, pts[:, ::4].contiguous(), 1, recall=0.95)[0]
    first = knn(q, pts[:, ::4].contiguous(), 1)[0]
    assert (last != first).any()


@pytest.fixture(scope="module")
def pyramids(crops):
    pts = crops[0]
    kw = dict(NATURAL, k_contrast=(12, 8, 8), with_subscene=True)
    ref = jax_pyramid.build_pyramid(jnp.asarray(pts), jax_pyramid.PyramidSpec(**kw))
    got = port_pyramid.build_pyramid(torch.from_numpy(pts),
                                     port_pyramid.PyramidSpec(layout="natural", **kw))
    return ref, got


@pytest.mark.parametrize("field", ["sample_idx", "self_idx", "down_idx", "up_idx",
                                   "near0_idx", "contrast_idx", "subscene_idx"])
def test_natural_pyramid_indices_equal_jax(pyramids, field):
    ref, got = pyramids
    for level, (r, g) in enumerate(zip(getattr(ref, field), getattr(got, field))):
        if r is None:
            assert g is None, (field, level)
            continue
        assert g.dtype == torch.int32, (field, level)
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=f"{field}[{level}]")


def test_natural_pyramid_points_and_weights_match_jax(pyramids):
    ref, got = pyramids
    assert got.order0 is None and got.contrast_local == (None,) * 3
    assert got.self_local == got.near0_meta == (None,) * 3
    for r, g in zip(ref.points, got.points):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for r, g in zip(ref.up_w[1:], got.up_w[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    # the radius shadows are there: slot 0 is the point itself, some slots N
    assert (got.self_idx[0][..., 0] == torch.arange(1024, dtype=torch.int32)).all()
    assert (got.self_idx[0] == 1024).any() and (got.down_idx[1] == 1024).any()


def test_eval_pyramid_skips_contrast_and_subscene(crops):
    pyr = port_pyramid.build_pyramid(torch.from_numpy(crops[0]),
                                     port_pyramid.PyramidSpec(layout="natural", **NATURAL))
    assert pyr.contrast_idx == (None,) * 3 and pyr.subscene_idx == (None,) * 3


@pytest.mark.parametrize("kw,msg", [
    (dict(layout="natural", sampler="uniform"), "ported samplers"),
    (dict(layout="sorted", sampler="uniform"), "ported samplers"),
    (dict(layout="natural", sampler="voxel"), "voxel_sizes"),
    (dict(radii=(0.1,) * 5), "radius"),
])
def test_unported_pyramid_specs_raise(kw, msg):
    with pytest.raises(ValueError, match=msg):
        port_pyramid.build_pyramid(torch.zeros(1, 1024, 3), port_pyramid.PyramidSpec(**kw))
