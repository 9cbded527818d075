"""The port's samplers (ops/sampling.py: exact fps, bucket_fps,
serialized_sample; ops/pyramid.py::_sample's bucket halving) against the
JAX package's on the CPU, and the FPS chain's plain version
(ops/cuda/fps.py::fps_chains_plain, the CPU path and the card kernel's
reference) against a float32 numpy loop of the same arithmetic.

The JAX comparisons use clouds on the 1/64 m grid (tests/torch_parity.py),
where every squared distance is exact in float32, so the FPS chains see the
same mind2 whatever order XLA sums in; there, and on clouds with
duplicated rows and more picks than distinct points, every index must be
equal. Off the grid the plain chain must equal the numpy loop, which
rounds each product and sum on its own in the order (dx·dx + dy·dy) +
dz·dz, as the CUDA kernel does: every index equal.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu.ops import sampling as jax_sampling
from contrastboundary_tpu_torch.ops import pyramid as port_pyramid
from contrastboundary_tpu_torch.ops import sampling
from contrastboundary_tpu_torch.ops.cuda import fps as fps_cuda
from torch_parity import synthetic_crops


@pytest.fixture(scope="module")
def crops():
    return synthetic_crops(2, 2048, seed=4)[0]


def _dup_cloud(b, distinct, n, seed):
    """n rows drawn from ``distinct`` grid points: duplicated rows, and
    fewer distinct points than a long chain picks."""
    rng = np.random.default_rng(seed)
    base = np.round(rng.uniform(0, 2, (b, distinct, 3)) * 64) / 64
    return np.ascontiguousarray(base[:, rng.integers(0, distinct, n)]).astype(np.float32)


@pytest.mark.parametrize("n,m", [(2048, 512), (2048, 2047), (1000, 37)])
def test_fps_matches_jax(crops, n, m):
    pts = np.ascontiguousarray(crops[:, :n])
    ref = np.asarray(jax_sampling.fps(jnp.asarray(pts), m))
    got = sampling.fps(torch.from_numpy(pts), m)
    assert got.dtype == torch.int32 and got.shape == (2, m)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("m", [200, 400])
def test_fps_with_duplicates_and_more_picks_than_points(m):
    """50 distinct points in 300 rows: once all are picked every mind2 is
    0 and the chain picks row 0 (m = 400 also exceeds the rows)."""
    pts = _dup_cloud(2, 50, 300, seed=1)
    ref = np.asarray(jax_sampling.fps(jnp.asarray(pts), m))
    got = sampling.fps(torch.from_numpy(pts), m).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[:, -20:] == 0).all()


@pytest.mark.parametrize("n,m,g", [(2048, 512, 64), (2048, 256, 16), (1024, 1024, 8),
                                   (2048, 64, 64)])
def test_bucket_fps_matches_jax(crops, n, m, g):
    pts = np.ascontiguousarray(crops[:, :n])
    ref = np.asarray(jax_sampling.bucket_fps(jnp.asarray(pts), m, g))
    got = sampling.bucket_fps(torch.from_numpy(pts), m, g)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_bucket_fps_with_duplicates_matches_jax():
    pts = _dup_cloud(2, 40, 1024, seed=2)
    ref = np.asarray(jax_sampling.bucket_fps(jnp.asarray(pts), 512, 8))
    np.testing.assert_array_equal(sampling.bucket_fps(torch.from_numpy(pts), 512, 8).numpy(), ref)


def test_bucket_fps_needs_divisible_sizes(crops):
    with pytest.raises(ValueError, match="divisible"):
        sampling.bucket_fps(torch.from_numpy(crops), 100, 64)


@pytest.mark.parametrize("n,m", [(2048, 512), (1536, 96), (640, 160), (96, 24), (7, 3),
                                 (1000, 250)])
def test_sample_halves_buckets_as_jax(crops, n, m):
    """The pyramid's bucket_fps dispatch: 64 buckets halved while they do
    not divide N and m (1536/96 → 32, 96/24 → 8, 1000/250 → 2), exact fps
    once they reach one (7/3)."""
    pts = np.ascontiguousarray(crops[:, :n])
    ref = np.asarray(jax_pyramid._sample(jnp.asarray(pts), m, jax_pyramid.PyramidSpec(), 1))
    got = port_pyramid._sample(torch.from_numpy(pts), m,
                               port_pyramid.PyramidSpec(sampler="bucket_fps"), 1)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n,m", [(2048, 512), (2048, 2048), (1000, 333), (300, 1)])
def test_serialized_sample_matches_jax(crops, n, m):
    pts = np.ascontiguousarray(crops[:, :n])
    ref = np.asarray(jax_sampling.serialized_sample(jnp.asarray(pts), m))
    got = sampling.serialized_sample(torch.from_numpy(pts), m)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _numpy_chains(grouped, m_per):
    """The chain in float32 numpy, one rounding an operation."""
    p, per, _ = grouped.shape
    out = np.zeros((p, m_per), np.int64)
    for i in range(p):
        x, y, z = (grouped[i, :, j] for j in range(3))
        mind2 = np.full(per, np.inf, np.float32)
        last = 0
        for s in range(1, m_per):
            dx, dy, dz = x - x[last], y - y[last], z - z[last]
            d2 = (dx * dx + dy * dy) + dz * dz
            mind2 = np.minimum(mind2, d2)
            last = int(np.argmax(mind2))
            out[i, s] = last
    return out


@pytest.mark.parametrize("per,m_per", [(1000, 120), (33, 33), (5, 9)])
def test_plain_chain_rounds_each_op_as_the_kernel(per, m_per):
    rng = np.random.default_rng(per)
    grouped = (rng.standard_normal((3, per, 3)) * 3.7).astype(np.float32)
    got = fps_cuda.fps_chains_plain(torch.from_numpy(grouped), m_per)
    assert got.dtype == torch.int32 and got.shape == (3, m_per)
    np.testing.assert_array_equal(got.numpy(), _numpy_chains(grouped, m_per))


def test_chain_wrapper_takes_the_plain_version_on_the_cpu_only():
    grouped = torch.from_numpy(_dup_cloud(4, 30, 64, seed=3))
    before = fps_cuda.launches
    np.testing.assert_array_equal(fps_cuda.fps_chains(grouped, 10).numpy(),
                                  fps_cuda.fps_chains_plain(grouped, 10).numpy())
    assert fps_cuda.launches == before  # the plain version is not a launch
    for bad, m in ((grouped[..., :2], 3), (grouped.double(), 3), (grouped, -1)):
        with pytest.raises(ValueError):
            fps_cuda.fps_chains(bad, m)


def test_stage_limit_is_the_kernels():
    """The wrapper's scratch rule uses csrc/fps.cu's kStageMaxRows, and the
    staged set (16 bytes a row) fits the H100's 227 KB of shared memory."""
    src = (Path(fps_cuda.__file__).parents[2] / "csrc" / "fps.cu").read_text()
    rows = int(re.search(r"kStageMaxRows = (\d+);", src).group(1))
    assert rows == fps_cuda.STAGE_MAX_ROWS and rows * 16 + 1024 <= 232448
