"""Port of the fused CBL stage-loss kernels (ops/cuda/cbl_tile2.py, v2, and
ops/cuda/cbl_tile.py, v1) against the JAX Pallas kernels in interpret mode
on the CPU, where the port's wrappers run their plain versions.

Cases of tests/test_cbl_pallas2.py and tests/test_cbl_pallas.py (B = 2 here,
so that the cotangent differs between clouds): one-hot labels with
ignored (zero) rows, soft labels with zero rows at T = 0.5, K = 12 and 20
(two and three of the reference's 8-slot chunks) and rows whose every slot
is a shadow. Tolerances are the reference tests' own: the scalar stage
loss rtol 1e-5 and its feature gradient atol 1e-6. Besides, the per-row
statistics against the Pallas accumulator (counts exact, the rest rtol
1e-5) and the VJP of the loss sums under a random cotangent within 1e-6 of
its scale: both sides gather rows exactly (one-hot matmuls at HIGHEST on
the TPU side) and differ only in the order of the channel sums, about one
ulp of a distance. v1 and v2 compute the same function: their plain
versions agree to the same tolerances.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.ops.pallas.cbl_tile import cbl_tile_softnn as jax_v1
from contrastboundary_tpu.ops.pallas.cbl_tile2 import _row_meta as jax_row_meta
from contrastboundary_tpu.ops.pallas.cbl_tile2 import _stats_call as jax_stats_call
from contrastboundary_tpu.ops.pallas.cbl_tile2 import cbl_tile_softnn2 as jax_v2
from contrastboundary_tpu_torch.ops.cuda import cbl_tile, cbl_tile2
from contrastboundary_tpu_torch.ops.cuda.cbl_dense import row_meta

B, M, NCLS, C = 2, 256, 3, 8
TILE, WINDOW = 64, 1
WIDTH = 2 * WINDOW + 1
W = WIDTH * TILE
WEIGHT = 0.1

# (K, soft labels, temperature, seed, every slot a shadow)
CASES = {
    "onehot": (4, False, 1.0, 0, False),
    "soft_t0.5": (4, True, 0.5, 3, False),
    "k12_two_chunks": (12, False, 1.0, 1, False),
    "k20_three_chunks_soft": (20, True, 1.0, 2, False),
    "all_shadow": (4, False, 1.0, 5, True),
}


def _data(k, soft, seed, all_shadow):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, M, C).astype(np.float32)
    if soft:
        ls = rng.rand(B, M, NCLS).astype(np.float32)
        ls /= ls.sum(-1, keepdims=True)
        ls[rng.rand(B, M) < 0.1] = 0.0
    else:
        lab = rng.randint(-1, NCLS, (B, M))
        ls = np.eye(NCLS, dtype=np.float32)[np.maximum(lab, 0)] * (lab >= 0)[..., None]
    li = rng.randint(0, W + 1, (B, M, k)).astype(np.int32)
    if all_shadow:
        li[:] = W
    else:
        li[:, ::17] = W  # some rows with no valid slot
    return feats, ls, li, rng.randn(B).astype(np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def _mean_loss(loss_sum, mask_sum):
    """The caller's masked mean × weight (losses/contrast.py:422-424)."""
    return loss_sum.sum() / torch.clamp_min(mask_sum.sum(), 1.0) * WEIGHT


def _jax_mean_loss(out):
    return jnp.sum(out[0]) / jnp.maximum(jnp.sum(out[1]), 1.0) * WEIGHT


def _v1_fused(feats, ls):
    return np.concatenate([ls, feats], -1)


@pytest.mark.parametrize("case", list(CASES))
def test_v2_plain_matches_pallas_interpret(case):
    k, soft, temp, seed, shadow = CASES[case]
    feats, ls, li, g = _data(k, soft, seed, shadow)
    args = (jnp.asarray(ls), jnp.asarray(li), temp, TILE, WIDTH, WINDOW, True)
    (ref_l, ref_m), vjp = jax.vjp(lambda f: jax_v2(f, *args), jnp.asarray(feats))
    dref = np.asarray(vjp((jnp.asarray(g), jnp.zeros(B)))[0])
    # the masked mean's gradient through the same VJP (mask_sum has none)
    ref_loss = _jax_mean_loss((ref_l, ref_m))
    g_mean = jnp.full(B, WEIGHT) / jnp.maximum(jnp.sum(ref_m), 1.0)
    dref_loss = np.asarray(vjp((g_mean, jnp.zeros(B)))[0])

    ft = _t(feats).requires_grad_()
    got_l, got_m = cbl_tile2.cbl_tile_softnn2(ft, _t(ls), _t(li), temp, TILE, WIDTH, WINDOW)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(ref_l), rtol=1e-5)
    got_l.backward(_t(g))
    np.testing.assert_allclose(ft.grad.numpy(), dref, rtol=0, atol=1e-6 * max(np.abs(dref).max(), 1.0))

    ft = _t(feats).requires_grad_()
    loss = _mean_loss(*cbl_tile2.cbl_tile_softnn2(ft, _t(ls), _t(li), temp, TILE, WIDTH, WINDOW))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(dref_loss), rtol=0, atol=1e-6)
    if shadow:  # no masked row: a finite 0 and a zero gradient
        assert float(loss.detach()) == 0.0 and not ft.grad.any()


@pytest.mark.parametrize("case", ["onehot", "k20_three_chunks_soft"])
def test_v2_plain_stats_match_the_pallas_accumulator(case):
    k, soft, temp, seed, shadow = CASES[case]
    feats, ls, li, _ = _data(k, soft, seed, shadow)
    meta = jax_row_meta(jnp.asarray(ls))
    np.testing.assert_array_equal(row_meta(_t(ls)).numpy(), np.asarray(meta))
    ref = np.asarray(jax_stats_call(jnp.asarray(feats), meta, jnp.asarray(li), temp, TILE, WIDTH,
                                    WINDOW, True, emit_loss=False))
    got = cbl_tile2.cbl_tile2_fwd_plain(_t(feats), _t(meta), _t(li), temp, TILE, WIDTH,
                                        WINDOW).numpy()
    np.testing.assert_array_equal(got[..., 3:5], ref[..., 3:5])
    np.testing.assert_allclose(got[..., :3], ref[..., :3], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["onehot", "soft_t0.5", "k12_two_chunks"])
def test_v1_plain_matches_pallas_interpret_and_v2(case):
    k, soft, temp, seed, shadow = CASES[case]
    feats, ls, li, g = _data(k, soft, seed, shadow)
    fused = _v1_fused(feats, ls)
    args = (jnp.asarray(li), NCLS, temp, TILE, WIDTH, WINDOW, True)
    (ref_l, ref_m), vjp = jax.vjp(lambda f: jax_v1(f, *args), jnp.asarray(fused))
    dref = np.asarray(vjp((jnp.asarray(g), jnp.zeros(B)))[0])

    fu = _t(fused).requires_grad_()
    got_l, got_m = cbl_tile.cbl_tile_softnn(fu, _t(li), NCLS, temp, TILE, WIDTH, WINDOW)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(ref_l), rtol=1e-5)
    got_l.backward(_t(g))
    assert not fu.grad[..., :NCLS].any()  # the label columns get no gradient
    np.testing.assert_allclose(fu.grad.numpy(), dref, rtol=0, atol=1e-6 * max(np.abs(dref).max(), 1.0))

    # the same function as v2 on the same inputs
    ft = _t(feats).requires_grad_()
    v2_l, v2_m = cbl_tile2.cbl_tile_softnn2(ft, _t(ls), _t(li), temp, TILE, WIDTH, WINDOW)
    v2_l.backward(_t(g))
    np.testing.assert_array_equal(v2_m.numpy(), got_m.numpy())
    np.testing.assert_allclose(v2_l.detach().numpy(), got_l.detach().numpy(), rtol=1e-5)
    np.testing.assert_allclose(ft.grad.numpy(), fu.grad.numpy()[..., NCLS:], rtol=0,
                               atol=1e-6 * max(np.abs(dref).max(), 1.0))


def test_cbl_tile_wrappers_take_the_plain_version_only_on_cpu():
    feats, ls, li, g = _data(4, False, 0, False)
    counts = lambda: (cbl_tile2.fwd_launches, cbl_tile2.bwd_launches, cbl_tile.fwd_launches,
                      cbl_tile.bwd_launches)
    before = counts()
    meta = row_meta(_t(ls))
    stats = cbl_tile2.cbl_tile2_fwd(_t(feats), meta, _t(li), 1.0, TILE, WIDTH, WINDOW)
    cbl_tile2.cbl_tile2_bwd(_t(feats), meta, _t(li), stats, _t(g), 1.0, TILE, WIDTH, WINDOW)
    fused = _t(_v1_fused(feats, ls))
    stats1 = cbl_tile.cbl_tile_fwd(fused, _t(li), NCLS, 1.0, TILE, WIDTH, WINDOW)
    cbl_tile.cbl_tile_bwd(fused, _t(li), stats1, _t(g), NCLS, 1.0, TILE, WIDTH, WINDOW)
    assert counts() == before  # plain: no launch
    with pytest.raises(TypeError, match="float32"):  # float32 only, as on the card
        cbl_tile2.cbl_tile2_fwd(_t(feats).double(), meta, _t(li), 1.0, TILE, WIDTH, WINDOW)
    on_meta = torch.empty(B, M, C, device="meta")
    with pytest.raises(ValueError):
        cbl_tile2.cbl_tile2_fwd(on_meta, meta, _t(li), 1.0, TILE, WIDTH, WINDOW)
    with pytest.raises(ValueError):
        cbl_tile.cbl_tile_fwd(torch.empty(B, M, NCLS + C, device="meta"), _t(li), NCLS, 1.0,
                              TILE, WIDTH, WINDOW)
