"""The port's threefry stream (contrastboundary_tpu_torch/utils/threefry.py)
bit for bit against JAX and flax on the CPU: keys, bits, uniforms,
permutations, the random sampler's picks and flax's nn.Dropout mask under
the JAX trainer's dropout key. No tolerance: every bit equal.

test_rng_assumptions pins the two flags the port's copy depends on and a
few literal values of the streams, so that a change in JAX's or flax's
stream fails there, by name, and not in the parity tests."""
import flax
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contrastboundary_tpu.ops import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu_torch.models.blocks import Dropout, dropout_mask
from contrastboundary_tpu_torch.ops import sampling
from contrastboundary_tpu_torch.train.trainer import dropout_key
from contrastboundary_tpu_torch.utils import threefry as tf

PERM_1_65536 = [54649, 19919, 46617, 57471, 24406, 47859, 50862, 18908]
PERM_2_1000 = [135, 543, 783, 164, 965, 319, 792, 83]
DROP_KEY_STEP0 = (2163312911, 4158060239)  # flax_fold(fold_in(PRNGKey(17), 0), "cls_drop", 1)
DROP_BITS_STEP0 = [2727062540, 631312348, 2014217277, 3220890685, 659151942, 136063876]
DROP_KEEP_HALF = [0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1]


def _key(k):
    return tuple(int(v) for v in np.asarray(jax.random.key_data(k)
                                            if hasattr(jax.random, "key_data") else k))


def test_rng_assumptions():
    assert jax.config.jax_threefry_partitionable is True
    assert flax.config.flax_fix_rng_separator is False
    for ours in (tf.permutation(tf.prng_key(1), 65536), jax.random.permutation(
            jax.random.PRNGKey(1), 65536)):
        assert np.asarray(ours)[:8].tolist() == PERM_1_65536
    assert tf.permutation(tf.prng_key(2), 1000)[:8].tolist() == PERM_2_1000
    assert np.asarray(jax.random.permutation(jax.random.PRNGKey(2), 1000))[:8].tolist() == \
        PERM_2_1000
    key = tf.flax_fold(tf.fold_in(tf.prng_key(17), 0), "cls_drop", 1)
    assert key == DROP_KEY_STEP0
    assert tf.random_bits32(key, (6,)).tolist() == DROP_BITS_STEP0
    jbits = jax.random.bits(jnp.asarray(DROP_KEY_STEP0, jnp.uint32), (6,), jnp.uint32)
    assert np.asarray(jbits).tolist() == DROP_BITS_STEP0
    assert tf.bernoulli(key, 0.5, (16,)).astype(int).tolist() == DROP_KEEP_HALF


@pytest.mark.parametrize("seed,data", [(0, 0), (17, 5), (3, 2**31 + 7)])
def test_keys_split_fold_in_and_bits_equal_jax(seed, data):
    k = jax.random.PRNGKey(seed)
    assert tf.prng_key(seed) == _key(k)
    assert tf.fold_in(tf.prng_key(seed), data) == _key(jax.random.fold_in(k, data))
    assert tf.split(tf.prng_key(seed), 3) == [_key(s) for s in jax.random.split(k, 3)]
    ours = tf.fold_in(tf.prng_key(seed), data)
    jk = jax.random.fold_in(k, data)
    shape = (3, 5, 7)
    np.testing.assert_array_equal(tf.random_bits32(ours, shape),
                                  np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    u = np.asarray(jax.random.uniform(jk, shape))
    np.testing.assert_array_equal(tf.uniform(ours, shape), u)
    np.testing.assert_array_equal(tf.uniform(ours, shape, device="cpu").numpy(), u)
    np.testing.assert_array_equal(tf.bernoulli(ours, 0.3, shape),
                                  np.asarray(jax.random.bernoulli(jk, 0.3, shape)))


@pytest.mark.parametrize("level,n", [(1, 65536), (2, 16384), (3, 4096), (1, 1000), (4, 12345),
                                     (0, 1)])
def test_permutation_equals_jax(level, n):
    ref = np.asarray(jax.random.permutation(jax.random.PRNGKey(level), n))
    np.testing.assert_array_equal(tf.permutation(tf.prng_key(level), n), ref)


def test_random_sample_is_the_reference_pyramid_pick():
    """ops/sampling.py::random_sample against the JAX pyramid's
    ``_sample(sampler='random')`` at each level of a 4096-point cloud,
    broadcast over the batch, the same tensor on a second call."""
    pts = np.random.default_rng(0).random((2, 4096, 3)).astype(np.float32)
    spec = JaxSpec(sampler="random")
    n = 4096
    for level in range(1, 5):
        m = n // 4
        ref = np.asarray(jax_pyramid._sample(jnp.asarray(pts[:, :n]), m, spec, level))
        got = sampling.random_sample(torch.as_tensor(pts[:, :n]), m, level)
        assert got.dtype == torch.int32 and got.shape == (2, m)
        np.testing.assert_array_equal(got.numpy(), ref)
        again = sampling.random_sample(torch.as_tensor(pts[:, :n]), m, level)
        assert again.data_ptr() == got.data_ptr()  # computed once, cached
        n = m


class _Drop(nn.Module):
    rate: float

    @nn.compact
    def __call__(self, x, train):
        y = nn.Dense(6, name="d")(x)
        return nn.Dropout(self.rate, deterministic=not train, name="cls_drop")(y)


@pytest.mark.parametrize("rate", [0.5, 0.3])
@pytest.mark.parametrize("step", [0, 7])
def test_dropout_equals_flax_under_the_trainer_key(rate, step):
    """flax's nn.Dropout named 'cls_drop', a direct child of the top module,
    applied with rngs={'dropout': fold_in(PRNGKey(17), step)} as the JAX
    trainer passes them, against the port's Dropout with the train step's
    key: the same output bits (mask and the 1/(1 − rate) scale), the
    identity in eval mode."""
    x = np.random.default_rng(step).standard_normal((2, 64, 3)).astype(np.float32)
    m = _Drop(rate)
    v = m.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    y_eval = np.asarray(m.apply(v, jnp.asarray(x), False))
    ref = np.asarray(m.apply(v, jnp.asarray(x), True, rngs={
        "dropout": jax.random.fold_in(jax.random.PRNGKey(17), step)}))
    assert dropout_key(step) == _key(jax.random.fold_in(jax.random.PRNGKey(17), step))
    drop = Dropout(rate, "cls_drop").train()
    got = drop(torch.from_numpy(y_eval.copy()), dropout_key(step)).numpy()
    np.testing.assert_array_equal(got, ref)
    keep = dropout_mask(dropout_key(step), "cls_drop", rate, y_eval.shape, "cpu")
    np.testing.assert_array_equal(keep.numpy(), ref != 0)
    assert 0 < keep.float().mean() < 1
    np.testing.assert_array_equal(drop.eval()(torch.from_numpy(y_eval.copy()), None).numpy(),
                                  y_eval)
