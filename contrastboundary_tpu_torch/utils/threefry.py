"""JAX's threefry random stream, bit for bit, for the three places the port
draws from it: the ``random`` sampler's row permutation
(``jax.random.permutation(PRNGKey(level), n)``, a constant of the level,
computed on the host), flax's ``nn.Dropout`` mask under the trainer's
``fold_in(PRNGKey(17), step)`` and the CBL's ``rand<k>`` rows
(``jax.random.randint`` under ``fold_in(PRNGKey(13), step)``), both drawn
on the tensor's device.

The layout is the one JAX uses with ``jax_threefry_partitionable`` on (its
default): the bits of a shape are ``x0 ^ x1`` of threefry2x32(key, (hi(i),
lo(i))) over the flat row-major index i; ``split`` and ``fold_in`` hash
the counters (0, j) and (0, data). flax folds a module path into a key by
the first 4 bytes (big-endian) of the SHA-1 of the path's names and
counters, without a separator (``flax_fix_rng_separator`` off).

A key is a pair of Python ints (k0, k1). The 32-bit words are held in
int64 and masked to 32 bits after every add and shift, so one code serves
numpy arrays and torch tensors on any device (torch's uint32 support is
partial).
"""
from __future__ import annotations

import hashlib
import math
from typing import Tuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words x0, x1 (int64 arrays
    or tensors holding uint32 values, or ints) under ``key`` → (y0, y1) of
    the same kind."""
    k0, k1 = int(key[0]) & MASK, int(key[1]) & MASK
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed ≥ 0."""
    return (0, int(seed) & MASK)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    y0, y1 = threefry2x32(key, 0, int(data) & MASK)
    return (y0, y1)


def split(key: Key, num: int = 2) -> list:
    """``jax.random.split(key, num)`` as a list of keys."""
    return [fold_in(key, j) for j in range(num)]


def flax_fold(key: Key, *suffix) -> Key:
    """The key flax's LazyRng derives from ``key`` for the path ``suffix``
    (module names as str, rng counters as int): fold_in by the first 4
    bytes, big-endian, of the SHA-1 of the suffix's bytes."""
    m = hashlib.sha1()
    for x in suffix:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise TypeError(f"a flax rng suffix is a str or an int, not {type(x).__name__}")
    return fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def random_bits32(key: Key, shape, device=None, rows=None):
    """``jax.random.bits(key, shape, uint32)``: on the host (``device``
    None) an int64 numpy array, else an int64 tensor on ``device``; the
    values are the uint32 bits. ``rows`` = (r0, r1) computes only those
    rows of the leading axis (each element's bits depend on its flat index
    alone)."""
    shape = tuple(shape)
    r0, r1 = rows if rows is not None else (0, shape[0] if shape else 1)
    per = math.prod(shape[1:])
    lo, n = r0 * per, (r1 - r0) * per
    if device is None:
        i = np.arange(lo, lo + n, dtype=np.int64)
    else:
        i = torch.arange(lo, lo + n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, i >> 32, i & MASK)
    return (y0 ^ y1).reshape(((r1 - r0),) + shape[1:] if shape else ())


def randint(key: Key, shape, minval: int, maxval: int, device=None, rows=None):
    """``jax.random.randint(key, shape, minval, maxval, int32)`` as int64:
    two 32-bit draws from ``split(key)``, then minval + ((hi mod span) ·
    (2³² mod span) + lo mod span) mod span, every product and sum modulo
    2³² as the uint32 arithmetic is (span = maxval − minval, 1 where
    maxval <= minval). ``rows`` as for ``random_bits32``."""
    k1, k2 = split(key)
    hi = random_bits32(k1, shape, device, rows)
    lo = random_bits32(k2, shape, device, rows)
    span = maxval - minval if maxval > minval else 1
    mult = (1 << 16) % span
    mult = (mult * mult & MASK) % span
    offset = ((hi % span) * mult & MASK) + lo % span
    return minval + (offset & MASK) % span


def uniform(key: Key, shape, device=None):
    """``jax.random.uniform(key, shape)`` in [0, 1), float32: the top 23
    bits as the mantissa of a float in [1, 2), less 1."""
    bits = (random_bits32(key, shape, device) >> 9) | 0x3F800000
    if device is None:
        return bits.astype(np.uint32).view(np.float32) - np.float32(1.0)
    return bits.to(torch.int32).view(torch.float32) - 1.0


def bernoulli(key: Key, p: float, shape, device=None):
    """``jax.random.bernoulli(key, p, shape)``: uniform < float32(p)."""
    u = uniform(key, shape, device)
    if device is None:
        return u < np.float32(p)
    return u < torch.tensor(np.float32(p), device=device)


def permutation(key: Key, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)`` → int64 [n]: ceil(3·ln n /
    ln(2³² − 1)) rounds, each a stable sort of the running permutation by
    the 32-bit draws of a fresh split of the key."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits32(sub, (n,)), kind="stable")]
    return x
