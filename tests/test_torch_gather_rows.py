"""Port of the row gather (ops/cuda/gather_dma.py) against the JAX Pallas
kernel ops/pallas/gather_dma.py::gather_rows_dma in interpret mode on the
CPU: exact (a copy), and the reference's two shape errors in its words."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from contrastboundary_tpu.ops.pallas import gather_rows_dma
from contrastboundary_tpu_torch.ops.cuda import gather_dma


@pytest.mark.parametrize("n, c, m, dtype", [
    (64, 128, 2048, np.float32),
    (300, 256, 1024, np.float32),
    (50, 128, 1024, np.int32),
])
def test_gather_rows_plain_matches_pallas_interpret(n, c, m, dtype):
    rng = np.random.RandomState(n)
    x = (rng.randn(n, c) * 100).astype(dtype)
    idx = rng.randint(0, n, (m,)).astype(np.int32)
    ref = np.asarray(gather_rows_dma(jnp.asarray(x), jnp.asarray(idx), interpret=True))
    before = gather_dma.launches
    got = gather_dma.gather_rows(torch.as_tensor(x), torch.as_tensor(idx))
    assert gather_dma.launches == before  # the plain version on the CPU
    assert got.dtype == torch.as_tensor(x).dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_gather_rows_raises_the_reference_errors():
    idx = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="C=64 must be a multiple of 128"):
        gather_dma.gather_rows(torch.zeros(8, 64), idx)
    with pytest.raises(ValueError, match="M=1000 must be a multiple of tile=1024"):
        gather_dma.gather_rows(torch.zeros(8, 128), torch.zeros(1000, dtype=torch.int32))
    # the same words as the reference
    with pytest.raises(ValueError, match="C=64 must be a multiple of 128"):
        gather_rows_dma(jnp.zeros((8, 64)), jnp.zeros(1024, jnp.int32), interpret=True)
    with pytest.raises(ValueError, match="M=1000 must be a multiple of tile=1024"):
        gather_rows_dma(jnp.zeros((8, 128)), jnp.zeros(1000, jnp.int32), interpret=True)
    # on a device other than the CPU the kernel path refuses what it cannot take
    with pytest.raises(ValueError):
        gather_dma.gather_rows(torch.empty(8, 128, device="meta"), idx)


def test_gather_rows_zeroes_rows_outside_the_table():
    x = torch.arange(4 * 128, dtype=torch.float32).reshape(4, 128) + 1
    idx = torch.tensor([0, 3, -1, 4] * 256, dtype=torch.int32)
    out = gather_dma.gather_rows(x, idx)
    assert torch.equal(out[:2], x[[0, 3]]) and not out[2:4].any()
