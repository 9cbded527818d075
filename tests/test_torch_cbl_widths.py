"""The CBL kernels' plain versions at the feature widths the CBL head's
options give them (the class count of logits or probs, 13 on S3DIS and 20
on ScanNet; each level's planes under f_out, 64 to 512), against the JAX
Pallas kernels in interpret mode on the CPU:

- the dense route's stage loss (ops/cuda/cbl_dense.py::cbl_dense_loss:
  the plain stats and their VJP) against ops/pallas/cbl_dense.py::
  cbl_dense_loss (CBL_DENSE=interpret on the JAX side), rtol 1e-5;
- v2 (ops/cuda/cbl_tile2.py) against ops/pallas/cbl_tile2.py::
  cbl_tile_softnn2(interpret=True), as tests/test_torch_cbl_tile2.py holds
  it: the mask sums exact, the loss sums rtol 1e-5.

The gradients (the dense loss's, v2's VJP) are held within 1e-5
(v2: 1e-6) of their scale, or within twice JAX's own distance from the
function's float64 gradient where that is wider (``_exact``: distances as
direct differences, autograd): the float32 noise of a distance grows with C
(and, in the expansion, with |q|²), and each slot's coefficient divides by
its distance.

The wrappers pad rows to the kernels' widths (32, 64, 128, 256 or 512) on
the card only; the plain versions take every width as it is.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.ops.pallas.cbl_dense import _row_meta as jax_row_meta
from contrastboundary_tpu.ops.pallas.cbl_dense import cbl_dense_loss as jax_dense_loss
from contrastboundary_tpu.ops.pallas.cbl_tile2 import cbl_tile_softnn2 as jax_v2
from contrastboundary_tpu_torch.ops.cuda import cbl_dense, cbl_tile2
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from test_cbl_dense import _case

WIDTHS = (13, 20, 64, 256, 512)


def _t(a):
    return torch.as_tensor(np.array(a))


def _exact(feats, meta, li, temperature, tile, width, window):
    """The stats function in float64 with distances taken as direct
    differences → (stats [B, M, 5]: m̂, Σe·pos, Σe, pos count, valid
    count; features, differentiable; m̂ carries no gradient)."""
    f = torch.as_tensor(np.array(feats), dtype=torch.float64).requires_grad_()
    meta = torch.as_tensor(np.array(meta), dtype=torch.float64)
    li = torch.as_tensor(np.array(li))
    b, m, c = f.shape
    starts = torch.as_tensor(cbl_dense.self_window_starts(m, tile, width, window))
    rows, member = tg._rows(li, starts, tile, width, m)
    s_meta = meta.reshape(b * m, 8)[rows]
    mv = member.double() * s_meta[..., 1]
    posmv = ((meta[:, :, None, 0] - s_meta[..., 0]).abs() < 0.5).double() * mv
    dist = torch.sqrt(((f[:, :, None, :] - f.reshape(b * m, c)[rows]) ** 2).sum(-1) + 1e-12)
    valid = mv > 0
    m_hat = torch.where(valid, -dist, -1e9).amax(-1).detach()
    e = torch.exp(torch.where(valid, (-dist - m_hat[..., None]) / temperature, -50.0)) * mv
    return torch.stack([m_hat, (e * posmv).sum(-1), e.sum(-1), posmv.sum(-1), mv.sum(-1)],
                       -1), f


def _row_loss(stats, query_valid):
    """(loss [B, M], mask [B, M]) of the softnn stats."""
    pos, under, pc, vc = stats.unbind(-1)[1:5]
    loss = -torch.log(pos / torch.clamp_min(under, 1e-12) + 1e-12)
    return loss, ((pc > 0) & (pc < vc) & query_valid).double()


def _grad_close(got, ref, exact, rel):
    """max|got − ref| within ``rel`` of ref's scale or twice ref's own
    distance from the float64 value."""
    err = float(np.abs(got - ref).max())
    own = float(np.abs(ref - exact).max())
    assert err <= max(rel * float(np.abs(ref).max()), 2 * own), (err, own)


@pytest.mark.parametrize("c", WIDTHS)
def test_dense_stage_loss_matches_pallas_interpret(c):
    feats, onehot, li, tile, width = _case(c=c, seed=c + 1)
    window = (width - 1) // 2
    ref, dref = jax.value_and_grad(lambda f: jax_dense_loss(
        f, onehot, li, 1.0, tile, width, window, weight=0.1, interpret=True))(feats)
    ft = _t(feats).requires_grad_()
    loss = cbl_dense.cbl_dense_loss(ft, _t(onehot), _t(li), 1.0, tile, width, window,
                                    weight=0.1)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
    stats, f64 = _exact(feats, jax_row_meta(onehot), li, 1.0, tile, width, window)
    row, mask = _row_loss(stats, torch.as_tensor(np.array(onehot)).sum(-1) > 0)
    ((row * mask).sum() / mask.sum().clamp_min(1.0) * 0.1).backward()
    _grad_close(ft.grad.numpy(), np.asarray(dref), f64.grad.numpy(), 1e-5)


@pytest.mark.parametrize("c", WIDTHS)
def test_v2_plain_matches_pallas_interpret_at_width(c):
    b, m, k, ncls, tile, width, window = 2, 64, 6, 4, 16, 3, 1
    rng = np.random.RandomState(c)
    feats = rng.randn(b, m, c).astype(np.float32)
    ls = rng.rand(b, m, ncls).astype(np.float32)
    ls /= ls.sum(-1, keepdims=True)
    ls[rng.rand(b, m) < 0.1] = 0.0
    li = rng.randint(0, tile * width + 1, (b, m, k)).astype(np.int32)
    g = rng.randn(b).astype(np.float32)
    args = (jnp.asarray(ls), jnp.asarray(li), 0.5, tile, width, window, True)
    (ref_l, ref_m), vjp = jax.vjp(lambda f: jax_v2(f, *args), jnp.asarray(feats))
    dref = np.asarray(vjp((jnp.asarray(g), jnp.zeros(b)))[0])
    ft = _t(feats).requires_grad_()
    got_l, got_m = cbl_tile2.cbl_tile_softnn2(ft, _t(ls), _t(li), 0.5, tile, width, window)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    assert float(got_m.sum()) > 0
    np.testing.assert_allclose(got_l.detach().numpy(), np.asarray(ref_l), rtol=1e-5)
    got_l.backward(_t(g))
    meta = cbl_dense.row_meta(_t(ls))
    stats, f64 = _exact(feats, meta, li, 0.5, tile, width, window)
    row, mask = _row_loss(stats, meta[..., 1] > 0)
    ((row * mask).sum(-1) * torch.as_tensor(g, dtype=torch.float64)).sum().backward()
    _grad_close(ft.grad.numpy(), dref, f64.grad.numpy(), 1e-6)
