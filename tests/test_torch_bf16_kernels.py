"""The port's kernels on bfloat16 operands against the JAX package on the CPU,
where the wrappers run their plain versions: the tile-window gather forward
and backward (ops/tile_gather.py, ops/cuda/tile_gather.py) against JAX's
tile_window_gather and the Pallas kernel tile_window_gather_pl in interpret
mode, and the fused attention (ops/pt_attn.py, ops/cuda/pt_attn.py) with
bfloat16 q and kv against JAX's pt_attn in interpret mode (the reference's
stale-BN path under its bf16 presets).

Inputs are made from a seed with numpy and rounded to bfloat16 once, so both
sides see the same bits.

Tolerances, each with its reason:
- Gather forward: bit for bit (a row copy; the reference selects rows
  exactly by a one-hot product with a float32 sum of one term).
- Gather backward: the port sums each row's slots in float32 in ascending
  slot order and rounds once (bit for bit the float32 sum of those slots
  rounded to nearest even, held here against a numpy loop); the reference
  sums the same terms in float32 in another order (one-hot products, then
  the windows' overlap-add) and rounds once. Two float32 sums of the same n
  terms differ by at most 2·n·2^-24·Σ|terms|, and each rounding to bfloat16
  moves a value by at most half an ulp of bfloat16 (2^-8 relative), so
  |port − ref| ≤ ulp_bf16(max(|port|, |ref|)) + 2·n·2^-24·Σ|terms|, per
  element, with n and Σ|terms| of that element.
- Attention: every product and sum is float32 on both sides from the same
  widened inputs, as in tests/test_torch_pt_attn.py (1e-5 there for out,
  1e-4 of scale for the gradients); out, dq and dkv are then rounded to
  bfloat16 once on each side, which may land one ulp apart where the
  float32 values straddle a rounding boundary: out, dq and dkv within
  ulp_bf16(max|·|) + the float32 tolerance, the statistics and the 12
  parameter gradients (float32 on both sides) at the float32 tolerances.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.ops.pallas.pt_attn import pt_attn as jax_pt_attn
from contrastboundary_tpu.ops.pallas.tile_gather_pl import tile_window_gather_pl
from contrastboundary_tpu.ops.tile_gather import tile_window_gather as jax_gather
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
from contrastboundary_tpu_torch.ops.pt_attn import pt_attn, pt_attn_bwd_plain, pt_attn_plain
from contrastboundary_tpu_torch.ops.tile_gather import tile_window_gather, window_starts

BF16 = torch.bfloat16
TILE, G = 8, 4
M = TILE * G
# (C, K, width): a vector-path width, an odd one, the self window of 1 tile
GATHER_CASES = [(16, 8, 3), (35, 5, 3), (8, 16, 1)]


def _bf16(a):
    """numpy float32 → (the bfloat16 tensor, its exact float32 values)."""
    t = torch.as_tensor(np.asarray(a, np.float32)).to(BF16)
    return t, t.float().numpy()


def _jbf16(exact):
    return jnp.asarray(exact).astype(jnp.bfloat16)


def _bits(x):
    """bfloat16 bits of a torch or JAX array."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _ulp(x):
    """One bfloat16 ulp at |x| (float32 array): 2^(e − 8) for |x| = m·2^e,
    m in [0.5, 1); the subnormal spacing at 0."""
    _, e = np.frexp(np.abs(x).astype(np.float32))
    return np.ldexp(np.float32(1.0), np.maximum(e - 8, -133)).astype(np.float32)


def _gather_case(c, k, width, seed=0):
    rng = np.random.RandomState(seed)
    w_sz = TILE * width
    x = rng.randn(2, M, c).astype(np.float32) * 3
    li = rng.randint(0, w_sz, (2, M, k)).astype(np.int32)
    li[:, ::3, -1] = w_sz  # shadow slots
    g = rng.randn(2, M, k, c).astype(np.float32)
    g[:, ::4, 0] = -g[:, 1::4, 0]  # rows whose terms cancel
    return x, li, g


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: "c{}-k{}-w{}".format(*c))
def test_bf16_gather_forward_is_the_references_bits(case):
    c, k, width = case
    x, li, _ = _gather_case(c, k, width)
    tx, ex = _bf16(x)
    out = tile_window_gather(tx, torch.as_tensor(li), TILE, width)
    assert out.dtype == BF16 and out.shape == (2, M, k, c)
    ref = jax_gather(_jbf16(ex), jnp.asarray(li), TILE, width)
    pal = tile_window_gather_pl(_jbf16(ex), jnp.asarray(li), TILE, width, True)
    assert ref.dtype == pal.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    np.testing.assert_array_equal(_bits(out), _bits(pal))


def _slot_sum(g, li, width):
    """dx of the plain float32 definition: each valid slot's row added onto
    its support row in ascending slot order (b, q, k), one float32 add at a
    time; also the count and the sum of |terms| per element."""
    b, m, k, c = g.shape
    starts = np.repeat(window_starts(m // TILE, width) * TILE, TILE)
    dx = np.zeros((b, m, c), np.float32)
    n = np.zeros((b, m, 1), np.float32)
    mag = np.zeros((b, m, c), np.float32)
    for bb in range(b):
        for q in range(m):
            for kk in range(k):
                j = li[bb, q, kk]
                if 0 <= j < TILE * width:
                    row = starts[q] + j
                    dx[bb, row] = dx[bb, row] + g[bb, q, kk]
                    n[bb, row] += 1
                    mag[bb, row] += np.abs(g[bb, q, kk])
    return dx, n, mag


@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: "c{}-k{}-w{}".format(*c))
def test_bf16_gather_backward_rounds_the_slot_order_sum_once(case):
    c, k, width = case
    x, li, g = _gather_case(c, k, width, seed=1)
    tg_, eg = _bf16(g)
    tli = torch.as_tensor(li)
    starts = torch.as_tensor(window_starts(G, width), dtype=torch.int32)
    dx = tg.window_gather_bwd_plain(tg_, tli, starts, TILE, width, M)
    assert dx.dtype == BF16
    s32, _, _ = _slot_sum(eg, li, width)
    np.testing.assert_array_equal(_bits(dx), _bits(torch.as_tensor(s32).to(BF16)))
    # autograd through the gather returns dx in x's dtype, the same bits
    tx = _bf16(x)[0].requires_grad_()
    tile_window_gather(tx, tli, TILE, width).backward(tg_)
    assert tx.grad.dtype == BF16
    np.testing.assert_array_equal(_bits(tx.grad), _bits(dx))


@pytest.mark.parametrize("pallas", [False, True], ids=["xla", "pallas-interpret"])
@pytest.mark.parametrize("case", GATHER_CASES, ids=lambda c: "c{}-k{}-w{}".format(*c))
def test_bf16_gather_backward_matches_jax_vjp(case, pallas):
    c, k, width = case
    x, li, g = _gather_case(c, k, width, seed=2)
    tg_, eg = _bf16(g)
    starts = torch.as_tensor(window_starts(G, width), dtype=torch.int32)
    dx = tg.window_gather_bwd_plain(tg_, torch.as_tensor(li), starts, TILE, width, M)
    assert dx.dtype == BF16
    dx = dx.float().numpy()

    def f(xx):
        if pallas:
            return tile_window_gather_pl(xx, jnp.asarray(li), TILE, width, True)
        return jax_gather(xx, jnp.asarray(li), TILE, width)

    _, vjp = jax.vjp(f, _jbf16(_bf16(x)[1]))
    (ref,) = vjp(_jbf16(eg))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    _, n, mag = _slot_sum(eg, li, width)
    tol = _ulp(np.maximum(np.abs(dx), np.abs(ref))) + 2 * n * 2.0**-24 * mag
    assert (np.abs(dx - ref) <= tol).all(), np.abs(dx - ref).max()


# (K, width, C, shadow slots); shares 8, as the kernels are built
ATTN_CASES = [(8, 3, 16, True), (16, 1, 32, False)]


def _attn_case(seed, k, width, c, shadow):
    rng = np.random.RandomState(seed)
    cs = c // 8
    w_sz = TILE * width

    def a(shape, off=0.0):
        return (rng.randn(*shape) * 0.3 + off).astype(np.float32)

    params = [a((3, 3)), a((1, 3)), a((3, c)), a((1, c)), a((1, c), 1.0), a((1, c)),
              a((c, cs)), a((1, cs)), a((1, cs), 1.0), a((1, cs)), a((cs, cs)), a((1, cs))]
    q, kv = rng.randn(2, M, c), rng.randn(2, M, 2 * c)
    rel = rng.randn(2, M, k, 3).astype(np.float32)
    li = rng.randint(0, w_sz, (2, M, k)).astype(np.int32)
    li[:, :, 0] = (np.arange(M) - np.repeat(window_starts(G, width) * TILE, TILE))[None]
    if shadow:
        li[:, ::3, -1] = w_sz
    g = rng.randn(2, M, c)
    return q, kv, rel, li, params, g


def _close_bf16(got, ref, tol_scale):
    """got (bfloat16 torch) against ref (bfloat16 JAX): one bfloat16 ulp
    plus tol_scale of ref's scale."""
    got, ref = got.float().numpy(), np.asarray(ref.astype(jnp.float32))
    tol = _ulp(np.maximum(np.abs(got), np.abs(ref))) + tol_scale * np.abs(ref).max()
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


def _jax_attn(eq, ekv, rel, li, params, width, *, grads_of=None):
    args = (jnp.asarray(rel), jnp.asarray(li), TILE, width, (width - 1) // 2, 8, True)
    ps = [jnp.asarray(p) for p in params]
    if grads_of is None:
        return jax_pt_attn(_jbf16(eq), _jbf16(ekv), *args, *ps)
    _, vjp = jax.vjp(lambda q_, kv_, *p_: jax_pt_attn(q_, kv_, *args, *p_)[0],
                     _jbf16(eq), _jbf16(ekv), *ps)
    return vjp(_jbf16(grads_of))


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "k{}-w{}-c{}-{}".format(*c))
def test_bf16_pt_attn_forward_matches_interpret_kernel(case):
    k, width, c, _ = case
    q, kv, rel, li, params, _ = _attn_case(0, *case)
    (tq, eq), (tkv, ekv) = _bf16(q), _bf16(kv)
    tps = [torch.as_tensor(p) for p in params]
    starts = torch.as_tensor(window_starts(G, width), dtype=torch.int32)
    out, s1, s2 = pt_attn_plain(tq, tkv, torch.as_tensor(rel), torch.as_tensor(li), starts, TILE,
                                width, tps)
    r_out, r_s1, r_s2 = _jax_attn(eq, ekv, rel, li, params, width)
    assert out.dtype == BF16 and r_out.dtype == jnp.bfloat16
    _close_bf16(out, r_out, 1e-5)
    for got, want in ((s1[0], r_s1[0]), (s1[1], r_s1[1]), (s2[0], r_s2[0]), (s2[1], r_s2[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


NAMES = ["dA1", "dc1", "dW2", "db2", "dg1", "dh1", "dW3", "db3", "dg2", "dh2", "dW4", "db4"]


@pytest.mark.parametrize("case", ATTN_CASES, ids=lambda c: "k{}-w{}-c{}-{}".format(*c))
def test_bf16_pt_attn_backward_matches_jax_vjp(case):
    k, width, c, _ = case
    q, kv, rel, li, params, g = _attn_case(1, *case)
    (tq, eq), (tkv, ekv), (tg_, eg) = _bf16(q), _bf16(kv), _bf16(g)
    tps = [torch.as_tensor(p) for p in params]
    starts = torch.as_tensor(window_starts(G, width), dtype=torch.int32)
    dq, dkv, grads = pt_attn_bwd_plain(tq, tkv, torch.as_tensor(rel), torch.as_tensor(li), starts,
                                       TILE, width, tps, tg_)
    ref = _jax_attn(eq, ekv, rel, li, params, width, grads_of=eg)
    assert dq.dtype == dkv.dtype == BF16 and ref[0].dtype == ref[1].dtype == jnp.bfloat16
    _close_bf16(dq, ref[0], 1e-4)
    _close_bf16(dkv, ref[1], 1e-4)
    for name, a, b in zip(NAMES, grads, ref[2:]):
        b = np.asarray(b)
        assert a.dtype == torch.float32
        # db4 is zero in exact arithmetic (a shift of every score): dW4's scale
        scale = np.abs(np.asarray(ref[2 + NAMES.index("dW4")])).max() if name == "db4" \
            else np.abs(b).max()
        assert np.abs(a.numpy() - b).max() <= 1e-4 * scale, name

    # the autograd Function passes the dtypes through: bfloat16 out, dq and
    # dkv, float32 parameter gradients, equal to the plain backward
    tq.requires_grad_(), tkv.requires_grad_()
    for p in tps:
        p.requires_grad_()
    out = pt_attn(tq, tkv, torch.as_tensor(rel), torch.as_tensor(li), TILE, width, tps)[0]
    assert out.dtype == BF16
    out.backward(tg_)
    assert tq.grad.dtype == tkv.grad.dtype == BF16
    np.testing.assert_array_equal(_bits(tq.grad), _bits(dq))
    np.testing.assert_array_equal(_bits(tkv.grad), _bits(dkv))
    for p, want in zip(tps, grads):
        torch.testing.assert_close(p.grad, want, rtol=0, atol=0)
