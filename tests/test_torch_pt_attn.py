"""Port of the fused point-transformer attention (ops/pt_attn.py and
ops/cuda/pt_attn.py) against the JAX module ops/pallas/pt_attn.py, float32 on
the CPU: the plain forward against ``pt_attn_reference`` and against the
Pallas kernel in interpret mode (as tests/test_pt_attn.py runs it); the
plain analytic backward against JAX's VJP and against torch.autograd of the
plain forward; and the autograd Function (which on CPU tensors runs the plain
versions) against both.

Tolerances: out and the statistics rtol/atol 1e-5 (float32 sums in another
order); gradients max|Δ| within 1e-4 of the gradient's scale (max|ref|).
db4 is identically zero in exact arithmetic (a softmax ignores a shift of
its scores, and b4 shifts every slot's score alike), so its two values are
rounding noise: it is held to 1e-4 of dW4's scale instead."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.ops.pallas.pt_attn import pt_attn as jax_pt_attn
from contrastboundary_tpu.ops.pallas.pt_attn import pt_attn_reference
from contrastboundary_tpu_torch.ops.pt_attn import pt_attn, pt_attn_bwd_plain, pt_attn_plain
from contrastboundary_tpu_torch.ops.tile_gather import window_starts

TILE, G = 8, 4
M = TILE * G
NAMES = ["dq", "dkv", "dA1", "dc1", "dW2", "db2", "dg1", "dh1", "dW3", "db3", "dg2", "dh2",
         "dW4", "db4"]
# (K, width, C, shares, shadow slots)
CASES = [
    (8, 3, 16, 8, True),
    (16, 1, 32, 8, True),
    (16, 3, 32, 8, False),
    (8, 3, 16, 4, True),
]


def _case(seed, k, width, c, shares, shadow):
    rng = np.random.RandomState(seed)
    cs = c // shares
    w_sz = TILE * width

    def a(shape, off=0.0):
        return (rng.randn(*shape) * 0.3 + off).astype(np.float32)

    params = [a((3, 3)), a((1, 3)), a((3, c)), a((1, c)), a((1, c), 1.0), a((1, c)),
              a((c, cs)), a((1, cs)), a((1, cs), 1.0), a((1, cs)), a((cs, cs)), a((1, cs))]
    q = rng.randn(2, M, c).astype(np.float32)
    kv = rng.randn(2, M, 2 * c).astype(np.float32)
    rel = rng.randn(2, M, k, 3).astype(np.float32)
    li = rng.randint(0, w_sz, (2, M, k)).astype(np.int32)
    starts = window_starts(G, width)
    li[:, :, 0] = (np.arange(M) - np.repeat(starts * TILE, TILE))[None]  # slot 0 = self
    if shadow:
        li[:, ::3, -1] = w_sz
        li[:, ::5, k // 2] = w_sz
    g = rng.randn(2, M, c).astype(np.float32)
    return q, kv, rel, li, params, g


def _torch(q, kv, rel, li, params):
    t = torch.as_tensor
    return t(q), t(kv), t(rel), t(li), [t(p) for p in params]


def _starts(width):
    return torch.as_tensor(window_starts(G, width), dtype=torch.int32)


def _assert_grads(got, ref):
    ref = [np.asarray(r) for r in ref]
    for name, a, b in zip(NAMES, got, ref):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = np.abs(ref[NAMES.index("dW4")]).max() if name == "db4" else np.abs(b).max()
        err = np.abs(a - b).max()
        assert err <= 1e-4 * scale, (name, err, scale)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "k{}-w{}-c{}-s{}-{}".format(*c))
def test_plain_forward_matches_jax_reference(case):
    q, kv, rel, li, params, _ = _case(0, *case)
    k, width, c, shares, _ = case
    tq, tkv, trel, tli, tps = _torch(q, kv, rel, li, params)
    out, s1, s2 = pt_attn_plain(tq, tkv, trel, tli, _starts(width), TILE, width, tps)
    r_out, r_s1, r_s2 = pt_attn_reference(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(rel), jnp.asarray(li),
        [jnp.asarray(p) for p in params], TILE, width, shares)
    np.testing.assert_allclose(out.numpy(), np.asarray(r_out), rtol=1e-5, atol=1e-5)
    for got, want in ((s1[0], r_s1[0]), (s1[1], r_s1[1]), (s2[0], r_s2[0]), (s2[1], r_s2[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("case", CASES[:3], ids=lambda c: "k{}-w{}-c{}-s{}-{}".format(*c))
def test_plain_forward_matches_interpret_kernel(case):
    q, kv, rel, li, params, _ = _case(1, *case)
    k, width, c, shares, _ = case
    tq, tkv, trel, tli, tps = _torch(q, kv, rel, li, params)
    out, s1, s2 = pt_attn_plain(tq, tkv, trel, tli, _starts(width), TILE, width, tps)
    k_out, k_s1, k_s2 = jax_pt_attn(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(rel), jnp.asarray(li), TILE, width,
        (width - 1) // 2, shares, True, *[jnp.asarray(p) for p in params])
    np.testing.assert_allclose(out.numpy(), np.asarray(k_out), rtol=1e-5, atol=1e-5)
    for got, want in ((s1[0], k_s1[0]), (s1[1], k_s1[1]), (s2[0], k_s2[0]), (s2[1], k_s2[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _jax_grads(q, kv, rel, li, params, g, width, shares, interpret):
    def loss(q_, kv_, *ps):
        if interpret:
            out = jax_pt_attn(q_, kv_, jnp.asarray(rel), jnp.asarray(li), TILE, width,
                              (width - 1) // 2, shares, True, *ps)[0]
        else:
            out = pt_attn_reference(q_, kv_, jnp.asarray(rel), jnp.asarray(li), ps, TILE,
                                    width, shares)[0]
        return jnp.sum(out * jnp.asarray(g))

    return jax.grad(loss, tuple(range(14)))(
        jnp.asarray(q), jnp.asarray(kv), *[jnp.asarray(p) for p in params])


@pytest.mark.parametrize("case", CASES, ids=lambda c: "k{}-w{}-c{}-s{}-{}".format(*c))
def test_plain_backward_matches_jax_vjp(case):
    q, kv, rel, li, params, g = _case(2, *case)
    k, width, c, shares, _ = case
    tq, tkv, trel, tli, tps = _torch(q, kv, rel, li, params)
    dq, dkv, dps = pt_attn_bwd_plain(tq, tkv, trel, tli, _starts(width), TILE, width, tps,
                                     torch.as_tensor(g))
    _assert_grads([dq, dkv, *dps], _jax_grads(q, kv, rel, li, params, g, width, shares, False))


def test_plain_backward_matches_interpret_kernel_vjp():
    k, width, c, shares, shadow = CASES[0]
    q, kv, rel, li, params, g = _case(3, *CASES[0])
    tq, tkv, trel, tli, tps = _torch(q, kv, rel, li, params)
    dq, dkv, dps = pt_attn_bwd_plain(tq, tkv, trel, tli, _starts(width), TILE, width, tps,
                                     torch.as_tensor(g))
    _assert_grads([dq, dkv, *dps], _jax_grads(q, kv, rel, li, params, g, width, shares, True))


@pytest.mark.parametrize("case", CASES, ids=lambda c: "k{}-w{}-c{}-s{}-{}".format(*c))
def test_plain_backward_matches_autograd(case):
    q, kv, rel, li, params, g = _case(4, *case)
    width = case[1]
    tq, tkv, trel, tli, tps = _torch(q, kv, rel, li, params)
    leaves = [tq.clone().requires_grad_(), tkv.clone().requires_grad_()] + [
        p.clone().requires_grad_() for p in tps]
    out, _, _ = pt_attn_plain(leaves[0], leaves[1], trel, tli, _starts(width), TILE, width,
                              leaves[2:])
    (out * torch.as_tensor(g)).sum().backward()
    dq, dkv, dps = pt_attn_bwd_plain(tq, tkv, trel, tli, _starts(width), TILE, width, tps,
                                     torch.as_tensor(g))
    _assert_grads([dq, dkv, *dps], [x.grad.numpy() for x in leaves])


def test_function_runs_the_plain_versions_on_cpu():
    """The autograd Function on CPU tensors: forward outputs and the
    gradients of q, kv and the 12 arrays equal the plain versions', the
    statistics carry no gradient, and rel takes none."""
    k, width, c, shares, _ = CASES[1]
    q, kv, rel, li, params, g = _case(5, *CASES[1])
    tq, tkv, trel, tli, tps = _torch(q, kv, rel, li, params)
    leaves = [tq.clone().requires_grad_(), tkv.clone().requires_grad_()] + [
        p.clone().requires_grad_() for p in tps]
    out, s1, s2 = pt_attn(leaves[0], leaves[1], trel, tli, TILE, width, leaves[2:])
    assert not s1.requires_grad and not s2.requires_grad
    p_out, p_s1, p_s2 = pt_attn_plain(tq, tkv, trel, tli, _starts(width), TILE, width, tps)
    assert torch.equal(out, p_out) and torch.equal(s1, p_s1) and torch.equal(s2, p_s2)
    (out * torch.as_tensor(g)).sum().backward()
    dq, dkv, dps = pt_attn_bwd_plain(tq, tkv, trel, tli, _starts(width), TILE, width, tps,
                                     torch.as_tensor(g))
    for got, want in zip(leaves, [dq, dkv, *dps]):
        assert torch.equal(got.grad, want)
