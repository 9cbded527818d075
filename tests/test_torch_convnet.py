"""The port's ConvNet family (models/local_aggregation.py, models/convnet.py)
against the JAX package's on the CPU, on the natural-layout pyramid of
grid-aligned crops (tests/torch_parity.py), with one torch thread.

Tolerances, each relative to the largest magnitude of the reference:
- each aggregation operator with its presets' options (and the two no
  preset uses, with their defaults), in train mode over the level 0 → 1
  pooling search (queries apart from the support rows, the output width
  changed where the operator allows), the published one also over the
  level-0 self search: output within 1e-5, the gradient of the input
  features within 1e-4 (float32 sums in another order, through a
  batch-statistics BN);
- ``generate_kernel_points`` bit for bit;
- ConvNetSeg with the published aggregation from one flax tree (BN
  parameters and statistics moved by seeded noise) in both packages: eval-mode logits within 1e-5; train-mode logits
  within 2e-5, and at most twice as far from the port's own float64
  forward as JAX's are (JAX's float32 train-mode logits lie up to ~2e-5 of
  scale from the float64 forward at such weights: the batch statistics of
  the 32-point top level amplify float32 rounding);
  the running statistics after the train-mode forward within rtol 1e-5 and
  atol 1e-6 (a statistic of the head's latents inherits the logits'
  rounding: 3e-6 of its value for the KPConv net);
- fresh weights: flax's distributions (lecun_normal Dense kernels within
  ±2σ, zero biases, BN at scale 1 / bias 0 / mean 0 / var 1, KPConv
  weights xavier_uniform: within the limit, std within 2% of flax's draw).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax.linen import initializers as flax_init

from contrastboundary_tpu.models import local_aggregation as jax_agg
from contrastboundary_tpu.models.convnet import ConvNetSeg as JaxConvNet
from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu_torch.models import ConvNetSeg, load_jax_variables, to_jax_variables
from contrastboundary_tpu_torch.models import local_aggregation as port_agg
from contrastboundary_tpu_torch.models.init import TRUNC_STD
from contrastboundary_tpu_torch.ops import pyramid as port_pyramid
from torch_parity import synthetic_crops

SPEC = dict(strides=(1, 4, 4), k_self=(16, 20, 24), k_down=(16, 16, 20), sampler="voxel",
            radii=(0.1, 0.2, 0.4), down_radii=(0.1, 0.1, 0.2), voxel_sizes=(0.04, 0.08, 0.16))
# (aggregation, options): the presets' (config/s3dis.py) and the two others'
AGGS = {
    "adaptive_weight": ("adaptive_weight", ()),
    "adaptive_weight_softmax": ("adaptive_weight", (("weight_softmax", "mask"),)),
    "pospool": ("pospool", (("position_embedding", "sin_cos"), ("reduction", "mean"))),
    "pseudo_grid": ("pseudo_grid", ()),
    "pointwisemlp": ("pointwisemlp", ()),
    "identity": ("identity", ()),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def data():
    """Grid crops, the port's natural pyramid and the same tensors as a JAX
    Pyramid (tests/test_torch_natural_pyramid.py holds the two packages'
    pyramids equal; building JAX's here would only compile it again)."""
    pts, feats, _ = synthetic_crops(2, 512, seed=4)
    tpyr = port_pyramid.build_pyramid(torch.from_numpy(pts),
                                      port_pyramid.PyramidSpec(layout="natural", **SPEC))

    def jx(fields):
        return tuple(None if t is None else jnp.asarray(t.numpy()) for t in fields)

    none = (None,) * len(SPEC["strides"])
    jpyr = jax_pyramid.Pyramid(
        points=jx(tpyr.points), sample_idx=jx(tpyr.sample_idx), self_idx=jx(tpyr.self_idx),
        down_idx=jx(tpyr.down_idx), up_idx=jx(tpyr.up_idx), up_w=jx(tpyr.up_w),
        near0_idx=jx(tpyr.near0_idx), contrast_idx=none, subscene_idx=none, self_rel=none,
        down_rel=none)
    return pts, feats, jpyr, tpyr


def _perturbed(tree, rng):
    """BN scales, biases and statistics (and every other leaf) moved by
    seeded noise, variances kept > 0."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else (np.abs(rng.randn(*v.shape)) + 0.5).astype(np.float32) if k == "var"
                else (np.asarray(v) + 0.1 * rng.randn(*v.shape)).astype(np.float32)
                for k, v in t.items()}
    return {c: walk(tree[c]) for c in ("params", "batch_stats") if c in tree}


def _close(got, ref, rtol, what=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= rtol * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("name,geometry", [(name, "pool") for name in sorted(AGGS)]
                         + [("adaptive_weight", "self")])
def test_aggregator_matches_jax(data, name, geometry):
    pts, _, jpyr, tpyr = data
    agg, kw = AGGS[name]
    c_in = 12
    if geometry == "self":  # the bottleneck's: level-0 queries, their self search
        q, c_out = 0, c_in
        jidx, nb = jpyr.self_idx[0], tpyr.self_idx[0]
    else:  # the strided bottleneck's: level-1 queries over level-0 rows
        q, c_out = 1, (c_in if agg == "pospool" else 2 * c_in)
        jidx, nb = jpyr.down_idx[1], tpyr.down_idx[1]
    radius = 0.1
    rng = np.random.RandomState(len(name))
    x = rng.randn(2, pts.shape[1], c_in).astype(np.float32)
    ct = rng.randn(2, tpyr.points[q].shape[1], c_out).astype(np.float32)
    extra = {"radius": radius} if agg == "pseudo_grid" else {}
    jmod = jax_agg.AGGREGATORS[agg](out_fdim=c_out, **dict(kw), **extra)
    geo = (jpyr.points[q], jpyr.points[0], jidx)
    variables = _perturbed(jax.device_get(
        jmod.init(jax.random.PRNGKey(1), *geo, jnp.asarray(x), radius, train=True)), rng)

    def f(xx):
        return jmod.apply(variables, *geo, xx, radius, train=True, mutable=["batch_stats"])

    @jax.jit
    def ref_fn(xx):
        out, mut = f(xx)
        return out, mut, jax.grad(lambda y: jnp.sum(f(y)[0] * ct))(xx)

    ref, mut, ref_grad = ref_fn(jnp.asarray(x))

    tmod = port_agg.AGGREGATORS[agg](c_in, c_out, **dict(kw), **extra)
    load_jax_variables(tmod, variables)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = tmod.train()(tpyr.points[q], tpyr.points[0], nb, tx, radius)
    (out * torch.from_numpy(ct)).sum().backward()
    _close(out.detach().numpy(), ref, 1e-5, "forward")
    _close(tx.grad.numpy(), ref_grad, 1e-4, "input gradient")
    got = dict(_leaves(to_jax_variables(tmod)["batch_stats"]))
    ref_stats = dict(_leaves(jax.device_get(mut["batch_stats"])))
    assert got.keys() == ref_stats.keys()
    for k in ref_stats:
        np.testing.assert_allclose(got[k], ref_stats[k], rtol=1e-6, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("radius,points", [(0.03, 15), (0.09, 15), (0.2625, 8)])
def test_generate_kernel_points_bit_for_bit(radius, points):
    ref = jax_agg.generate_kernel_points(radius, points)
    got = port_agg.generate_kernel_points(radius, points)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


# the published operator; the others are held to JAX above, module by module
MODEL_AGGS = ("adaptive_weight",)


def _port_convnet(name, variables=None):
    agg, kw = AGGS[name]
    model = ConvNetSeg(num_classes=13, base_fdim=12, num_layers=3, aggregation=agg,
                       agg_kwargs=kw, generator=torch.Generator().manual_seed(2))
    return model if variables is None else load_jax_variables(model, variables)


@pytest.fixture(scope="module")
def convnets(data):
    """For each of MODEL_AGGS: a flax tree (the port's fresh weights,
    then BN parameters and statistics moved by seeded noise), and JAX's
    eval logits, train logits and updated statistics from it (one compiled
    function a net)."""
    _, feats, jpyr, _ = data
    out = {}
    for name in MODEL_AGGS:
        agg, kw = AGGS[name]
        jm = JaxConvNet(num_classes=13, base_fdim=12, num_layers=3, aggregation=agg,
                        agg_kwargs=kw)
        variables = _perturbed(to_jax_variables(_port_convnet(name)), np.random.RandomState(7))

        @jax.jit
        def both(v, f, p):
            train, mut = jm.apply(v, f, p, train=True, mutable=["batch_stats"])
            return jm.apply(v, f, p, train=False).logits, train.logits, mut["batch_stats"]

        ref_eval, ref_train, stats = jax.device_get(both(variables, jnp.asarray(feats), jpyr))
        out[name] = (variables, ref_eval, ref_train, stats)
    return out


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", MODEL_AGGS)
def test_convnet_matches_jax(data, convnets, name, mode):
    _, feats, _, tpyr = data
    variables, ref_eval, ref_train, ref_stats = convnets[name]
    model = _port_convnet(name, variables)
    if mode == "eval":
        with torch.no_grad():
            logits = model.eval()(torch.from_numpy(feats), tpyr)
        _close(logits.numpy(), ref_eval, 1e-5, "eval logits")
        return
    out = model.train()(torch.from_numpy(feats), tpyr)
    assert len(out.latents) == 3 and out.latents[2].shape == (2, 32, 12)
    logits = out.logits.detach().numpy()
    _close(logits, ref_train, 2e-5, "train logits")
    exact = _port_convnet(name, variables).double().train()(
        torch.from_numpy(feats).double(),
        dataclasses.replace(tpyr, points=tuple(p.double() for p in tpyr.points)))
    exact = exact.logits.detach().numpy()
    assert np.abs(logits - exact).max() <= 2 * np.abs(ref_train - exact).max()
    got = dict(_leaves(to_jax_variables(model)["batch_stats"]))
    ref = dict(_leaves(ref_stats))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_convnet_rejects_the_sorted_pyramid(data):
    pts = torch.from_numpy(data[0])
    pyr = port_pyramid.build_pyramid(pts, port_pyramid.PyramidSpec(strides=(1, 4, 4),
                                                                   k_self=(8, 8, 8),
                                                                   k_down=(8, 8, 8)))
    model = ConvNetSeg(num_classes=13, base_fdim=12, num_layers=3)
    with pytest.raises(ValueError, match="natural"):
        model(torch.from_numpy(data[1]), pyr)


def test_fresh_convnet_weights_like_flax():
    model = ConvNetSeg(num_classes=13, base_fdim=12, num_layers=3, aggregation="pseudo_grid",
                       generator=torch.Generator().manual_seed(4))
    linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    assert len(linears) == 20
    for m in linears:
        sigma = np.sqrt(1.0 / m.in_features) / TRUNC_STD
        assert float(m.weight.detach().abs().max()) <= 2 * sigma * (1 + 1e-6)
        assert m.bias is None or not m.bias.detach().any()
    for name, p in model.named_parameters():
        if "bn" in name.split(".")[-2]:
            assert torch.all(p == (1.0 if name.endswith("weight") else 0.0)), name
    kp = [m.weights for m in model.modules() if isinstance(m, port_agg.PseudoGridAgg)]
    assert len(kp) == 6
    for w in kp:
        assert float(w.detach().abs().max()) <= np.sqrt(6.0 / sum(w.shape))
    again = ConvNetSeg(num_classes=13, base_fdim=12, num_layers=3, aggregation="pseudo_grid",
                       generator=torch.Generator().manual_seed(4))
    for (k, v), (_, w) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(v, w), k
    other = ConvNetSeg(num_classes=13, base_fdim=12, num_layers=3, aggregation="pseudo_grid",
                       generator=torch.Generator().manual_seed(5))
    assert not torch.equal(other.simple_agg.weights, model.simple_agg.weights)


def test_kernel_point_weights_match_flax_xavier_uniform():
    shape = (15, 576)
    ref = np.asarray(flax_init.xavier_uniform()(jax.random.PRNGKey(0), shape))
    w = port_agg.xavier_uniform_(torch.empty(shape), torch.Generator().manual_seed(0)).numpy()
    limit = np.sqrt(6.0 / sum(shape))
    assert np.abs(w).max() <= limit and np.abs(ref).max() <= limit
    assert abs(w.std() / ref.std() - 1) <= 0.02 and abs(w.std() / (limit / np.sqrt(3)) - 1) <= 0.02
