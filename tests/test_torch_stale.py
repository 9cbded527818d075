"""The port under bn_mode='stale' against the JAX package, float32 on the CPU
(where the fused attention runs its plain versions): StaleBatchNorm against
the flax StaleBatchNorm; the stale PointTransformerLayer (the fused path with
the BNs folded in) against JAX's fused path (PT_ATTN=interpret, the Pallas
kernel in interpret mode) and its XLA stale path (PT_ATTN=off); the stale
train step against JAX make_train_step on PointTransformerSeg(bn_mode=
'stale'); the stale eval step against the batch eval step and JAX's; and the
flax converter's round trip of a stale model.

Tolerances, each with its reason:
- StaleBatchNorm: output and running statistics 1e-6 (the same float32
  formula; the batch statistics summed in another order); the gradient of x
  exact up to 1e-7 (no gradient passes through the statistics).
- Layer: output 1e-5 and running statistics 1e-5 (float32 sums in another
  order; p_bn's update comes from moments of rel on both fused paths, from
  the [B, M, K, 3] tensor on the XLA path); parameter gradients max|Δ|
  within 1e-4 of each gradient's scale. w_fc2's bias shifts every slot's
  score alike, so its gradient is zero in exact arithmetic and held to 1e-4
  of w_fc2's kernel gradient instead.
- Train step (as tests/test_torch_train.py, each of three steps from one
  shared state): losses rel 3e-5, batch_stats 2e-5 of the step's change,
  params 1e-2 of the update.
- Eval step: probs 1e-4 (float32 sums in another order), argmax equal.
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import struct

from contrastboundary_tpu.losses.contrast import ContrastConfig as JaxContrast
from contrastboundary_tpu.models import PointTransformerSeg as JaxSeg
from contrastboundary_tpu.models.blocks import PointTransformerLayer as JaxLayer
from contrastboundary_tpu.models.blocks import StaleBatchNorm as JaxStaleBN
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, from_jax_variables, load_jax_variables, to_jax_variables,
)
from contrastboundary_tpu_torch.models.blocks import (
    BatchNorm, PointTransformerLayer, StaleBatchNorm, make_bn,
)
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec
from contrastboundary_tpu_torch.ops.tile_gather import window_starts
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from test_torch_train import (
    BLOCKS, K_CONTRAST, PLANES, STEP_RTOL, _dist, _jax_state, _leaves, _momentum_tree,
    _perturbed,
)
from torch_parity import synthetic_crops


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """One torch thread: the suite's six workers with torch's default of a
    thread a core oversubscribe the cores (as tests/test_torch_main.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _bn_variables(rng, c):
    return {
        "params": {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                   "bias": (0.1 * rng.randn(c)).astype(np.float32)},
        "batch_stats": {"mean": (0.1 * rng.randn(c)).astype(np.float32),
                        "var": (rng.rand(c) + 0.5).astype(np.float32)},
    }


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_stale_batchnorm_matches_flax(train):
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 64, 8, 5) * 3 + 1).astype(np.float32)
    g = rng.randn(*x.shape).astype(np.float32)
    variables = _bn_variables(rng, 5)
    bn = JaxStaleBN(use_running_average=not train)

    def f(xx):
        return bn.apply(variables, xx, mutable=["batch_stats"])

    (y, mutated), vjp = jax.vjp(f, jnp.asarray(x))
    (gx,) = vjp((jnp.asarray(g), jax.tree_util.tree_map(jnp.zeros_like, mutated)))

    tbn = StaleBatchNorm(5)
    tbn.load_state_dict({
        "weight": torch.as_tensor(variables["params"]["scale"]),
        "bias": torch.as_tensor(variables["params"]["bias"]),
        "running_mean": torch.as_tensor(variables["batch_stats"]["mean"]),
        "running_var": torch.as_tensor(variables["batch_stats"]["var"]),
    })
    tbn.train(train)
    tx = torch.as_tensor(x).requires_grad_()
    ty = tbn(tx)
    (ty * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-7, atol=1e-7)
    want = mutated["batch_stats"] if train else variables["batch_stats"]
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(want["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(want["var"]), rtol=1e-6, atol=1e-6)


def test_make_bn_modes():
    assert type(make_bn("batch", 4)) is BatchNorm
    assert type(make_bn("stale", 4)) is StaleBatchNorm
    with pytest.raises(ValueError, match="bn_mode"):
        make_bn("sync", 4)
    assert set(make_bn("stale", 4).state_dict()) == set(make_bn("batch", 4).state_dict())


TILE, G = 8, 4
M = TILE * G
# (C, K, width); share_planes 8
LAYER_CASES = [(16, 8, 3), (32, 16, 1)]


def _layer_case(c, k, width, seed=0):
    rng = np.random.RandomState(seed)
    w_sz = TILE * width
    p = rng.rand(2, M, 3).astype(np.float32)
    x = rng.randn(2, M, c).astype(np.float32)
    rel = (rng.randn(2, M, k, 3) * 0.1).astype(np.float32)
    li = rng.randint(0, w_sz, (2, M, k)).astype(np.int32)
    li[:, :, 0] = (np.arange(M) - np.repeat(window_starts(G, width) * TILE, TILE))[None]
    li[:, ::3, -1] = w_sz  # shadow slots (their rel is zero, as the pyramid makes it)
    rel[:, ::3, -1] = 0.0
    g = rng.randn(2, M, c).astype(np.float32)
    return p, x, rel, li, g


def _jax_layer_run(monkeypatch, env, c, variables, p, x, rel, li, g, width):
    monkeypatch.setenv("PT_ATTN", env)
    layer = JaxLayer(c, 8, bn_mode="stale")

    def loss(params):
        out, mut = layer.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(p), jnp.asarray(x), jnp.asarray(li), True, jnp.asarray(rel),
            (TILE, width), mutable=["batch_stats"],
        )
        return jnp.sum(out * jnp.asarray(g)), (out, mut)

    grads, (out, mut) = jax.jit(jax.grad(loss, has_aux=True))(variables["params"])
    return np.asarray(out), jax.device_get(mut), jax.device_get(grads)


@pytest.mark.parametrize("env", ["interpret", "off"])
@pytest.mark.parametrize("case", LAYER_CASES, ids=lambda c: "c{}-k{}-w{}".format(*c))
def test_stale_layer_matches_jax(monkeypatch, env, case):
    c, k, width = case
    p, x, rel, li, g = _layer_case(c, k, width)
    monkeypatch.setenv("PT_ATTN", "off")  # the fused path declares the same tree
    variables = JaxLayer(c, 8, bn_mode="stale").init(
        jax.random.PRNGKey(0), jnp.asarray(p), jnp.asarray(x), jnp.asarray(li), True,
        jnp.asarray(rel), (TILE, width),
    )
    variables = _perturbed(jax.device_get(variables), np.random.RandomState(1))
    out, mut, grads = _jax_layer_run(monkeypatch, env, c, variables, p, x, rel, li, g, width)

    layer = load_jax_variables(PointTransformerLayer(c, 8, "stale"), variables).train()
    tout = layer(torch.as_tensor(x), torch.as_tensor(li), torch.as_tensor(rel), (TILE, width))
    (tout * torch.as_tensor(g)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), out, rtol=1e-5, atol=1e-5)
    got_stats = dict(_leaves(to_jax_variables(layer)["batch_stats"]))
    want_stats = dict(_leaves(mut["batch_stats"]))
    assert set(got_stats) == set(want_stats)
    for key in want_stats:
        np.testing.assert_allclose(got_stats[key], want_stats[key], rtol=1e-5, atol=1e-5, err_msg=key)
    grad_model = copy.deepcopy(layer)
    with torch.no_grad():
        for pa, pg in zip(grad_model.parameters(), layer.parameters()):
            pa.copy_(pg.grad)
    got = dict(_leaves(to_jax_variables(grad_model)["params"]))
    want = dict(_leaves(grads))
    assert set(got) == set(want)
    for key, ref in want.items():
        scale = np.abs(want["w_fc2/kernel"]).max() if key == "w_fc2/bias" else np.abs(ref).max()
        err = np.abs(got[key] - ref).max()
        assert err <= 1e-4 * scale, (key, err, scale)


def test_stale_model_round_trips_through_flax_tree():
    model = PointTransformerSeg(num_classes=13, planes=PLANES, blocks=(2, 1, 1, 1, 1), bn_mode="stale")
    rng = np.random.RandomState(3)
    with torch.no_grad():
        for v in model.state_dict().values():
            v.copy_(torch.as_tensor(rng.rand(*v.shape).astype(np.float32)))
    tree = to_jax_variables(model)
    back = from_jax_variables(tree)
    assert set(back) == set(model.state_dict())
    for key, v in model.state_dict().items():
        assert torch.equal(back[key], v), key
    # a batch-mode model of the same widths takes the same tree
    load_jax_variables(PointTransformerSeg(num_classes=13, planes=PLANES, blocks=(2, 1, 1, 1, 1)), tree)


def _jax_spec():
    return JaxSpec(k_contrast=K_CONTRAST, with_subscene=True, layout="sorted", sampler="strided")


@pytest.fixture(scope="module")
def stale_train_runs():
    """Three stale steps of the port on three seeded batches, and JAX's
    step (XLA stale path) from the same state before each (as
    tests/test_torch_train.py::train_runs_for does for batch BN)."""
    batches = []
    for seed in (5, 6, 7):
        pts, feats, labels = synthetic_crops(2, 2048, seed=seed)
        labels[:, ::97] = -1
        batches.append({"points": pts, "features": feats, "labels": labels})
    jspec = _jax_spec()
    jmodel = JaxSeg(num_classes=13, planes=PLANES, blocks=BLOCKS, share_planes=8, bn_mode="stale")
    jpyr = jax_build_pyramid(jnp.asarray(batches[0]["points"]), jspec)
    jfeats = jnp.take_along_axis(jnp.asarray(batches[0]["features"]), jpyr.order0[..., None], 1)
    variables = _perturbed(jax.device_get(jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jfeats, jpyr, train=True
    )), np.random.RandomState(0))
    model = load_jax_variables(
        PointTransformerSeg(num_classes=13, planes=PLANES, blocks=BLOCKS, share_planes=8,
                            bn_mode="stale"),
        variables,
    )
    opt = make_optimizer(model.parameters(), 0.05)
    step = make_train_step(
        model, TrainStepConfig(num_classes=13, spec=PyramidSpec(k_contrast=K_CONTRAST, with_subscene=True),
                               contrast=ContrastConfig()),
        opt, device="cpu",
    )
    jstep = jax_make_train_step(jmodel, JaxStepConfig(num_classes=13, spec=jspec, contrast=JaxContrast()))
    tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
    runs = []
    for batch in batches:
        before, momentum = to_jax_variables(model), _momentum_tree(model, opt)
        state, jm = jstep(_jax_state(before, momentum, tx), {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(batch)
        runs.append((
            before, {k: v.numpy() for k, v in m.items()}, to_jax_variables(model),
            jax.device_get(jm), {"params": jax.device_get(state.params),
                                 "batch_stats": jax.device_get(state.batch_stats)},
        ))
    return runs


@pytest.mark.parametrize("steps", [1, 2, 3])
def test_stale_train_step_losses_match_jax(stale_train_runs, steps):
    _, port, _, ref, _ = stale_train_runs[steps - 1]
    keys = {"ce", "cbl", "loss"} | {f"cbl_stage{i}" for i in range(5)}
    for k in keys:
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=3e-5, err_msg=k)


@pytest.mark.parametrize("steps", [1, 2, 3])
@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_stale_train_step_weights_match_jax(stale_train_runs, steps, collection):
    before, _, port, _, ref = stale_train_runs[steps - 1]
    before, port, ref = (dict(_leaves(v[collection])) for v in (before, port, ref))
    assert set(port) == set(ref) == set(before)
    keys = sorted(ref)
    got = _dist([port[k] for k in keys], [ref[k] for k in keys])
    change = _dist([ref[k] for k in keys], [before[k] for k in keys])
    assert got <= STEP_RTOL[collection] * change, (got, change)


@struct.dataclass
class _State:
    params: object
    batch_stats: object


def test_stale_eval_step_matches_batch_eval_and_jax():
    """In eval mode stale and batch BN compute the same function; the stale
    model serves through the fused attention, the batch model through the
    XLA-style path, and both leave the running statistics untouched."""
    pts, feats, labels = synthetic_crops(2, 1024, seed=4)
    batch = {"points": pts, "features": feats, "labels": labels}
    planes, blocks = PLANES, (2, 1, 1, 1, 1)
    jmodel = JaxSeg(num_classes=13, planes=planes, blocks=blocks, bn_mode="stale")
    jspec = JaxSpec(layout="sorted", sampler="strided")
    jpyr = jax_build_pyramid(jnp.asarray(pts), jspec)
    jfeats = jnp.take_along_axis(jnp.asarray(feats), jpyr.order0[..., None], 1)
    variables = _perturbed(jax.device_get(jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(1), jfeats, jpyr, train=False
    )), np.random.RandomState(2))
    j_probs, j_conf = jax_make_eval_step(jmodel, JaxStepConfig(num_classes=13, spec=jspec))(
        _State(params=variables["params"], batch_stats=variables["batch_stats"]),
        {k: jnp.asarray(v) for k, v in batch.items()},
    )

    stale = load_jax_variables(
        PointTransformerSeg(num_classes=13, planes=planes, blocks=blocks, bn_mode="stale"), variables)
    plain = load_jax_variables(PointTransformerSeg(num_classes=13, planes=planes, blocks=blocks), variables)
    before = copy.deepcopy(stale.state_dict())
    probs, conf = make_eval_step(stale, PyramidSpec(), device="cpu")(batch)
    b_probs, _ = make_eval_step(plain, PyramidSpec(), device="cpu")(batch)
    for key, v in stale.state_dict().items():
        assert torch.equal(v, before[key]), key
    np.testing.assert_allclose(probs.numpy(), np.asarray(j_probs), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(probs.argmax(-1).numpy(), np.asarray(j_probs).argmax(-1))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(j_conf))
    np.testing.assert_allclose(probs.numpy(), b_probs.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(probs.argmax(-1).numpy(), b_probs.argmax(-1).numpy())
