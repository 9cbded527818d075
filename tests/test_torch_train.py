"""Port training pieces against the JAX reference on the CPU, float32:
train-mode BatchNorm against flax nn.BatchNorm, the SGD update against
optax (make_optimizer), the multistep schedule, and the whole train step at
small width against JAX make_train_step for 1 and 3 steps (metrics,
parameters and batch_stats through to_jax_variables). The JAX step takes
its reference CBL route (CBL_DENSE unset: elementwise (q − s) distances);
the port takes the dense-window route (the clamped expansion), so the CBL
terms agree to the tolerance tests/test_cbl_dense.py holds the two routes
to; everything else is float32 sums in another order. The port's first
step on its other two CBL routes (CBL_DENSE=off with impl 'xla' and
'pallas') is held against the same JAX step, whose route it then takes up
to sum order."""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax import linen as fnn

from contrastboundary_tpu.losses.contrast import ContrastConfig as JaxContrast
from contrastboundary_tpu.models import PointTransformerSeg as JaxSeg
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.ops.pyramid import build_pyramid as jax_build_pyramid
from contrastboundary_tpu.train.schedule import multistep_epoch_decay as jax_multistep
from contrastboundary_tpu.train.state import create_train_state
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, load_jax_variables, to_jax_variables,
)
from contrastboundary_tpu_torch.models.blocks import BatchNorm
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec
from contrastboundary_tpu_torch.train import (
    TrainStepConfig, make_optimizer, make_train_step, multistep_epoch_decay,
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


K_CONTRAST = (36, 24, 24, 24, 24)
PLANES, BLOCKS = (16, 16, 16, 16, 16), (1, 1, 1, 1, 1)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize("shape", [(2, 300, 6), (2, 64, 8, 5)])
def test_train_batchnorm_matches_flax(shape):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    variables = {
        "params": {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
                   "bias": (0.1 * rng.randn(c)).astype(np.float32)},
        "batch_stats": {"mean": (0.1 * rng.randn(c)).astype(np.float32),
                        "var": (rng.rand(c) + 0.5).astype(np.float32)},
    }
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, mutated = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])

    tbn = BatchNorm(c)
    tbn.load_state_dict({
        "weight": torch.as_tensor(variables["params"]["scale"]),
        "bias": torch.as_tensor(variables["params"]["bias"]),
        "running_mean": torch.as_tensor(variables["batch_stats"]["mean"]),
        "running_var": torch.as_tensor(variables["batch_stats"]["var"]),
    })
    ty = tbn.train()(torch.as_tensor(x))
    # float32 reductions over up to 640 rows in another order
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tbn.running_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbn.running_var.numpy(), np.asarray(mutated["batch_stats"]["var"]), rtol=1e-6, atol=1e-6)


def test_sgd_update_matches_optax():
    rng = np.random.RandomState(1)
    shapes = {"a": (4, 3), "b": (7,)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(3)]

    tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    opt = make_optimizer(tp.values(), 0.05)
    for i, g in enumerate(grads):
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        opt.step()
        if i in (0, 2):  # one and three steps
            for k in shapes:
                np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_multistep_schedule_matches_optax():
    ref = jax_multistep(0.5, [0.6 * 200, 0.8 * 200], 0.1, 10)
    ours = multistep_epoch_decay(0.5, [0.6 * 200, 0.8 * 200], 0.1, 10)
    for step in (0, 1, 1199, 1200, 1201, 1599, 1600, 1999, 5000):
        assert ours(step) == float(np.float32(ref(step))), step


def _perturbed(tree, rng):
    """Weights and BN statistics moved by seeded noise (variances kept > 0)."""
    def walk(t):
        return {
            k: walk(v) if isinstance(v, dict)
            else (np.abs(rng.randn(*v.shape)) + 0.5).astype(np.float32) if k == "var"
            else (np.asarray(v) + 0.1 * rng.randn(*v.shape)).astype(np.float32)
            for k, v in t.items()
        }
    return {"params": walk(tree["params"]), "batch_stats": walk(tree["batch_stats"])}


def _momentum_tree(model, optimizer):
    """SGD's momentum buffers as a flax params tree (zeros before the
    first step, as optax's trace state starts)."""
    mom = copy.deepcopy(model)
    with torch.no_grad():
        for p, q in zip(model.parameters(), mom.parameters()):
            q.copy_(optimizer.state.get(p, {}).get("momentum_buffer", torch.zeros_like(p)))
    return to_jax_variables(mom)["params"]


def _jax_state(variables, momentum, tx):
    """A JAX TrainState holding the port's parameters, statistics and
    momentum."""
    state = create_train_state(variables, tx)
    opt_state = tuple(
        optax.TraceState(trace=momentum) if isinstance(s, optax.TraceState) else s
        for s in state.opt_state
    )
    return state.replace(opt_state=opt_state)


def train_batches():
    """The three seeded batches of the small-width step comparison."""
    batches = []
    for seed in (5, 6, 7):
        pts, feats, labels = synthetic_crops(2, 2048, seed=seed)
        labels[:, ::97] = -1  # some ignored points
        batches.append({"points": pts, "features": feats, "labels": labels})
    return batches


def small_setup(perturb_seed):
    """The three seeded batches, the JAX pyramid spec and model, and the
    starting variables of the small-width step comparison."""
    batches = train_batches()
    jspec = JaxSpec(k_contrast=K_CONTRAST, with_subscene=True, layout="sorted", sampler="strided")
    jmodel = JaxSeg(num_classes=13, planes=PLANES, blocks=BLOCKS, share_planes=8)
    jpyr = jax_build_pyramid(jnp.asarray(batches[0]["points"]), jspec)
    jfeats = jnp.take_along_axis(jnp.asarray(batches[0]["features"]), jpyr.order0[..., None], 1)
    # perturbed away from flax's init: zero biases put the positional BN of
    # the tiny top level (8 points that all see each other, so rel is
    # antisymmetric) exactly on the ReLU kink, where float noise picks the
    # gradient
    variables = _perturbed(jax.device_get(jax.jit(jmodel.init, static_argnames=("train",))(
        jax.random.PRNGKey(0), jfeats, jpyr, train=True
    )), np.random.RandomState(perturb_seed))
    return batches, jspec, jmodel, variables


def train_runs_for(perturb_seed):
    """Three steps of the port on three seeded batches; before each, the
    port's parameters, statistics and momentum go into a JAX TrainState,
    and JAX make_train_step takes the same step from there. So each step
    is compared from one state, and the comparison does not compound over
    steps. → [(before, port metrics, port after, JAX metrics, JAX after)]."""
    batches, jspec, jmodel, variables = small_setup(perturb_seed)
    model = load_jax_variables(
        PointTransformerSeg(num_classes=13, planes=PLANES, blocks=BLOCKS, share_planes=8),
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


@pytest.fixture(scope="module")
def train_runs():
    return train_runs_for(0)


def _dist(a, b):
    return float(np.sqrt(sum(np.sum((x - y) ** 2) for x, y in zip(a, b))))


@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_metrics_match_jax(train_runs, steps):
    _, port, _, ref, _ = train_runs[steps - 1]
    keys = {"ce", "cbl", "loss", "confusion"} | {f"cbl_stage{i}" for i in range(5)}
    assert set(port) == set(ref) == keys
    for k in keys - {"confusion"}:
        # the forward from one state: float32 sums in another order (CE)
        # and the two CBL routes (loss rel 3e-5 in tests/test_cbl_dense.py)
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=3e-5, err_msg=k)
    tc, jc = port["confusion"], np.asarray(ref["confusion"])
    # rows (true labels) are exact; a prediction may differ only where two
    # logits tie to float noise: at most 4 of the 4096 points
    np.testing.assert_array_equal(tc.sum(1), jc.sum(1))
    assert np.abs(tc - jc).sum() <= 2 * 4, np.abs(tc - jc).sum()


# the step from one state, against the norm of JAX's change in the step:
# batch_stats come from the forward alone (float32 sums in another order);
# a parameter update also carries the ReLU kinks of the backward. The
# forward's rounding moves pre-activations at the coarse levels by up to
# ~1e-5, so a few of the 10^4-10^5 there lie within noise of zero and their
# ReLU derivative depends on the sum order. One such flip at level 3 (32
# points a cloud) moves JAX's own first update by 3.3e-3 of its norm when
# the batch's two clouds are swapped, which leaves the step mathematically
# the same; 1e-2 leaves room for that.
STEP_RTOL = {"params": 1e-2, "batch_stats": 2e-5}


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_train_step_weights_match_jax(train_runs, steps, collection):
    before, _, port, _, ref = train_runs[steps - 1]
    before, port, ref = (dict(_leaves(v[collection])) for v in (before, port, ref))
    assert set(port) == set(ref) == set(before)
    keys = sorted(ref)
    got = _dist([port[k] for k in keys], [ref[k] for k in keys])
    change = _dist([ref[k] for k in keys], [before[k] for k in keys])
    assert got <= STEP_RTOL[collection] * change, (got, change)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_train_step_on_the_other_cbl_routes_matches_jax(train_runs, monkeypatch, impl):
    """CBL_DENSE=off: the XLA tile route (impl='xla') and the fused v2 route
    (impl='pallas') from the first step's state against JAX's first step,
    whose CBL route (the XLA tile route) computes the same expressions:
    the metrics to rtol 1e-5 (tests/test_torch_cbl_routes.py's tolerance
    for the stage losses), the confusion as above, the weights to
    STEP_RTOL."""
    monkeypatch.setenv("CBL_DENSE", "off")
    before, _, _, ref, ref_after = train_runs[0]
    model = load_jax_variables(
        PointTransformerSeg(num_classes=13, planes=PLANES, blocks=BLOCKS, share_planes=8), before)
    step = make_train_step(
        model, TrainStepConfig(num_classes=13, spec=PyramidSpec(k_contrast=K_CONTRAST, with_subscene=True),
                               contrast=ContrastConfig(impl=impl)),
        make_optimizer(model.parameters(), 0.05), device="cpu",
    )
    port = {k: v.numpy() for k, v in step(train_batches()[0]).items()}
    for k in {"ce", "cbl", "loss"} | {f"cbl_stage{i}" for i in range(5)}:
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    tc, jc = port["confusion"], np.asarray(ref["confusion"])
    np.testing.assert_array_equal(tc.sum(1), jc.sum(1))
    assert np.abs(tc - jc).sum() <= 2 * 4, np.abs(tc - jc).sum()
    after = to_jax_variables(model)
    for collection in ("params", "batch_stats"):
        b, p, r = (dict(_leaves(v[collection])) for v in (before, after, ref_after))
        keys = sorted(r)
        got = _dist([p[k] for k in keys], [r[k] for k in keys])
        change = _dist([r[k] for k in keys], [b[k] for k in keys])
        assert got <= STEP_RTOL[collection] * change, (collection, got, change)
