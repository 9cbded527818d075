"""Shared set-up of the port's bfloat16 model tests (tests/test_torch_bf16_*.py):
a small PointTransformerSeg (planes 16, 32, 64, blocks 2, 2, 2, as
tests/test_bf16.py sizes the JAX one) on a three-level pyramid, seeded
weights and crops, and the JAX reference steps.

The JAX steps are compiled with XLA's ``xla_allow_excess_precision`` off.
With it on (XLA's default), XLA skips the bfloat16 rounding of a result
that only float32 consumers read, and which results those are depends on
its fusion choices, so the reference would round where flax's ops say at
some shapes and not at others. Off, every bfloat16 op of the reference
rounds where its flax op does, which is what the port computes
(models/blocks.py).

The JAX references are gathered in a ``References`` and compiled together:
each is lowered where it is added (inside the caller's contexts), then the
ones not compiled before in this process are compiled in parallel threads
(XLA compiles outside the GIL). The float32 eval is the same function
under batch and stale BN, so its executable serves both model files.

``reference_sums`` lowers the JAX train steps with two sums taken as the
port takes them; neither moves a rounding to bfloat16:
- ``float32_bf16_sums``: a bfloat16 ``reduce_sum`` as a float32 sum rounded
  once. JAX's autodiff emits one for the cotangent of every broadcast of a
  bfloat16 value (each bfloat16 Dense's bias, ``q[:, :, None]`` in the
  attention), and XLA's CPU backend sums it in bfloat16 (enc0's p_fc1 bias
  gradient, such a sum over 16,384 rows, carries half the port's squared
  parameter distance from the step as JAX lowers it).
  jnp.sum upcasts bfloat16 to float32 and rounds once, and so do torch's
  sums, which compute these gradients in the port.
- ``exact_batch_stats``: flax nn.BatchNorm's batch mean and E[x²] (float32
  by flax) summed in float64 and rounded to float32, instead of summed in
  float32 in XLA's CPU order, which lands a few float32 ulps from the exact
  mean over the 16k-32k terms of a channel (the port's torch sums give the
  float64 sums' bits on this batch). Where a normalized value lies within
  that difference of a bfloat16 rounding boundary, the next Dense's input
  rounds the other way, and at these sizes the batch statistics of the
  later levels spread such flips over every row (tests/torch_bf16_sum_order.py
  prints how far the sum order alone moves the step).
"""
import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import jax
import jax.numpy as jnp
from flax import struct
from flax.linen import normalization as flax_norm
from jax._src.interpreters import mlir
from jax._src.lax import lax as jax_lax

from contrastboundary_tpu.losses.contrast import ContrastConfig as JaxContrast
from contrastboundary_tpu.models import PointTransformerSeg as JaxSeg
from contrastboundary_tpu.ops.pyramid import PyramidSpec as JaxSpec
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.core.gather import batch_gather
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.models import PointTransformerSeg, load_jax_variables, to_jax_variables
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec, build_pyramid
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from test_torch_train import _dist, _jax_state, _leaves, _momentum_tree
from torch_parity import synthetic_crops

PLANES, BLOCKS, NUM_CLASSES = (16, 32, 64), (2, 2, 2), 13
SPEC_FIELDS = dict(strides=(1, 4, 4), k_self=(8, 8, 8), k_down=(8, 8, 8), k_contrast=(12, 8, 8),
                   with_subscene=True)
SPEC = PyramidSpec(**SPEC_FIELDS)
JAX_SPEC = JaxSpec(layout="sorted", sampler="strided", **SPEC_FIELDS)
NO_EXCESS = {"xla_allow_excess_precision": False}
METRICS = ("ce", "cbl", "loss", "cbl_stage0", "cbl_stage1", "cbl_stage2")


def batch(seed=5):
    pts, feats, labels = synthetic_crops(2, 1024, seed=seed)
    labels[:, ::97] = -1  # some ignored points
    return {"points": pts, "features": feats, "labels": labels}


def port_model(bn_mode, dtype):
    return PointTransformerSeg(num_classes=NUM_CLASSES, planes=PLANES, blocks=BLOCKS,
                               bn_mode=bn_mode, dtype=dtype)


def jax_model(bn_mode, dtype):
    return JaxSeg(num_classes=NUM_CLASSES, planes=PLANES, blocks=BLOCKS, bn_mode=bn_mode,
                  dtype=dtype)


def seeded_tree(seed=0):
    """A flax tree for the model: Dense kernels N(0, 1/fan_in), biases and
    BN shifts 0.1·N(0, 1), BN scales 1 + 0.1·N(0, 1), running means
    0.1·N(0, 1), running variances U(0.5, 1.5)."""
    model = port_model("batch", torch.float32)
    rng = np.random.default_rng(seed)
    tree = {"params": {}, "batch_stats": {}}
    for key, v in model.state_dict().items():
        *path, leaf = key.split(".")
        shape = tuple(v.shape)
        if leaf in ("running_mean", "running_var"):
            coll, name = "batch_stats", "mean" if leaf == "running_mean" else "var"
            a = rng.random(shape) + 0.5 if name == "var" else 0.1 * rng.standard_normal(shape)
        elif leaf == "weight" and isinstance(model.get_submodule(".".join(path)), torch.nn.Linear):
            coll, name = "params", "kernel"
            a = rng.standard_normal(shape[::-1]) / np.sqrt(shape[1])
        else:
            coll, name = "params", "scale" if leaf == "weight" else "bias"
            a = 1.0 + 0.1 * rng.standard_normal(shape) if name == "scale" \
                else 0.1 * rng.standard_normal(shape)
        node = tree[coll]
        for p in path:
            node = node.setdefault(p, {})
        node[name] = a.astype(np.float32)
    return tree


@struct.dataclass
class _State:
    params: object
    batch_stats: object


# executables by what they compute, shared by the test modules of a process
_EXECUTABLES = {}
F32_EVAL = ("eval", "float32")  # key of the float32 eval (either BN mode)


class References:
    """JAX reference runs: ``add`` lowers one (unless its ``key`` names an
    executable compiled before in this process), ``run`` compiles the
    lowered ones in parallel threads, runs every one and returns {name:
    result}."""

    def __init__(self):
        self._jobs = []

    def add(self, name, parts, key=None):
        fn, args, finish = parts
        lowered = None if key is not None and key in _EXECUTABLES else fn.lower(*args)
        self._jobs.append((name, key, lowered, args, finish))

    def run(self) -> dict:
        todo = [j for j in self._jobs if j[2] is not None]
        with ThreadPoolExecutor(max(len(todo), 1)) as pool:
            done = list(pool.map(lambda j: j[2].compile(compiler_options=NO_EXCESS), todo))
        compiled = {id(j): c for j, c in zip(todo, done)}
        out = {}
        for job in self._jobs:
            name, key, _, args, finish = job
            exe = compiled.get(id(job)) or _EXECUTABLES[key]
            if key is not None:
                _EXECUTABLES.setdefault(key, exe)
            out[name] = finish(exe(*args))
        return out


@contextlib.contextmanager
def float32_bf16_sums():
    """While active, JAX lowers a bfloat16 reduce_sum as the float32 sum of
    its widened operand rounded once to bfloat16."""
    entry = mlir._lowerings[jax_lax.reduce_sum_p]

    def lower(ctx, x, *, axes, **kw):
        if ctx.avals_in[0].dtype != jnp.bfloat16:
            return entry.rule(ctx, x, axes=axes, **kw)
        return mlir.lower_fun(lambda y: jax_lax.convert_element_type(jax_lax.reduce_sum_p.bind(
            jax_lax.convert_element_type(y, jnp.float32), axes=axes, **kw), jnp.bfloat16),
            multiple_results=False)(ctx, x)

    mlir.register_lowering(jax_lax.reduce_sum_p, lower)
    try:
        yield
    finally:
        mlir._lowerings[jax_lax.reduce_sum_p] = entry
        jax.clear_caches()  # no later lowering reuses this one


def _exact_stats(x, axes, dtype, axis_name=None, axis_index_groups=None, use_mean=True,
                 use_fast_variance=True, mask=None, force_float32_reductions=True):
    """flax.linen.normalization._compute_stats as nn.BatchNorm calls it in
    the reference (fast variance, no mask, no named axis), with x and x·x
    (float32, as flax's) summed in float64 and each mean rounded to
    float32."""
    assert use_mean and use_fast_variance and mask is None and axis_name is None
    x = x.astype(jnp.promote_types(dtype or x.dtype, jnp.float32))
    with jax.enable_x64(True):
        mu, mu2 = (jnp.mean(v.astype(jnp.float64), axes).astype(x.dtype) for v in (x, x * x))
    return mu, jnp.maximum(0.0, mu2 - mu * mu)


@contextlib.contextmanager
def exact_batch_stats():
    """While active, flax nn.BatchNorm traces its batch statistics as
    float64 sums rounded to float32."""
    compute = flax_norm._compute_stats
    flax_norm._compute_stats = _exact_stats
    try:
        yield
    finally:
        flax_norm._compute_stats = compute


@contextlib.contextmanager
def reference_sums():
    """The JAX train steps' sums as the port takes them (module docstring)."""
    with float32_bf16_sums(), exact_batch_stats():
        yield


def eval_parts(bn_mode, dtype, tree, data):
    """JAX make_eval_step(output='logits') on ``tree`` and ``data`` as
    (function, arguments, finish) for References.add; its result float32
    logits [B, N, classes] in the batch's row order."""
    step = jax_make_eval_step(jax_model(bn_mode, dtype),
                              JaxStepConfig(num_classes=NUM_CLASSES, spec=JAX_SPEC),
                              output="logits")
    state = _State(params=tree["params"], batch_stats=tree["batch_stats"])
    return (step, (state, {k: jnp.asarray(v) for k, v in data.items()}),
            lambda out: np.asarray(out[0], np.float32))


def jax_eval_logits(bn_mode, dtype, tree, data):
    """JAX make_eval_step(output='logits') → float32 logits [B, N, classes]
    in the batch's row order."""
    refs = References()
    refs.add("logits", eval_parts(bn_mode, dtype, tree, data))
    return refs.run()["logits"]


def port_eval_logits(model, data):
    """The port's eval-mode logits in the batch's row order (the eval step's
    pyramid and row orders, ops/pyramid.py, eval/step.py)."""
    spec = dataclasses.replace(SPEC, k_contrast=None, with_subscene=False)
    model = model.eval()
    with torch.no_grad():
        pyr = build_pyramid(torch.as_tensor(data["points"]), spec)
        logits = model(batch_gather(torch.as_tensor(data["features"]), pyr.order0), pyr)
        return batch_gather(logits, torch.argsort(pyr.order0, 1)).float().numpy()


def step_parts(bn_mode, dtype, tree, data):
    """JAX make_train_step from ``tree`` (SGD momentum 0.9, weight decay
    1e-4, lr 0.05, the momentum zero) as (function, arguments, finish) for
    References.add; its result (metrics, variables after). Add it inside
    ``reference_sums`` for the sums the port takes."""
    tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
    port = load_jax_variables(port_model("batch", torch.float32), tree)
    state = _jax_state(tree, _momentum_tree(port, make_optimizer(port.parameters(), 0.05)), tx)
    step = jax_make_train_step(jax_model(bn_mode, dtype), JaxStepConfig(
        num_classes=NUM_CLASSES, spec=JAX_SPEC, contrast=JaxContrast()))

    def finish(out):
        state, metrics = out
        after = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
        return {k: float(metrics[k]) for k in METRICS}, after

    return step, (state, {k: jnp.asarray(v) for k, v in data.items()}), finish


def jax_train_step(bn_mode, dtype, tree, data):
    """The JAX train step of ``step_parts`` → (metrics, variables after);
    run it inside ``reference_sums`` for the sums the port takes."""
    refs = References()
    refs.add("step", step_parts(bn_mode, dtype, tree, data))
    return refs.run()["step"]


def port_train_step(model, data):
    """The port's make_train_step on the CPU → (metrics, variables after)."""
    step = make_train_step(model, TrainStepConfig(num_classes=NUM_CLASSES, spec=SPEC,
                                                  contrast=ContrastConfig()),
                           make_optimizer(model.parameters(), 0.05), device="cpu")
    metrics = step(data)
    return {k: float(metrics[k]) for k in METRICS}, to_jax_variables(model)


def rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def tree_dist(a, b, collection):
    a, b = dict(_leaves(a[collection])), dict(_leaves(b[collection]))
    keys = sorted(b)
    assert sorted(a) == keys
    return _dist([a[k] for k in keys], [b[k] for k in keys])
