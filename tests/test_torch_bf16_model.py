"""The port's bfloat16 flagship model, PointTransformerSeg(dtype=torch.bfloat16)
under batch BN on the dense CBL route, against the JAX package's
PointTransformerSeg(dtype=jnp.bfloat16) on the CPU, at the sizes of
tests/test_bf16.py (tests/torch_bf16_parity.py): its parameters stay float32
and take a flax tree as the float32 model does; its eval logits and one
train step (make_train_step) against JAX's bfloat16 ones from the same
weights and batch.

Each tolerance is half of JAX's own bfloat16-vs-float32 gap on the same
inputs, computed here (JAX's float32 eval and step beside its bfloat16 ones):
- Eval logits: max |port − JAX bf16| at most half of max |JAX bf16 − JAX
  f32|, per element (the eval path has no data-dependent statistics; the
  port rounds where the reference does, and the two differ by float32 sum
  order).
- Train step: each metric at most half of |JAX bf16 − JAX f32|; the
  parameters and batch statistics after the step within half of the
  distance between JAX's f32 and bf16 steps, as fractions of JAX's update
  (as tests/test_torch_train.py states its tolerances).

Both JAX steps are lowered under bp.reference_sums: bfloat16 reduce_sums
(the bias cotangents of the bfloat16 Denses) as float32 sums rounded once,
and flax's batch statistics summed in float64. As they are, XLA's CPU backend
sums a bfloat16 reduce in bfloat16 (enc0's p_fc1 bias, such a sum over
16,384 rows, carries half the port's squared distance from JAX's step in
the parameters), and sums the statistics in an
order a few float32 ulps from the exact sum; values that lie within that of
a bfloat16 rounding boundary round the other way at the next Dense, and the
batch statistics of the coarse levels spread the flips over every row: the
port was 0.85 of the gap from JAX's step in the parameters and 1.05 in
cbl_stage2, and JAX against itself on the batch with its two clouds swapped
0.43 and 0.13 (tests/torch_bf16_sum_order.py). Under reference_sums the
port is 0.028 of the gap in the parameters and at most 4e-4 in every
metric and in the statistics: its batch statistics here are the float64
sums' bits. At seeds where one statistic differs in its last bit the flips
return (weights 1 and 2: the port against itself with float64 statistics
0.34 and 0.38 of the gap in the parameters), and no tolerance at half the
gap separates sum order from a fault; this batch is not one of them.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_bf16_parity as bp
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.models import load_jax_variables, to_jax_variables
from test_torch_train import _leaves


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """One torch thread: the suite's six workers with torch's default of a
    thread a core oversubscribe the cores (as tests/test_torch_main.py)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


HALF = 0.5


@pytest.fixture(scope="module")
def runs():
    tree, data = bp.seeded_tree(0), bp.batch()
    out = {"tree": tree, "data": data}
    refs = bp.References()
    refs.add("jax_eval_bf16", bp.eval_parts("batch", jnp.bfloat16, tree, data))
    refs.add("jax_eval_f32", bp.eval_parts("batch", jnp.float32, tree, data), key=bp.F32_EVAL)
    with bp.reference_sums():
        for name, dt in {"bf16": jnp.bfloat16, "f32": jnp.float32}.items():
            refs.add(f"jax_step_{name}", bp.step_parts("batch", dt, tree, data))
    out.update(refs.run())
    model = load_jax_variables(bp.port_model("batch", torch.bfloat16), tree)
    out["port_eval"] = bp.port_eval_logits(model, data)
    out["port_probs"] = make_eval_step(model, bp.SPEC, device="cpu")(data)[0].numpy()
    out["port_step"] = bp.port_train_step(model, data)
    return out


def test_bf16_model_keeps_float32_parameters_and_takes_a_flax_tree():
    tree = bp.seeded_tree(0)
    model = load_jax_variables(bp.port_model("batch", torch.bfloat16), tree)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert {b.dtype for b in model.buffers()} == {torch.float32}
    back = dict(_leaves(to_jax_variables(model)))
    for key, v in _leaves(tree):
        np.testing.assert_array_equal(back[key], v, err_msg=key)


def test_bf16_eval_logits_match_jax(runs):
    port, ref, f32 = runs["port_eval"], runs["jax_eval_bf16"], runs["jax_eval_f32"]
    assert np.isfinite(port).all() and port.shape == ref.shape
    got, gap = np.abs(port - ref).max(), np.abs(ref - f32).max()
    assert got <= HALF * gap, (got, gap)
    # the eval step serves the same logits as float32 probabilities
    probs = runs["port_probs"]
    assert probs.dtype == np.float32
    np.testing.assert_allclose(probs, torch.softmax(torch.as_tensor(port), -1).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("metric", bp.METRICS)
def test_bf16_train_step_metrics_match_jax(runs, metric):
    port, ref, f32 = (runs[k][0][metric] for k in ("port_step", "jax_step_bf16", "jax_step_f32"))
    assert np.isfinite(port)
    assert abs(port - ref) <= HALF * abs(ref - f32), (port, ref, f32)


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_bf16_train_step_weights_match_jax(runs, collection):
    """The distance of the port's weights after the step to JAX's bf16
    step's, against the distance of JAX's f32 step's to its bf16 step's;
    as fractions of JAX's update (as tests/test_torch_train.py states its
    tolerances)."""
    before, after = runs["tree"], runs["port_step"][1]
    ref, f32 = runs["jax_step_bf16"][1], runs["jax_step_f32"][1]
    update = bp.tree_dist(ref, before, collection)
    got = bp.tree_dist(after, ref, collection) / update
    gap = bp.tree_dist(f32, ref, collection) / update
    assert got <= HALF * gap, (got, gap)
    for key, v in _leaves(after[collection]):
        assert v.dtype == np.float32 and np.isfinite(v).all(), key
