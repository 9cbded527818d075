"""The port's bfloat16 flagship model under bn_mode='stale' (the fused
attention kernel's path, ops/pt_attn.py, with bfloat16 q and kv) against
the JAX package's PointTransformerSeg(dtype=jnp.bfloat16, bn_mode='stale')
with its fused attention in interpret mode (PT_ATTN=interpret), on the CPU
at the sizes of tests/test_bf16.py (tests/torch_bf16_parity.py): eval logits
and one train step (make_train_step) from the same weights and batch.

Each tolerance is at most half of JAX's own bfloat16-vs-float32 gap on the
same inputs, computed here (JAX's float32 step of the stale model through
its XLA path, PT_ATTN=off, which computes the same function in float32; its
float32 eval through the batch-BN model, the same function in eval mode,
whose executable tests/test_torch_bf16_model.py compiles too):
- Eval logits: the RMS of port − JAX bf16 at most half the RMS of JAX bf16 −
  JAX f32. (A maximum would count single elements whose float32 attention
  output, summed in another order in the kernel and in the plain version,
  lies at a bfloat16 rounding boundary and rounds one ulp apart; the RMS
  weighs them by how few they are.)
- Train step: each metric at most half of |JAX bf16 − JAX f32|; the weights
  after the step within half of the distance between JAX's f32 and bf16
  steps, as fractions of JAX's update (as tests/test_torch_train.py states
  its tolerances). Stale BN normalizes with statistics fixed before the
  step, so no float32 sum order reaches a bfloat16 rounding in the forward
  but the attention's own. Both JAX steps are lowered under
  bp.reference_sums, as in tests/test_torch_bf16_model.py (here only its
  float32 sums of bfloat16 cotangents act: no flax nn.BatchNorm runs).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_bf16_parity as bp
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.models import load_jax_variables
from contrastboundary_tpu_torch.ops.cuda import pt_attn as pa
from contrastboundary_tpu_torch.ops.cuda import tile_gather as tg
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
    tree, data = bp.seeded_tree(1), bp.batch()
    out = {"tree": tree, "data": data}
    refs = bp.References()
    # eval-mode BN is the same function under stale and batch BN
    refs.add("jax_eval_f32", bp.eval_parts("batch", jnp.float32, tree, data), key=bp.F32_EVAL)
    with pytest.MonkeyPatch.context() as mp, bp.reference_sums():
        mp.setenv("PT_ATTN", "interpret")
        refs.add("jax_eval_bf16", bp.eval_parts("stale", jnp.bfloat16, tree, data))
        for name, dt, env in (("bf16", jnp.bfloat16, "interpret"), ("f32", jnp.float32, "off")):
            mp.setenv("PT_ATTN", env)
            refs.add(f"jax_step_{name}", bp.step_parts("stale", dt, tree, data))
    out.update(refs.run())
    model = load_jax_variables(bp.port_model("stale", torch.bfloat16), tree)
    out["port_eval"] = bp.port_eval_logits(model, data)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    out["port_probs"] = make_eval_step(model, bp.SPEC, device="cpu")(data)[0].numpy()
    out["stats_untouched"] = all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    out["port_step"] = bp.port_train_step(model, data)
    return out


def test_bf16_stale_eval_logits_match_jax(runs):
    port, ref, f32 = runs["port_eval"], runs["jax_eval_bf16"], runs["jax_eval_f32"]
    assert np.isfinite(port).all() and port.shape == ref.shape
    assert bp.rms(port, ref) <= HALF * bp.rms(ref, f32), (bp.rms(port, ref), bp.rms(ref, f32))
    probs = runs["port_probs"]
    assert probs.dtype == np.float32 and runs["stats_untouched"]
    np.testing.assert_allclose(probs, torch.softmax(torch.as_tensor(port), -1).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("metric", bp.METRICS)
def test_bf16_stale_train_step_metrics_match_jax(runs, metric):
    port, ref, f32 = (runs[k][0][metric] for k in ("port_step", "jax_step_bf16", "jax_step_f32"))
    assert np.isfinite(port)
    assert abs(port - ref) <= HALF * abs(ref - f32), (port, ref, f32)


@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_bf16_stale_train_step_weights_match_jax(runs, collection):
    before, after = runs["tree"], runs["port_step"][1]
    ref, f32 = runs["jax_step_bf16"][1], runs["jax_step_f32"][1]
    update = bp.tree_dist(ref, before, collection)
    got = bp.tree_dist(after, ref, collection) / update
    gap = bp.tree_dist(f32, ref, collection) / update
    assert got <= HALF * gap, (got, gap)
    for key, v in _leaves(after[collection]):
        assert v.dtype == np.float32 and np.isfinite(v).all(), key


def test_bf16_stale_layers_run_the_attention_and_gathers_in_bf16(monkeypatch):
    """On the CPU the wrappers run their plain versions; what the stale
    bf16 model hands them: bfloat16 q and kv to the fused attention (and
    float32 rel and tower arrays), float32 rows to every gather (the
    attention's own gather is inside the kernel)."""
    seen = {"attn": [], "gather": []}
    attn, gather = pa.pt_attn_fwd, tg.window_gather

    def rec_attn(q, kv, rel, li, starts, tile, width, params):
        seen["attn"].append((q.dtype, kv.dtype, rel.dtype, {p.dtype for p in params}))
        return attn(q, kv, rel, li, starts, tile, width, params)

    def rec_gather(x, *args):
        seen["gather"].append(x.dtype)
        return gather(x, *args)

    monkeypatch.setattr(pa, "pt_attn_fwd", rec_attn)
    monkeypatch.setattr(tg, "window_gather", rec_gather)
    model = load_jax_variables(bp.port_model("stale", torch.bfloat16), bp.seeded_tree(1))
    make_eval_step(model, bp.SPEC, device="cpu")(bp.batch())
    assert all(a == (torch.bfloat16, torch.bfloat16, torch.float32, {torch.float32})
               for a in seen["attn"])
    assert len(seen["attn"]) == 6  # enc 1 + 1 + 1, dec 3 attention layers
    assert set(seen["gather"]) == {torch.float32}
