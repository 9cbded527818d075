"""The point-transformer baseline without CBL, ``s3dis_pt`` (the sorted
layout, the plain mlp head), against the JAX package on the CPU with one
torch thread, at small widths: two levels (strides 1, 4), planes 16-32,
one block a level, N = 2048 crops on the 1/64 m grid
(tests/torch_parity.py). One train step of each head variant from the same
state against JAX's make_train_step: the preset's head (xen);
'mlp-2-xen-class-w.5-dp.3' (a two-layer tower, class weights, loss weight,
dropout) for two steps, each from one state, so that the dropout key of
step 1 is used; 'mlp-1-sigmoid' at one class; 'mlp-1-none'. The eval step
under batch and stale BN against JAX's make_eval_step. The plain head's
flax tree through the converter and back. ``main.py -c s3dis_pt --mode
train|val`` with class weights and dropout. Each JAX function is compiled
once a process, the train steps in parallel threads.

Tolerances, those of the flagship's train-step tests
(tests/test_torch_pt_natural_train.py, tests/test_torch_train.py): the
metrics rtol 1e-5 (float32 sums in another order); the confusion's rows
equal and at most 8 entries moved (near-tied logits); params within 1e-2
and batch_stats within 2e-5 of the step's change (STEP_RTOL: ReLU kinks
that flip with the sum order); the eval probs within 1e-5 of scale.
"""
import dataclasses
import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import contrastboundary_tpu_torch.main as entry
from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.losses.segmentation import (
    inverse_frequency_weights as jax_inverse_frequency_weights,
)
from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu.train.state import create_train_state
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.losses import inverse_frequency_weights
from contrastboundary_tpu_torch.models import (
    from_jax_variables, load_jax_variables, to_jax_variables,
)
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from test_torch_main import write_rooms
from test_torch_pt_natural import compile_in_threads
from test_torch_train import STEP_RTOL, _dist, _jax_state, _leaves, _momentum_tree, _perturbed
from torch_parity import synthetic_crops

N = 2048
SMALL = "model.planes:[16,32];model.blocks:[1,1];model.strides:[1,4];model.nsample:[8,16]"
# name → (arch_out or None for the preset's, classes, steps), batch BN
VARIANTS = {
    "xen": (None, 13, 1),
    "mixed": ("mlp-2-xen-class-w.5-dp.3", 13, 2),
    "sigmoid": ("mlp-1-sigmoid", 1, 1),
    "none": ("mlp-1-none", 13, 1),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _sets(arch_out=None, classes=13, bn_mode="batch"):
    sets = f"{SMALL};model.bn_mode:{bn_mode};data.num_classes:{classes}"
    return sets if arch_out is None else f"{sets};arch_out:{arch_out}"


def _configs(*args):
    sets = _sets(*args)
    return load_config("s3dis_pt", sets), jax_load_config("s3dis_pt", sets)


def _batch(seed, classes=13):
    pts, feats, labels = synthetic_crops(2, N, seed=seed)
    if classes == 1:  # the binary task of a one-logit sigmoid head
        labels = (labels % 2).astype(labels.dtype)
    labels[:, ::97] = -1
    return {"points": pts, "features": feats, "labels": labels}


def _class_weights(cfg, batch):
    if not cfg.heads.get("mlp", {}).get("class_weight"):
        return None
    lab = batch["labels"][batch["labels"] >= 0]
    counts = np.bincount(lab, minlength=cfg.data.num_classes)
    counts[3] = 0  # an absent class weighs 1
    weights = inverse_frequency_weights(counts)
    assert weights == jax_inverse_frequency_weights(counts)
    return weights


def _step_configs(cfg, jcfg, weights):
    mlp = cfg.heads.get("mlp", {})
    kw = dict(num_classes=cfg.data.num_classes, main_loss=mlp.get("loss", "xen"),
              main_weight=mlp.get("weight", 1.0), has_dropout=bool(mlp.get("drop")),
              class_weights=weights)
    return (TrainStepConfig(spec=cfg.pyramid_spec(), **kw),
            JaxStepConfig(spec=jcfg.pyramid_spec(), **kw))


@pytest.fixture(scope="module")
def step_runs():
    """For each variant, each step of the port from one state (the port's
    perturbed fresh weights, its statistics and momentum, and the update
    count) and JAX's step from the same state, the JAX steps compiled in
    parallel threads: → {variant: [(before, port metrics, port after, JAX
    metrics, JAX after)]}."""
    setups, lowered = {}, {}
    tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
    for name, (arch_out, classes, steps) in VARIANTS.items():
        cfg, jcfg = _configs(arch_out, classes)
        batches = [_batch(5 + s, classes) for s in range(steps)]
        before = _perturbed(to_jax_variables(cfg.build_model(
            device="cpu", generator=torch.Generator().manual_seed(2))), np.random.RandomState(3))
        model = load_jax_variables(cfg.build_model(device="cpu"), before)
        opt = make_optimizer(model.parameters(), 0.05)
        port_cfg, jax_cfg = _step_configs(cfg, jcfg, _class_weights(cfg, batches[0]))
        jstep = jax_make_train_step(jcfg.build_model(), jax_cfg)
        state = _jax_state(before, _momentum_tree(model, opt), tx)
        lowered[name] = jstep.lower(state, {k: jnp.asarray(v) for k, v in batches[0].items()})
        setups[name] = (model, opt, port_cfg, batches, tx)
    out = {}
    for name, exe in compile_in_threads(lowered).items():
        model, opt, port_cfg, batches, tx = setups[name]
        step = make_train_step(model, port_cfg, opt, device="cpu")
        runs = []
        for i, batch in enumerate(batches):
            before, momentum = to_jax_variables(model), _momentum_tree(model, opt)
            state = _jax_state(before, momentum, tx).replace(step=jnp.asarray(i, jnp.int32))
            state, jm = exe(state, {k: jnp.asarray(v) for k, v in batch.items()})
            assert step.count == i
            m = step(batch)
            runs.append((before, {k: v.numpy() for k, v in m.items()}, to_jax_variables(model),
                         jax.device_get(jm), {"params": jax.device_get(state.params),
                                              "batch_stats": jax.device_get(state.batch_stats)}))
        out[name] = runs
    return out


CASES = [(name, s) for name, v in VARIANTS.items() for s in range(v[2])]


@pytest.mark.parametrize("name,step", CASES)
def test_train_step_metrics_match_jax(step_runs, name, step):
    _, port, _, ref, _ = step_runs[name][step]
    assert set(port) == set(ref) == {"ce", "loss", "confusion"}
    for k in ("ce", "loss"):
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=1e-5, err_msg=k)
    if name == "none":
        assert float(port["loss"]) == 0.0
    if name == "mixed":
        np.testing.assert_allclose(float(port["loss"]), 0.5 * float(port["ce"]), rtol=1e-7)
    tc, jc = port["confusion"], np.asarray(ref["confusion"])
    np.testing.assert_array_equal(tc.sum(1), jc.sum(1))
    assert np.abs(tc - jc).sum() <= 2 * 4, np.abs(tc - jc).sum()


@pytest.mark.parametrize("name,step", CASES)
@pytest.mark.parametrize("collection", ["params", "batch_stats"])
def test_train_step_weights_match_jax(step_runs, name, step, collection):
    before, _, port, _, ref = step_runs[name][step]
    before, port, ref = (dict(_leaves(v[collection])) for v in (before, port, ref))
    assert set(port) == set(ref) == set(before)
    keys = sorted(ref)
    got = _dist([port[k] for k in keys], [ref[k] for k in keys])
    change = _dist([ref[k] for k in keys], [before[k] for k in keys])
    assert change > 0
    assert got <= STEP_RTOL[collection] * change, (got, change)


def test_dropout_steps_draw_other_masks(step_runs):
    """The two dropout steps (update counts 0 and 1) draw different masks:
    from the same weights and batch their losses differ."""
    cfg, _ = _configs(*VARIANTS["mixed"][:2])
    before = step_runs["mixed"][0][0]
    losses = []
    for count in (0, 1):
        model = load_jax_variables(cfg.build_model(device="cpu"), before)
        port_cfg, _ = _step_configs(cfg, cfg, None)
        step = make_train_step(model, port_cfg, make_optimizer(model.parameters(), 0.05),
                               device="cpu", start_step=count)
        losses.append(float(step(_batch(5))["loss"]))
    assert losses[0] != losses[1], losses


@pytest.mark.parametrize("bn_mode", ["batch", "stale"])
def test_eval_step_matches_jax(bn_mode):
    """The eval step (probs in the caller's rows, the confusion) of the
    plain head against JAX's batch-BN eval step from the same perturbed
    weights (eval-mode BN is one function under both BN modes); the
    feature step returns no latents."""
    batch = _batch(9)
    cfg, jcfg = _configs("mlp-2-xen-dp.5", 13, bn_mode)
    variables = _perturbed(to_jax_variables(cfg.build_model(
        device="cpu", generator=torch.Generator().manual_seed(4))), np.random.RandomState(5))
    ref = _eval_reference(variables, batch)
    model = load_jax_variables(cfg.build_model(device="cpu"), variables)
    probs, conf = make_eval_step(model, cfg.pyramid_spec(), device="cpu")(batch)
    err = float(np.abs(probs.numpy() - ref[0]).max())
    assert err <= 1e-5 * np.abs(ref[0]).max(), err
    np.testing.assert_array_equal(conf.numpy().sum(1), ref[1].sum(1))
    _, _, feats = make_eval_step(model, cfg.pyramid_spec(), device="cpu",
                                 with_features=True)(batch)
    assert feats == {}


_EVAL_REF = {}


def _eval_reference(variables, batch):
    """JAX's batch-BN eval step of 'mlp-2-xen-dp.5' on ``variables``,
    compiled once a process (the optimizer, a static field of the state,
    made once too)."""
    if not _EVAL_REF:
        _, jcfg = _configs("mlp-2-xen-dp.5")
        _EVAL_REF["step"] = jax_make_eval_step(jcfg.build_model(), JaxStepConfig(
            num_classes=13, spec=jcfg.pyramid_spec()))
        _EVAL_REF["tx"] = jax_make_optimizer(0.05)
    probs, conf = _EVAL_REF["step"](create_train_state(variables, _EVAL_REF["tx"]),
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    return np.asarray(probs), np.asarray(conf)


def test_confusion_drops_labels_outside_the_classes():
    """The confusion of a one-class sigmoid head's binary labels: JAX's
    one-hot contraction drops the rows whose label is not a class (here 1,
    and -2, which is not the ignore label), and so does the port's."""
    from contrastboundary_tpu.eval.metrics import confusion_matrix as jax_confusion
    from contrastboundary_tpu_torch.eval.metrics import confusion_matrix

    labels = np.array([[0, 1, 1, -1, 0, -2]], np.int32)
    pred = np.array([[0, 0, 0, 0, 0, 0]], np.int32)
    for c in (1, 2):
        ref = np.asarray(jax_confusion(jnp.asarray(pred), jnp.asarray(labels), c))
        got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(labels), c).numpy()
        np.testing.assert_array_equal(got, ref)


def test_plain_head_flax_tree_round_trips():
    """A flax variable tree of the JAX model with the plain head (its shapes
    from jax.eval_shape, seeded values) loads into the port's model, every
    leaf consumed and every parameter and buffer set, and comes back
    unchanged."""
    cfg, jcfg = _configs("mlp-2-xen-dp.5")
    pts = jnp.asarray(_batch(5)["points"])
    jpyr = jax_pyramid.build_pyramid(pts, jcfg.pyramid_spec())
    shapes = jax.eval_shape(
        lambda: jcfg.build_model().init(jax.random.PRNGKey(0), jnp.zeros((2, N, 3)), jpyr,
                                        train=False))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: (rng.random(s.shape) + 0.5).astype(np.float32), dict(shapes))
    assert set(tree["params"]["cls_tower"]) == {"fc0", "fc1", "bn0", "bn1"}
    assert set(tree["batch_stats"]["cls_tower"]) == {"bn0", "bn1"}
    assert "cls" in tree["params"] and "multihead" not in tree["params"]
    model = load_jax_variables(cfg.build_model(device="cpu"), tree)
    back = to_jax_variables(model)
    for coll in ("params", "batch_stats"):
        a, b = dict(_leaves(tree[coll])), dict(_leaves(back[coll]))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert set(from_jax_variables(tree)) == set(model.state_dict())


def test_main_trains_and_restores_s3dis_pt(tmp_path):
    """main.py -c s3dis_pt with a plain head of class weights and dropout:
    the step config main.py builds (JAX main.py's), its class weights those
    of the train rooms' labels, two steps, then --mode val restoring."""
    write_rooms(tmp_path / "data")
    sets = (f"data.data_root:{tmp_path / 'data'};{SMALL};arch_out:mlp-1-xen-class-w.5-dp.5;"
            "optim.batch_size:2;optim.epochs:1;data.loop:2;eval.num_votes:0.3;"
            "eval.batch_size:2;data.n_points:2048;data.voxel_max:3000;log_freq:1")
    argv = ["-c", "s3dis_pt", "--device", "cpu", "--set", sets,
            "--exp_dir", str(tmp_path / "exp")]
    built, setup = [], entry.setup

    def recording_setup(*args, **kw):
        built.append(setup(*args, **kw))
        return built[-1]

    with mock.patch.object(entry, "setup", recording_setup):
        entry.main(["--mode", "train"] + argv)
        entry.main(["--mode", "val", "--model_path", "auto", "--extra_ops", ""] + argv)
    model, _, step_cfg, *_ = built[0]
    ds = entry.build_dataset(load_config("s3dis_pt", sets), "train")
    counts = sum(np.bincount(ds.room(i)[2][ds.room(i)[2] >= 0].astype(np.int64), minlength=13)
                 for i in range(ds.num_rooms))
    assert step_cfg.class_weights == jax_inverse_frequency_weights(counts)
    assert dataclasses.astuple(step_cfg)[3:] == (-1, "xen", 0.5, step_cfg.class_weights, True)
    assert hasattr(model, "cls_drop") and not hasattr(model, "multihead")
    log = (tmp_path / "exp" / "log_train.txt").read_text()
    assert "class weights (inv-sqrt-freq)" in log and "step 2/2" in log
    assert "nan" not in log.lower()
    assert os.listdir(tmp_path / "exp" / "checkpoints")
    assert "restored step 2" in (tmp_path / "exp" / "log_val.txt").read_text()
