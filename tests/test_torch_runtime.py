"""The port's training runtime against the JAX package's on the CPU: the
schedules and optimizers against optax, the checkpoint manager, the NaN
sentinel's report and dump, the scalar files, the Trainer, and the fresh
weights against flax's lecun_normal.

Tolerances:
- schedules: equal in float32 at every step from 0 to 3·steps_per_epoch;
- optimizers (sgd, adam, adamw, each with and without grad_clip_norm,
  three updates under a schedule that changes after the first): every
  parameter within 1e-6 of the tree's scale (max |port − optax| ≤ 1e-6·max
  |optax| over all leaves), the same function rounded in another order.
  optax computes Adam's bias correction 1 − β₂ᵗ in float32 (t = 3: 0.002997
  from 0.997003, whose ulp is 6e-8), which puts its own update ~1e-5 of an
  update from the exact one (1.37e-6 after three at lr 0.1); torch takes
  it in double. So the Adam cases also hold the port within 4e-7 of the
  updates computed in float64 (0.9e-7 to 2.3e-7 measured);
- checkpoints: restored parameters, statistics, optimizer state and step
  bit for bit; select/except_ patterns take exactly the leaves that the
  JAX manager's rule takes of the same flax names;
- fresh weights: sample std within 2% of flax's lecun_normal draw of the
  same shape and of √(1/fan_in), |w| ≤ 2σ, biases exactly 0.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from flax.linen import initializers as flax_init

from contrastboundary_tpu.eval.metrics import AverageMeter as JaxMeter
from contrastboundary_tpu.train import debug as jax_debug
from contrastboundary_tpu.train.schedule import exponential_epoch_decay as jax_exponential
from contrastboundary_tpu.train.schedule import multistep_epoch_decay as jax_multistep
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.utils import scalars as jax_scalars
from contrastboundary_tpu_torch.eval.metrics import AverageMeter
from contrastboundary_tpu_torch.models import PointTransformerSeg, init_like_flax, to_jax_variables
from contrastboundary_tpu_torch.models.init import TRUNC_STD
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec
from contrastboundary_tpu_torch.train import (
    CheckpointManager, Trainer, TrainStepConfig, dump_nan_state, exponential_epoch_decay,
    find_best_snapshot, make_optimizer, make_train_step, multistep_epoch_decay, nan_report,
    set_learning_rate, tree_finite,
)
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.utils import ScalarWriter, StepTimer, memory_stats, read_scalars

SPEC = PyramidSpec(strides=(1, 4, 4), k_self=(8, 8, 8), k_down=(8, 8, 8), k_contrast=(12, 8, 8),
                   with_subscene=True)


def small_model(seed=0):
    return PointTransformerSeg(planes=(16, 32, 64), blocks=(1, 1, 1),
                               generator=torch.Generator().manual_seed(seed))


def small_batch(seed=0, n=512, b=1):
    rng = np.random.default_rng(seed)
    return {"points": np.round(rng.random((b, n, 3)) * 64).astype(np.float32) / 64,
            "features": rng.random((b, n, 3)).astype(np.float32),
            "labels": rng.integers(0, 13, (b, n)).astype(np.int32)}


# ---------------------------------------------------------------- schedules

SCHEDULES = [
    ("multistep", (0.5, [1.2, 2.0], 0.1, 7)),
    ("multistep", (0.1, [0.6 * 3, 0.8 * 3], 0.5, 5)),
    ("exponential", (0.02, 0.9885531, 7, 0.0)),
    ("exponential", (0.5, 0.5, 3, 0.1)),
    ("exponential", (0.1, 1.1, 4, 0.12)),
]


@pytest.mark.parametrize("kind,args", SCHEDULES)
def test_schedule_matches_optax(kind, args):
    ref = (jax_multistep if kind == "multistep" else jax_exponential)(*args)
    ours = (multistep_epoch_decay if kind == "multistep" else exponential_epoch_decay)(*args)
    spe = args[-1] if kind == "multistep" else args[2]
    for step in range(3 * spe + 1):
        assert np.float32(ours(step)) == np.float32(ref(step)), step
        # and as optax's scale_by_learning_rate evaluates it, on an int32 count
        assert np.float32(ours(step)) == np.float32(jax.jit(ref)(jnp.int32(step))), step


# --------------------------------------------------------------- optimizers

def _updates(optimizer, clip, seed=1):
    rng = np.random.RandomState(seed)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (2.0 * rng.randn(*s)).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    args = (0.1, [1], 0.5, 1)  # lr 0.1 for the first update, 0.05 after
    tx = jax_make_optimizer(jax_multistep(*args), optimizer=optimizer, momentum=0.9,
                            weight_decay=1e-2, grad_clip_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.as_tensor(v.copy())) for k, v in params.items()}
    schedule = multistep_epoch_decay(*args)
    opt = make_optimizer(tparams.values(), schedule, optimizer=optimizer, momentum=0.9,
                         weight_decay=1e-2, grad_clip_norm=clip)
    out = []
    for t, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.as_tensor(g[k].copy())
        assert set_learning_rate(opt, schedule, t) == schedule(t)
        opt.step()
        out.append(({k: np.asarray(v) for k, v in jparams.items()},
                    {k: p.detach().numpy().copy() for k, p in tparams.items()}))
    return out, grads


@pytest.mark.parametrize("clip", [None, 1.0])
@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
def test_optimizer_matches_optax(optimizer, clip):
    out, grads = _updates(optimizer, clip)
    if clip is not None:  # the clip acts on every update
        assert all(np.sqrt(sum((v ** 2).sum() for v in g.values())) > clip for g in grads)
    for t, (ref, got) in enumerate(out):
        scale = max(np.abs(v).max() for v in ref.values())
        for k in ref:
            d = np.abs(got[k] - ref[k]).max()
            assert d <= 1e-6 * scale, (optimizer, clip, t, k, d)
    if optimizer != "sgd":
        exact = _exact_adam(optimizer, clip, grads)
        for k, v in out[-1][1].items():
            assert np.abs(v - exact[k]).max() <= 4e-7, (k, np.abs(v - exact[k]).max())


def _exact_adam(optimizer, clip, grads):
    """The parameters after ``_updates``' three Adam(W) updates in float64."""
    rng = np.random.RandomState(1)
    p = {k: rng.randn(*s).astype(np.float32).astype(np.float64)
         for k, s in {"a": (4, 3), "b": (7,), "c": (2, 5)}.items()}
    m = {k: np.zeros_like(v) for k, v in p.items()}
    v2 = {k: np.zeros_like(v) for k, v in p.items()}
    for t, g in enumerate(grads):
        g = {k: x.astype(np.float64) for k, x in g.items()}
        norm = np.sqrt(sum((x ** 2).sum() for x in g.values()))
        if clip is not None and norm >= clip:
            g = {k: x / norm * clip for k, x in g.items()}
        lr = 0.1 if t == 0 else 0.05
        for k in p:
            m[k] = 0.9 * m[k] + 0.1 * g[k]
            v2[k] = 0.999 * v2[k] + 0.001 * g[k] ** 2
            upd = (m[k] / (1 - 0.9 ** (t + 1))) / (np.sqrt(v2[k] / (1 - 0.999 ** (t + 1))) + 1e-8)
            if optimizer == "adamw":
                upd = upd + 1e-2 * p[k]
            p[k] = p[k] - lr * upd
    return p


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="lamb"):
        make_optimizer([torch.nn.Parameter(torch.zeros(2))], 0.1, optimizer="lamb")


# ---------------------------------------------------------------- checkpoints

def _trained(seed=0, steps=2, optimizer="sgd"):
    model = small_model(seed)
    opt = make_optimizer(model.parameters(), 0.05, optimizer=optimizer)
    step = make_train_step(model, TrainStepConfig(num_classes=13, spec=SPEC,
                                                  contrast=ContrastConfig()), opt, device="cpu")
    for s in range(steps):
        step(small_batch(s))
    return model, opt


def _state(model, opt):
    return ({k: v.clone() for k, v in model.state_dict().items()},
            {i: {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
             for i, s in opt.state_dict()["state"].items()})


def _assert_state_equal(a, b):
    assert a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for i in a[1]:
        assert a[1][i].keys() == b[1][i].keys()
        for k in a[1][i]:
            assert torch.equal(torch.as_tensor(a[1][i][k]), torch.as_tensor(b[1][i][k])), (i, k)


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_checkpoint_round_trip_is_exact(tmp_path, optimizer):
    model, opt = _trained(optimizer=optimizer)
    saved = _state(model, opt)
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    path = ckpt.save(2, model, opt, best=True, metric=0.25)
    assert os.path.basename(path) == "snap-2" and ckpt.steps() == [2]
    fresh = small_model(seed=9)
    fresh_opt = make_optimizer(fresh.parameters(), 0.05, optimizer=optimizer)
    step, skipped = ckpt.restore(fresh, fresh_opt)
    assert step == 2 and skipped == []
    _assert_state_equal(_state(fresh, fresh_opt), saved)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert payload["step"] == 2 and all(v.device.type == "cpu" for v in payload["model"].values())


def test_checkpoint_gc_best_and_resolve(tmp_path):
    model, opt = _trained(steps=1)
    ckpt = CheckpointManager(str(tmp_path / "Log_a" / "checkpoints"), max_to_keep=2)
    for s, miou in ((1, 0.1), (2, 0.4), (3, 0.2), (4, 0.3)):
        ckpt.save(s, model, opt, best=miou == 0.4, metric=miou)
    assert ckpt.steps() == [2, 3, 4]  # the best survives garbage collection
    assert ckpt.best_step() == 2
    with open(tmp_path / "Log_a" / "checkpoints" / "best.json") as f:
        assert json.load(f) == {"step": 2, "mIoU": 0.4}
    assert ckpt.resolve("best").endswith("snap-2") and ckpt.resolve("auto").endswith("snap-4")
    assert ckpt.resolve("latest") == ckpt.resolve("") == ckpt.resolve("auto")
    assert ckpt.resolve(str(tmp_path / "nowhere")) is None
    other = CheckpointManager(str(tmp_path / "Log_b" / "checkpoints"))
    other.save(7, model, opt, best=True, metric=0.6)
    hit = find_best_snapshot(str(tmp_path))
    assert hit["step"] == 7 and hit["mIoU"] == 0.6 and hit["run"].endswith("Log_b")
    assert find_best_snapshot(str(tmp_path / "Log_a"))["step"] == 2
    assert find_best_snapshot(str(tmp_path / "empty")) is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "none")).restore(model, opt)


def test_checkpoint_refuses_non_finite_and_orbax(tmp_path):
    model, opt = _trained(steps=1)
    ckpt = CheckpointManager(str(tmp_path))
    with torch.no_grad():
        model.enc0_down.Dense_0.weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="snap-5"):
        ckpt.save(5, model, opt)
    assert ckpt.steps() == []
    os.makedirs(tmp_path / "snap-3" / "params")  # an orbax snapshot directory
    with pytest.raises(NotImplementedError, match="orbax"):
        ckpt.restore(model, opt)


def _jax_names(model):
    """The leaf names the JAX manager matches its patterns against, for the
    step, the parameters and the statistics (its own flattening)."""
    tree = to_jax_variables(model)
    template = {"step": np.int32(0), "params": tree["params"], "batch_stats": tree["batch_stats"]}
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(template)[0]]


@pytest.mark.parametrize("select,except_", [
    (["^params/"], None),
    (["enc0", "dec0"], [r"batch_stats/"]),
    (None, [r"multihead/cls", "step"]),
    (["Dense_0/kernel"], None),
])
def test_partial_restore_uses_flax_names(tmp_path, select, except_):
    import re

    model, opt = _trained()
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(2, model, opt)
    saved = _state(model, opt)
    target = small_model(seed=3)
    target_opt = make_optimizer(target.parameters(), 0.05)
    make_train_step(target, TrainStepConfig(num_classes=13, spec=SPEC, contrast=ContrastConfig()),
                    target_opt, device="cpu")(small_batch(7))
    before = _state(target, target_opt)
    step, skipped = ckpt.restore(target, target_opt, select=select, except_=except_)

    # the JAX manager's rule on the same names
    sel = [re.compile(p) for p in (select or [".*"])]
    exc = [re.compile(p) for p in (except_ or [])]
    jax_taken = {n for n in _jax_names(model)
                 if any(p.search(n) for p in sel) and not any(p.search(n) for p in exc)}
    names = {k: "/".join(n) for k, n in
             ((k, __import__("contrastboundary_tpu_torch.models", fromlist=["flax_path"])
               .flax_path(model, k)) for k in model.state_dict())}
    assert set(names.values()) | {"step"} == set(_jax_names(model))
    taken = {n for n in list(names.values()) + ["step"] if n not in skipped}
    assert taken == jax_taken
    assert (step == 2) == ("step" in jax_taken)
    after = _state(target, target_opt)
    for k, n in names.items():
        src = saved if n in jax_taken else before
        assert torch.equal(after[0][k], src[0][k]), k
    # optimizer state: 'opt_state/<key>/<module path>/<leaf>'
    opt_names = [n for n in skipped if n.startswith("opt_state/")]
    assert all(n.startswith("opt_state/momentum_buffer/") for n in opt_names)
    if select == ["^params/"]:
        assert len(opt_names) == len(list(model.parameters()))


# ---------------------------------------------------------------- NaN sentinel

def test_nan_report_matches_jax_and_dump(tmp_path):
    model = small_model()
    with torch.no_grad():
        model.enc1_down.Dense_0.weight[:2] = float("nan")
        model.enc0_down.BatchNorm_0.running_var[0] = float("inf")
    tree = to_jax_variables(model)
    for coll in ("params", "batch_stats"):
        assert nan_report(tree[coll], coll + "/") == jax_debug.nan_report(tree[coll], coll + "/")
    assert not tree_finite(model.state_dict().values())
    assert tree_finite([torch.zeros(3), torch.arange(3)])
    batch = small_batch()
    batch["features"][0, :4] = np.nan
    metrics = {"loss": torch.tensor(float("nan")), "confusion": torch.zeros(13, 13)}
    path = dump_nan_state(str(tmp_path), model, 5, batch, metrics, logger=None)
    with open(path, "rb") as f:
        dump = pickle.load(f)
    assert dump["step"] == 5 and sorted(dump) == ["batch", "params", "report", "step"]
    assert dump["report"]["params/enc1_down/Dense_0/kernel"] == pytest.approx(2 / 32)
    assert dump["report"]["batch_stats/enc0_down/BatchNorm_0/var"] == pytest.approx(1 / 16)
    assert dump["report"]["batch/features"] == pytest.approx(4 * 3 / (512 * 3))
    assert np.isnan(dump["report"]["metric/loss"]) and "metric/confusion" not in dump["report"]
    np.testing.assert_array_equal(dump["batch"]["features"], batch["features"])
    np.testing.assert_array_equal(dump["params"]["enc1_down"]["Dense_0"]["kernel"],
                                  tree["params"]["enc1_down"]["Dense_0"]["kernel"])


# ------------------------------------------------------------- scalars, utils

def test_scalar_files_read_across_packages(tmp_path):
    rows = [(1, {"train/loss": 2.5, "train/ce": float("nan")}),
            (2, {"train/loss": 1.25, "val/mIoU": float("inf")})]
    for writer, reader in ((ScalarWriter, jax_scalars.read_scalars),
                           (jax_scalars.ScalarWriter, read_scalars)):
        d = tmp_path / writer.__module__.split(".")[0]
        with writer(str(d)) as w:
            for step, vals in rows:
                w.write(step, vals)
        with open(d / "scalars.jsonl", "a") as f:
            f.write('{"step": 3, "train/lo')  # a killed run's truncated line
        got = reader(str(d / "scalars.jsonl"))
        assert got["train/loss"] == ([1, 2], [2.5, 1.25])
        assert got["train/ce"][0] == [1] and np.isnan(got["train/ce"][1][0])
        assert got["val/mIoU"] == ([2], [float("inf")])
    path = str(tmp_path / "contrastboundary_tpu_torch" / "scalars.jsonl")
    assert repr(read_scalars(path)) == repr(jax_scalars.read_scalars(path))  # nan != nan


def test_average_meter_step_timer_and_memory_stats():
    ours, ref = AverageMeter(), JaxMeter()
    for v, n in ((1.0, 1), (2.5, 3), (-0.5, 2)):
        ours.update(v, n)
        ref.update(v, n)
    assert (ours.val, ours.sum, ours.count, ours.avg) == (ref.val, ref.sum, ref.count, ref.avg)
    timer = StepTimer()
    for _ in range(2):
        timer.data_ready()
        timer.step_done()
    assert timer.count == 2 and set(timer.summary()) == {"data_ms", "step_ms"}
    assert memory_stats()["host_rss_mb"] > 0


# ------------------------------------------------------------------ trainer

def test_trainer_sets_the_schedule_and_reports_an_epoch():
    model = small_model()
    seen = []

    def schedule(count):
        seen.append(count)
        return 0.05 / (1 + count)

    opt = make_optimizer(model.parameters(), schedule)
    trainer = Trainer(model, opt, TrainStepConfig(num_classes=13, spec=SPEC,
                                                  contrast=ContrastConfig()),
                      schedule=schedule, device="cpu", log_fn=lambda *_: None, step=3)
    out = trainer.train_epoch([small_batch(s) for s in range(2)], log_freq=1)
    assert seen == [0, 3, 4] and trainer.step == 5  # make_optimizer reads step 0's rate
    assert opt.param_groups[0]["lr"] == 0.05 / 5
    assert {"ce", "cbl", "loss", "mIoU", "OA", "mACC", "steps_per_sec"} <= set(out)
    assert np.isfinite(out["loss"])


def test_train_step_after_an_eval_step_trains_with_batch_statistics():
    """An eval step on the same model (as the epoch-end eval runs) leaves
    the next train step in train mode: its metrics equal those of a train
    step on a copy that never evaluated."""
    a, b = small_model(), small_model()
    cfg = TrainStepConfig(num_classes=13, spec=SPEC, contrast=ContrastConfig())
    step_a = make_train_step(a, cfg, make_optimizer(a.parameters(), 0.05), device="cpu")
    step_b = make_train_step(b, cfg, make_optimizer(b.parameters(), 0.05), device="cpu")
    make_eval_step(a, SPEC, device="cpu")(small_batch(1))
    assert not a.training
    ma, mb = step_a(small_batch(2)), step_b(small_batch(2))
    assert a.training
    assert float(ma["loss"]) == float(mb["loss"])


# ------------------------------------------------------------------- init

@pytest.mark.parametrize("fan_in,fan_out", [(256, 256), (32, 512)])
def test_fresh_weights_match_flax_lecun_normal(fan_in, fan_out):
    ref = np.asarray(flax_init.lecun_normal()(jax.random.PRNGKey(0), (fan_in, fan_out)))
    layer = torch.nn.Linear(fan_in, fan_out)
    init_like_flax(layer, torch.Generator().manual_seed(0))
    w = layer.weight.detach().numpy()
    sigma = np.sqrt(1.0 / fan_in) / TRUNC_STD
    assert w.shape == (fan_out, fan_in) and w.dtype == np.float32
    assert abs(w.std() / ref.std() - 1) <= 0.02, (w.std(), ref.std())
    assert abs(w.std() * np.sqrt(fan_in) - 1) <= 0.02
    assert np.abs(w).max() <= 2 * sigma * (1 + 1e-6) and np.abs(ref).max() <= 2 * sigma * (1 + 1e-6)
    assert abs(w.mean()) <= 3 * w.std() / np.sqrt(w.size)
    assert not layer.bias.detach().any()


def test_fresh_model_is_initialized_like_flax():
    model = small_model(seed=4)
    linears = [m for m in model.modules() if isinstance(m, torch.nn.Linear)]
    assert linears
    for m in linears:
        sigma = np.sqrt(1.0 / m.in_features) / TRUNC_STD
        assert float(m.weight.detach().abs().max()) <= 2 * sigma * (1 + 1e-6)
        assert m.bias is None or not m.bias.detach().any()
    for name, p in model.named_parameters():
        if "bn" in name.lower() or "BatchNorm" in name:
            assert torch.all(p == (1.0 if name.endswith("weight") else 0.0)), name
    again = small_model(seed=4)
    for (k, v), (_, w) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(v, w), k
    assert not torch.equal(small_model(seed=5).enc0_down.Dense_0.weight,
                           model.enc0_down.Dense_0.weight)
