"""The point transformer on the natural layout against the JAX package on
the CPU, with one torch thread: the natural pyramid with the bucket_fps,
fps and serialized samplers (with the contrast and sub-scene searches) and
the sorted layout with fps and bucket_fps against JAX's build_pyramid; the
model at synthetic_tiny widths under batch and stale BN; the eval step
against JAX's make_eval_step under both (the train step is in
tests/test_torch_pt_natural_train.py); each newly built preset's
PyramidSpec and model; and ``main.py -c synthetic_tiny --mode
train|val``.

Crops on the 1/64 m grid (tests/torch_parity.py), so every squared
distance is exact in float32 and the samplers and searches break ties
alike: N = 1024 for the pyramids, 2048 for the model and the steps. With
strides (1, 4, 4, 4, 4) the top level then has 4 or 8 points and a self
search of k = 16: its slots beyond them hold the shadow index, which the
reference's gathers read clamped to the last row and whose cotangent
their transpose drops, the port's too (core/gather.py::clamped_gather).

Tolerances:
- pyramid: every index equal; self_rel, down_rel and up_w within 1e-6;
- model: eval logits within 1e-5 of their scale under both BN modes;
- model in train mode: logits within 1e-5 of scale, and the updated
  running statistics within 2e-5 of their change
  (tests/test_torch_train.py's STEP_RTOL), or, whichever is larger, within
  twice JAX's own distance from itself when the batch's two clouds are
  swapped, which leaves both the same in exact arithmetic. The natural
  pyramid's top levels are tiny (8 and 32 points a cloud, so BN statistics
  over 16 and 64 rows), and their fast variance amplifies float32 sum
  order: under that swap JAX's batch-BN train logits move by 4.9e-5 of
  scale, its stale-BN statistics by 3.4e-5 of their change (at N = 1024,
  by 1.5e-3 of scale and its first update by 3.13 of a change of 20.18);
- eval step: probs within 1e-5 of scale, the confusion's rows equal.
"""
import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import contrastboundary_tpu_torch.main as entry
from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu.train.state import create_train_state
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_eval_step as jax_make_eval_step
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.core.gather import clamped_gather
from contrastboundary_tpu_torch.eval.step import make_eval_step
from contrastboundary_tpu_torch.models import (
    PointTransformerSeg, load_jax_variables, to_jax_variables,
)
from contrastboundary_tpu_torch.ops import pyramid as port_pyramid
from test_torch_train import STEP_RTOL, _dist, _leaves, _perturbed
from torch_parity import synthetic_crops

N = 1024
SPEC = dict(k_contrast=(36, 24, 24, 24, 24), with_subscene=True)
PYRAMID_FIELDS = ("sample_idx", "self_idx", "down_idx", "up_idx", "near0_idx", "contrast_idx",
                  "subscene_idx")
# the model's and the train step's crops: the top level has 8 points
MODEL_N = 2048
PRESETS = ("s3dis_pt_cbl_paper", "scannet_pt_cbl", "synthetic_tiny", "synthetic_full", "default")


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed, n=N):
    pts, feats, labels = synthetic_crops(2, n, seed=seed)
    labels[:, ::97] = -1
    return {"points": pts, "features": feats, "labels": labels}


def _configs(bn_mode="batch", sets=""):
    sets = f"model.bn_mode:{bn_mode}{sets}"
    return load_config("synthetic_tiny", sets), jax_load_config("synthetic_tiny", sets)


def _close(got, ref, tol, what=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= tol * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _np(x):
    return None if x is None else np.asarray(x)


@pytest.mark.parametrize("layout,sampler,buckets", [
    ("natural", "bucket_fps", 64), ("natural", "bucket_fps", 8), ("natural", "fps", 64),
    ("natural", "serialized", 64), ("natural", "strided", 64), ("sorted", "fps", 64),
    ("sorted", "bucket_fps", 8),
])
def test_pyramid_matches_jax(layout, sampler, buckets):
    strides = (1, 4, 4, 4, 4) if layout == "natural" else (1, 4)  # sorted: 256 | N_l
    kw = dict(SPEC, sampler=sampler, num_buckets=buckets, layout=layout, strides=strides,
              k_self=(8, 16, 16, 16, 16)[:len(strides)], k_down=(8, 16, 16, 16, 16)[:len(strides)],
              k_contrast=SPEC["k_contrast"][:len(strides)])
    pts = synthetic_crops(2, N, seed=5)[0]
    ref = jax_pyramid.build_pyramid(jnp.asarray(pts), jax_pyramid.PyramidSpec(**kw))
    got = port_pyramid.build_pyramid(torch.from_numpy(pts), port_pyramid.PyramidSpec(**kw))
    fields = PYRAMID_FIELDS + (("order0", "down_local", "up_local", "near0_local", "self_local")
                               if layout == "sorted" else ())
    for field in fields:
        r, g = getattr(ref, field), getattr(got, field)
        if field in ("order0", "self_local"):
            r, g = (r,), (g,)
        for level, (a, b) in enumerate(zip(r, g)):
            if a is None:
                assert b is None, (field, level)
            elif isinstance(a, tuple):
                assert a == b, (field, level)
            else:
                np.testing.assert_array_equal(_np(b), _np(a), err_msg=f"{field}[{level}]")
    for field in ("self_rel", "down_rel", "up_w"):
        for level, (a, b) in enumerate(zip(getattr(ref, field), getattr(got, field))):
            if a is None:
                assert b is None, (field, level)
                continue
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6,
                                       err_msg=f"{field}[{level}]")
    if layout == "natural":
        assert got.order0 is None and (got.self_idx[4] == got.points[4].shape[1]).any()


@pytest.fixture(scope="module")
def data():
    batch = _batch(5, MODEL_N)
    cfg, jcfg = _configs()
    jpyr = jax_pyramid.build_pyramid(jnp.asarray(batch["points"]), jcfg.pyramid_spec())
    tpyr = port_pyramid.build_pyramid(torch.from_numpy(batch["points"]), cfg.pyramid_spec())
    return batch, jpyr, tpyr


def compile_in_threads(lowered: dict) -> dict:
    """Compile JAX's lowered functions in parallel threads (XLA compiles
    each on one core) → {name: executable}."""
    with ThreadPoolExecutor(len(lowered)) as pool:
        return dict(zip(lowered, pool.map(lambda low: low.compile(), lowered.values())))


def _swapped(batch):
    return {k: np.ascontiguousarray(v[::-1]) for k, v in batch.items()}


def _stats_dist(a, b):
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert a.keys() == b.keys()
    return _dist([a[k] for k in sorted(a)], [b[k] for k in sorted(a)])


@pytest.fixture(scope="module")
def models(data):
    """For each BN mode: a flax tree (the port's fresh weights moved by
    seeded noise, away from ReLU kinks), JAX's eval logits, train logits
    and updated statistics from it (one compiled function a mode, the two
    compiled in parallel threads), and JAX's own distances when the
    batch's two clouds are swapped (train logits, max abs; statistics,
    L2)."""
    batch, jpyr, _ = data
    swapped = _swapped(batch)
    jpyr_swapped = jax_pyramid.build_pyramid(jnp.asarray(swapped["points"]),
                                             _configs()[1].pyramid_spec())
    feats, swapped_feats = jnp.asarray(batch["features"]), jnp.asarray(swapped["features"])
    lowered, variables = {}, {}
    for mode in ("batch", "stale"):
        cfg, jcfg = _configs(mode)
        jm = jcfg.build_model()
        variables[mode] = _perturbed(
            to_jax_variables(cfg.build_model(device="cpu",
                                             generator=torch.Generator().manual_seed(1))),
            np.random.RandomState(7))

        def both(v, f, p, jm=jm):
            train, mut = jm.apply(v, f, p, train=True, mutable=["batch_stats"])
            return jm.apply(v, f, p, train=False).logits, train.logits, mut["batch_stats"]

        lowered[mode] = jax.jit(both).lower(variables[mode], feats, jpyr)
    out = {}
    for mode, exe in compile_in_threads(lowered).items():
        ref = jax.device_get(exe(variables[mode], feats, jpyr))
        swap = jax.device_get(exe(variables[mode], swapped_feats, jpyr_swapped))
        noise = (float(np.abs(swap[1][::-1] - ref[1]).max()), _stats_dist(swap[2], ref[2]))
        out[mode] = (variables[mode],) + ref + noise
    return out


@pytest.mark.parametrize("mode", ["batch", "stale"])
@pytest.mark.parametrize("phase", ["eval", "train"])
def test_model_matches_jax(data, models, mode, phase):
    batch, _, tpyr = data
    variables, ref_eval, ref_train, ref_stats, logit_noise, stats_noise = models[mode]
    cfg, _ = _configs(mode)
    model = load_jax_variables(cfg.build_model(device="cpu"), variables)
    feats = torch.from_numpy(batch["features"])
    if phase == "eval":
        with torch.no_grad():
            _close(model.eval()(feats, tpyr).numpy(), ref_eval, 1e-5, "eval logits")
        return
    out = model.train()(feats, tpyr)
    err = np.abs(out.logits.detach().numpy() - ref_train).max()
    assert err <= max(1e-5 * np.abs(ref_train).max(), 2 * logit_noise), (err, logit_noise)
    stats = to_jax_variables(model)["batch_stats"]
    change = _stats_dist(ref_stats, variables["batch_stats"])
    assert _stats_dist(stats, ref_stats) <= max(STEP_RTOL["batch_stats"] * change,
                                                2 * stats_noise), (change, stats_noise)


def test_stale_model_runs_the_unfused_layer(data, monkeypatch):
    """The reference runs its fused attention only with window-relative
    indices; on the natural layout the stale layer is the unfused one."""
    from contrastboundary_tpu_torch.models import blocks

    def refuse(*a, **k):
        raise AssertionError("the fused attention ran on the natural layout")

    monkeypatch.setattr(blocks, "pt_attn", refuse)
    batch, _, tpyr = data
    model = _configs("stale")[0].build_model(device="cpu")
    assert type(model.enc1_blk1.transformer2.w_bn1).__name__ == "StaleBatchNorm"
    model.train()(torch.from_numpy(batch["features"]), tpyr).logits.sum().backward()


def test_shadow_slots_read_the_last_row_and_drop_its_cotangent():
    """core/gather.py::clamped_gather against JAX's x[idx] at the shadow
    index: the value of row N − 1, no cotangent."""
    x = np.arange(8, dtype=np.float32).reshape(1, 4, 2)
    idx = np.array([[[0, 3], [4, 4]]])
    w = np.arange(1, 9, dtype=np.float32).reshape(1, 2, 2, 2)

    def f(xx):
        return jnp.sum(jax.vmap(lambda xb, ib: xb[ib])(xx, jnp.asarray(idx)) * w)

    tx = torch.from_numpy(x).requires_grad_(True)
    out = clamped_gather(tx, torch.from_numpy(idx))
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  np.asarray(jax.vmap(lambda xb, ib: xb[ib])(x, idx)))
    np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(jax.grad(f)(jnp.asarray(x))))
    assert tx.grad[0, 3].tolist() == [3.0, 4.0]  # the in-range slot's cotangent only


@pytest.fixture(scope="module")
def eval_reference():
    """A batch, perturbed fresh weights, and JAX's batch-BN eval step on
    them: eval-mode BN is the same function under both BN modes."""
    batch = _batch(7)
    cfg, jcfg = _configs()
    variables = _perturbed(to_jax_variables(cfg.build_model(
        device="cpu", generator=torch.Generator().manual_seed(4))), np.random.RandomState(5))
    jstep = jax_make_eval_step(jcfg.build_model(), JaxStepConfig(
        num_classes=13, spec=jcfg.pyramid_spec(), contrast=jcfg.contrast))
    probs, conf = jstep(create_train_state(variables, jax_make_optimizer(0.05)),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    return batch, variables, np.asarray(probs), np.asarray(conf)


@pytest.mark.parametrize("mode", ["batch", "stale"])
def test_eval_step_matches_jax(eval_reference, mode):
    batch, variables, ref, ref_conf = eval_reference
    cfg, _ = _configs(mode)
    model = load_jax_variables(cfg.build_model(device="cpu"), variables)
    probs, conf = make_eval_step(model, cfg.pyramid_spec(), device="cpu")(batch)
    _close(probs.numpy(), ref, 1e-5, "probs")
    np.testing.assert_array_equal(conf.numpy().sum(1), ref_conf.sum(1))


@pytest.mark.parametrize("name", PRESETS)
def test_preset_builds_its_model_and_spec_as_jax(name):
    cfg, jcfg = load_config(name), jax_load_config(name)
    spec, ref = cfg.pyramid_spec(), jcfg.pyramid_spec()
    assert (spec.layout, spec.sampler, spec.num_buckets) == ("natural", "bucket_fps", 64)
    for f in dataclasses.fields(spec):
        assert getattr(spec, f.name) == getattr(ref, f.name), f.name
    model = cfg.build_model(device="cpu")
    m = cfg.model
    assert isinstance(model, PointTransformerSeg)
    assert (model.planes, model.blocks) == (tuple(m.planes), tuple(m.blocks))
    assert model.multihead.cls.out_features == cfg.data.num_classes
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.build_model()  # the card by default, and this CPU has none


def test_main_trains_and_restores_synthetic_tiny(tmp_path):
    sets = ("data.num_rooms:2;data.points_per_room:3000;data.n_points:1024;"
            "data.voxel_max:3000;data.loop:1;optim.batch_size:1;optim.epochs:1;"
            "eval.batch_size:2;eval.num_votes:0.3;log_freq:1")
    argv = ["-c", "synthetic_tiny", "--device", "cpu", "--set", sets,
            "--exp_dir", str(tmp_path / "exp")]
    entry.main(["--mode", "train"] + argv)
    log = (tmp_path / "exp" / "log_train.txt").read_text()
    assert "model pointtransformer" in log and "step 2/2" in log and "nan" not in log.lower()
    assert os.listdir(tmp_path / "exp" / "checkpoints")
    entry.main(["--mode", "val", "--model_path", "auto"] + argv)
    assert "restored step 2" in (tmp_path / "exp" / "log_val.txt").read_text()
