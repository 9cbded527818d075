"""The random sampler (ops/sampling.py::random_sample) and the RandLA-style
ConvNet+CBL preset ``s3dis_randla_cbl`` against the JAX package on the CPU,
with one torch thread, and the ConvNet's plain mlp head: the preset's
natural pyramid and the sorted layout's with the random sampler, every
index bit for bit; one train step of the preset (cut to two levels, width
12, N = 1024 on the 1/64 m grid) against JAX's make_train_step from the
same fresh weights; the plain head's eval logits and its flax tree through
the converter and back.

Tolerances: pyramid indices equal, self_rel, down_rel and up_w within 1e-6
(tests/test_torch_pt_natural.py's); the train step as
tests/test_torch_convnet_train.py holds the ConvNet's (metrics rtol 1e-4,
parameters and statistics within 1e-4 of the step's change: float32 sums in
another order); eval logits within 1e-5 of their scale.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu.train.state import create_train_state
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.models import load_jax_variables, to_jax_variables
from contrastboundary_tpu_torch.ops import pyramid as port_pyramid
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from test_torch_convnet_train import TINY, TINY2, _dist, _leaves
from test_torch_pt_natural import PYRAMID_FIELDS
from torch_parity import synthetic_crops

N = 1024


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed=5):
    pts, feats, labels = synthetic_crops(2, N, seed=seed)
    labels[:, ::97] = -1
    return {"points": pts, "features": feats, "labels": labels}


def _configs(name="s3dis_randla_cbl", sets=TINY):
    return load_config(name, sets), jax_load_config(name, sets)


def _compare_pyramids(ref, got, local_fields=()):
    for field in PYRAMID_FIELDS + local_fields:
        for level, (a, b) in enumerate(zip(getattr(ref, field), getattr(got, field))):
            if a is None:
                assert b is None, (field, level)
                continue
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f"{field}[{level}]")
    for field in ("self_rel", "down_rel", "up_w"):
        for level, (a, b) in enumerate(zip(getattr(ref, field), getattr(got, field))):
            if a is not None:
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=1e-6,
                                           err_msg=f"{field}[{level}]")


@pytest.mark.parametrize("sets", [TINY, None], ids=["tiny", "preset"])
def test_randla_pyramid_matches_jax(sets):
    """The preset's natural pyramid (random picks of each level, the radius
    searches, the contrast and sub-scene searches), cut to three levels or
    as published (five levels: the top levels' 8 and 32 points fewer than
    their caps, whose slots hold the shadow index)."""
    cfg, jcfg = _configs(sets=sets)
    spec = cfg.pyramid_spec()
    assert (spec.layout, spec.sampler) == ("natural", "random")
    pts = synthetic_crops(2, N, seed=5)[0]
    ref = jax_pyramid.build_pyramid(jnp.asarray(pts), jcfg.pyramid_spec())
    got = port_pyramid.build_pyramid(torch.from_numpy(pts), spec)
    _compare_pyramids(ref, got)


def test_sorted_pyramid_with_random_picks_matches_jax():
    """On the sorted layout the random picks are sorted by row, so that
    each level stays Morton-sorted for the window searches."""
    kw = dict(strides=(1, 4), k_self=(8, 16), k_down=(8, 16), k_contrast=(36, 24),
              with_subscene=True, sampler="random", layout="sorted")
    pts = synthetic_crops(2, N, seed=6)[0]
    ref = jax_pyramid.build_pyramid(jnp.asarray(pts), jax_pyramid.PyramidSpec(**kw))
    got = port_pyramid.build_pyramid(torch.from_numpy(pts), port_pyramid.PyramidSpec(**kw))
    _compare_pyramids(ref, got, ("down_local", "up_local", "near0_local"))
    np.testing.assert_array_equal(got.order0.numpy(), np.asarray(ref.order0))
    assert (np.diff(got.sample_idx[1].numpy(), axis=1) > 0).all()


def test_randla_train_step_matches_jax():
    batch = _batch()
    cfg, jcfg = _configs(sets=TINY2)
    model = cfg.build_model(device="cpu", generator=torch.Generator().manual_seed(3))
    assert model.simple_agg.weight_softmax == "mask"
    before = to_jax_variables(model)
    o = cfg.optim
    tx = jax_make_optimizer(o.base_lr, momentum=o.momentum, weight_decay=o.weight_decay,
                            grad_clip_norm=o.grad_clip_norm)
    jstep = jax_make_train_step(jcfg.build_model(), JaxStepConfig(
        num_classes=13, spec=jcfg.pyramid_spec(), contrast=jcfg.contrast))
    state, ref = jstep(create_train_state(before, tx),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    opt = make_optimizer(model.parameters(), o.base_lr, momentum=o.momentum,
                         weight_decay=o.weight_decay, grad_clip_norm=o.grad_clip_norm)
    step = make_train_step(model, TrainStepConfig(num_classes=13, spec=cfg.pyramid_spec(),
                                                  contrast=cfg.contrast), opt, device="cpu")
    got = step(batch)
    keys = {"ce", "cbl", "loss"} | {f"cbl_stage{i}" for i in range(2)}
    assert set(got) == keys | {"confusion"}
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["confusion"].numpy().sum(1),
                                  np.asarray(ref["confusion"]).sum(1))
    after = to_jax_variables(model)
    ref_after = {"params": jax.device_get(state.params),
                 "batch_stats": jax.device_get(state.batch_stats)}
    for coll in ("params", "batch_stats"):
        b, p, r = (dict(_leaves(t[coll])) for t in (before, after, ref_after))
        assert p.keys() == r.keys()
        keys = sorted(r)
        assert _dist(p, r, keys) <= 1e-4 * _dist(r, b, keys), coll


def test_convnet_plain_head_matches_jax_and_round_trips():
    """s3dis_conv_cbl with the plain head 'mlp-2-xen-dp.3' (1×1s seg_head and
    seg_head1, dropout, cls): a flax tree of JAX's model (its shapes from
    jax.eval_shape, seeded values) loads into the port's and comes back
    unchanged, and the two models' eval logits agree."""
    cfg, jcfg = _configs("s3dis_conv_cbl", f'{TINY};arch_out:"mlp-2-xen-dp.3"')
    batch = _batch(7)
    jpyr = jax_pyramid.build_pyramid(jnp.asarray(batch["points"]), jcfg.pyramid_spec())
    jmodel = jcfg.build_model()
    feats = jnp.asarray(batch["features"])
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), feats, jpyr,
                                                train=False))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda s: (0.5 * rng.standard_normal(s.shape)).astype(np.float32), dict(shapes))
    tree["batch_stats"] = jax.tree_util.tree_map(
        lambda v: np.abs(v) + np.float32(0.5), tree["batch_stats"])
    assert {"seg_head_fc", "seg_head_bn", "seg_head1_fc", "seg_head1_bn", "cls"} <= \
        set(tree["params"])
    model = load_jax_variables(cfg.build_model(device="cpu"), tree)
    back = to_jax_variables(model)
    for coll in ("params", "batch_stats"):
        a, b = dict(_leaves(tree[coll])), dict(_leaves(back[coll]))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ref = np.asarray(jax.jit(lambda v: jmodel.apply(v, feats, jpyr, train=False).logits)(tree))
    pyr = port_pyramid.build_pyramid(torch.from_numpy(batch["points"]), cfg.pyramid_spec())
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(batch["features"]), pyr).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
