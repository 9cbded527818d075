"""Training and serving the port's ConvNet family on the CPU against the
JAX package, with one torch thread: the global CBL route and the kl
positives, one ConvNet+CBL train step (cnt and kl) against JAX's
make_train_step, the eval step, every ConvNet preset's model and pyramid
spec, the evaluators over a ConvNet, and ``main.py -c synthetic_conv_tiny
--mode train|val``.

Tolerances:
- CBL stages 0 and 2 (the natural layout's global route, cnt and kl; the
  kl positives on the sorted layout's tile route) within 1e-5 of the loss,
  their feature gradients within 1e-4 of scale;
- the train step from one state (the port's fresh weights in both): ce,
  cbl, each stage's CBL and the loss within rtol 1e-4; the distance of the
  updated parameters and statistics to JAX's within 1e-4 of the step's
  change (float32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.losses import contrast as jax_contrast
from contrastboundary_tpu.train.state import create_train_state
from contrastboundary_tpu.train.state import make_optimizer as jax_make_optimizer
from contrastboundary_tpu.train.trainer import TrainStepConfig as JaxStepConfig
from contrastboundary_tpu.train.trainer import make_train_step as jax_make_train_step
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.losses import contrast
from contrastboundary_tpu_torch.models import to_jax_variables
from contrastboundary_tpu_torch.ops import pyramid as port_pyramid
from contrastboundary_tpu_torch.train import TrainStepConfig, make_optimizer, make_train_step
from torch_parity import synthetic_crops

CNT = "multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1"
KL = "multi-Ua-concat-latent|contrast-Ua-softnn-latent-labelkl.5-l2-w.1"
# s3dis_conv_cbl cut to 3 (and 2) levels, width 12, N = 1024
TINY = ("model.strides:[1,4,4];model.base_fdim:12;model.neighborhood_limits:[16,20,24];"
        "model.contrast_nsample:[12,8,8]")
TINY2 = ("model.strides:[1,4];model.base_fdim:12;model.neighborhood_limits:[16,20];"
         "model.contrast_nsample:[12,8]")


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _batch(seed=5):
    pts, feats, labels = synthetic_crops(2, 1024, seed=seed)
    labels[:, ::97] = -1
    return {"points": pts, "features": feats, "labels": labels}


def _configs(arch_out, tiny=TINY):
    sets = f'{tiny};arch_out:"{arch_out}"'
    return load_config("s3dis_conv_cbl", sets), jax_load_config("s3dis_conv_cbl", sets)


def _close(got, ref, rtol, what=""):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref).max()
    assert err <= rtol * np.abs(ref).max(), (what, err, np.abs(ref).max())


@pytest.mark.parametrize("layout,arch_out", [("natural", CNT), ("natural", KL),
                                             ("sorted", KL)])
def test_cbl_stages_match_jax(layout, arch_out):
    batch = _batch(6)
    cfg, jcfg = _configs(arch_out)
    c, jc = cfg.contrast, jcfg.contrast
    assert (c.pos, c.kl_threshold) == (jc.pos, jc.kl_threshold)
    pts = torch.from_numpy(batch["points"])
    labels = torch.from_numpy(batch["labels"])
    if layout == "natural":
        spec = cfg.pyramid_spec()
    else:
        spec = port_pyramid.PyramidSpec(strides=(1, 4, 4), k_self=(8, 8, 8), k_down=(8, 8, 8),
                                        k_contrast=(36, 24, 24), with_subscene=True)
    pyr = port_pyramid.build_pyramid(pts, spec)
    if pyr.order0 is not None:
        labels = torch.gather(labels, 1, pyr.order0)
    rng = np.random.RandomState(3)
    for i in (0, 2):
        m = pyr.points[i].shape[1]
        feats = rng.randn(2, m, 12).astype(np.float32)
        soft = contrast.subscene_labels(labels, pyr.subscene_idx[i], 13)
        ref_soft = jax_contrast.subscene_labels(
            jnp.asarray(labels.numpy()),
            None if pyr.subscene_idx[i] is None else jnp.asarray(pyr.subscene_idx[i].numpy()), 13)
        np.testing.assert_allclose(soft.numpy(), np.asarray(ref_soft), rtol=0, atol=1e-7)
        idx = pyr.contrast_idx[i]
        local = pyr.contrast_local[i]

        def ref_fn(f):
            return jax_contrast.cbl_stage_loss(f, jnp.asarray(idx.numpy()), ref_soft, jc,
                                               local=local)

        ref, ref_grad = jax.jit(jax.value_and_grad(ref_fn))(jnp.asarray(feats))
        tf = torch.from_numpy(feats).requires_grad_(True)
        loss = contrast.cbl_stage_loss(tf, idx, soft, c, local)
        loss.backward()
        assert float(ref) > 0, i
        np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5, err_msg=f"stage {i}")
        _close(tf.grad.numpy(), ref_grad, 1e-4, f"stage {i} gradient")


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _dist(a, b, keys):
    return float(np.sqrt(sum(np.sum((a[k] - b[k]) ** 2) for k in keys)))


@pytest.mark.parametrize("arch_out,tiny", [(CNT, TINY), (KL, TINY2)], ids=["cnt", "kl"])
def test_convnet_train_step_matches_jax(arch_out, tiny):
    batch = _batch()
    cfg, jcfg = _configs(arch_out, tiny)
    levels = len(cfg.model.strides)
    model = cfg.build_model(device="cpu", generator=torch.Generator().manual_seed(3))
    before = to_jax_variables(model)
    tx = jax_make_optimizer(0.05, momentum=0.9, weight_decay=1e-4)
    jstep = jax_make_train_step(jcfg.build_model(), JaxStepConfig(
        num_classes=13, spec=jcfg.pyramid_spec(), contrast=jcfg.contrast))
    state, ref = jstep(create_train_state(before, tx),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(model, TrainStepConfig(num_classes=13, spec=cfg.pyramid_spec(),
                                                  contrast=cfg.contrast),
                           make_optimizer(model.parameters(), 0.05), device="cpu")
    got = step(batch)
    keys = {"ce", "cbl", "loss"} | {f"cbl_stage{i}" for i in range(levels)}
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
