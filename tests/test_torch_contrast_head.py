"""The MultiHead's contrast branch (models/pointtransformer.py::MultiHead)
against the JAX package's on the CPU, weights carried from JAX's fresh
flax tree by models/convert.py: each stage's contrast features, the
prediction and the batch statistics after a train-mode call, under the
contrast feature sources (latent, logits, probs, f_out), the projections
('', linear, mlp, mlp2) and ``sep`` (the branch's own towers), at small
widths (three stages, planes 8-16-24, base_fdim 8, 5 classes). The
ConvNet's and the point transformer's heads take the same options: their
flax trees (jax.eval_shape of the JAX model's init at a tiny size) load
into the port's models leaf for leaf.

Tolerances: features and logits within 1e-5 of scale, or within twice
JAX's own distance from the port's head evaluated in float64 where that is
wider (a BatchNorm over the 32 rows of a small stage divides float32 sum
noise by a channel's small spread: JAX's projected probs at stage 1 lie
1.0e-5 of scale from the float64 values, the port's 3e-7); statistics rtol
1e-5 (float32 sums in another order).
"""
import copy
import dataclasses
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.models.pointtransformer import MultiHead as JaxMultiHead
from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu_torch.config import load_config
from contrastboundary_tpu_torch.models import load_jax_variables, to_jax_variables
from contrastboundary_tpu_torch.models.pointtransformer import MultiHead

PLANES, D, NCLS, B = (8, 16, 24), 8, 5, 2
NS = (64, 16, 4)
# each projection on the latent, each feature source (with and without sep)
CASES = ([(p, "latent", False) for p in ("", "linear", "mlp", "mlp2")]
         + [("mlp", "logits", True), ("", "logits", False), ("mlp", "probs", False),
            ("linear", "probs", True), ("mlp2", "f_out", True), ("", "f_out", False)])


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def _inputs(seed):
    rng = np.random.RandomState(seed)
    up = [rng.randn(B, n, c).astype(np.float32) for n, c in zip(NS, PLANES)]
    near0 = [None] + [rng.randint(0, n, (B, NS[0])).astype(np.int32) for n in NS[1:]]
    return up, near0


@pytest.mark.parametrize("project,ftype,sep", CASES)
def test_contrast_branch_matches_jax(project, ftype, sep):
    up, near0 = _inputs(0)
    nones = (None,) * len(NS)
    jpyr = SimpleNamespace(near0_meta=nones, near0_idx=tuple(
        None if a is None else jnp.asarray(a) for a in near0))
    pyr = SimpleNamespace(near0_meta=nones, near0_idx=tuple(
        None if a is None else torch.as_tensor(a) for a in near0))
    jhead = JaxMultiHead(NCLS, D, project=project, contrast_ftype=ftype, sep_head=sep)
    jup = tuple(jnp.asarray(u) for u in up)
    variables = jax.device_get(jhead.init(jax.random.PRNGKey(3), jup, jpyr, train=True))
    # move every weight off flax's init (zero biases, unit scales)
    rng = np.random.RandomState(1)
    variables = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + 0.1 * rng.randn(*v.shape)).astype(np.float32), variables)
    (jlogits, jlat, jfeats, jstage), mutated = jhead.apply(
        variables, jup, jpyr, train=True, mutable=["batch_stats"])
    head = load_jax_variables(
        MultiHead(PLANES, NCLS, D, project=project, contrast_ftype=ftype, sep_head=sep),
        variables)
    head.train()
    with mock.patch.object(torch.Tensor, "float", lambda t: t):  # the head's float32 casts
        exact = copy.deepcopy(head).double()([torch.as_tensor(u).double() for u in up], pyr)
    logits, lat, feats, stage = head([torch.as_tensor(u) for u in up], pyr)

    def pairs(out):
        lg, _, ft, st = out
        return [lg] + list(ft) + [s for s in st if s is not None]

    names = ["logits"] + [f"contrast {i}" for i in range(len(feats))] + [
        f"branch logits {i}" for i, s in enumerate(stage) if s is not None]
    for what, a, b, e in zip(names, pairs((logits, lat, feats, stage)),
                             pairs((jlogits, jlat, jfeats, jstage)), pairs(exact)):
        b, e = np.asarray(b), e.detach().numpy()
        assert tuple(a.shape) == b.shape, what
        err = float(np.abs(a.detach().numpy() - b).max())
        own = float(np.abs(b - e).max())
        assert err <= max(1e-5 * np.abs(b).max(), 2 * own), (what, err, own)
    assert [s is None for s in stage] == [s is None for s in jstage]
    width = {"f_out": PLANES, "logits": (NCLS,) * 3, "probs": (NCLS,) * 3, "latent": (D,) * 3}
    assert [f.shape[-1] for f in feats] == list((D,) * 3 if project else width[ftype])
    got = dict(_leaves(to_jax_variables(head)["batch_stats"]))
    ref = dict(_leaves(jax.device_get(mutated["batch_stats"])))
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-7, err_msg=k)


ARCHS = {
    "pointtransformer": ("s3dis_pt_cbl", "model.planes:[8,16,24];model.blocks:[1,1,1];"
                         "model.strides:[1,4,4];model.nsample:[8,8,8]"),
    "convnet": ("s3dis_conv_cbl", "model.base_fdim:4;model.strides:[1,4,4]"),
}
MODEL_CASES = [
    ("pointtransformer", "multi-Ua-concat-latent|contrast-Ua-softnn-probs-labelkl.5-nst-kl-p2-w.1"),
    ("convnet", "multi-Ua-concat-latent-sep|contrast-Ua-softnn-logits-label-l2-projmlp2-w.1"),
]


@pytest.mark.parametrize("arch,arch_out", MODEL_CASES)
def test_models_take_the_head_options_with_flax_names(arch, arch_out):
    """Both architectures pass the contrast options to their MultiHead: the
    shapes of JAX's flax tree for the same config load into the port's
    model, every leaf consumed and every parameter and statistic set."""
    name, sets = ARCHS[arch]
    sets = f'{sets};arch_out:"{arch_out}"'
    jcfg, cfg = jax_load_config(name, sets), load_config(name, sets)
    assert dataclasses.asdict(cfg.contrast) == dataclasses.asdict(jcfg.contrast)
    pts = jnp.zeros((1, 256, 3), jnp.float32)
    spec = jcfg.pyramid_spec()
    shapes = jax.eval_shape(
        lambda p: jcfg.build_model().init(jax.random.PRNGKey(0), jnp.zeros((1, 256, 3)),
                                          jax_pyramid.build_pyramid(p, spec), train=False), pts)
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = load_jax_variables(cfg.build_model(device="cpu"), tree)
    heads = {n for n, _ in model.multihead.named_children()}
    contrast = cfg.contrast
    assert ("project0" in heads) == bool(contrast.project)
    assert ("sep_latent0" in heads) == cfg.heads["multi"]["sep_head"]
    assert ("branch_cls0" in heads) == (contrast.ftype in ("logits", "probs")
                                        and not cfg.heads["multi"]["sep_head"])
