"""Every ConvNet preset of the port builds on the CPU as the JAX package's
does: its PyramidSpec equal to JAX's field by field; for one preset of
each aggregation and the narrow synthetic one, its model's state_dict the
shapes of JAX's flax tree (traced by jax.eval_shape, no compile); s3dis_pt_cbl_kl (the kl positives) builds too, and
s3dis_randla_cbl (the random sampler) builds (tests/test_torch_randla.py
holds it against JAX), while its options the port lacks raise
NotImplementedError naming their ROADMAP item."""
import dataclasses
from collections.abc import Mapping

import pytest
import torch

import jax
import jax.numpy as jnp

from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu.ops import pyramid as jax_pyramid
from contrastboundary_tpu_torch.config import CONFIGS, load_config
from contrastboundary_tpu_torch.models import to_jax_variables


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _shapes(tree, prefix=()):
    """{"collection/module/…/leaf": shape} of a tree of arrays or shape
    structs."""
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _shapes(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), tuple(v.shape)


# every ConvNet preset but s3dis_randla_cbl (named here, not read from the
# registry: registering the presets while the tests are collected would
# change what other test files see in it)
CONVNET_PRESETS = ["npm3d_conv_cbl", "s3dis_conv_cbl", "s3dis_conv_cbl_kl",
                   "s3dis_conv_cbl_paper", "s3dis_pospool_cbl", "s3dis_pseudogrid_cbl",
                   "scannet_conv_cbl", "semantic3d_conv_cbl", "synthetic_conv_tiny"]


# one preset per aggregation, and the narrow one: their flax trees traced
SHAPE_PRESETS = ("s3dis_conv_cbl", "s3dis_pospool_cbl", "s3dis_pseudogrid_cbl",
                 "synthetic_conv_tiny")


def test_the_list_holds_every_convnet_preset():
    load_config("default")  # registers the presets
    convnets = {n for n in CONFIGS if load_config(n).model.arch == "convnet"}
    assert convnets == set(CONVNET_PRESETS) | {"s3dis_randla_cbl"}


@pytest.mark.parametrize("name", CONVNET_PRESETS + ["s3dis_pt_cbl_kl"])
def test_preset_builds_its_model_and_spec_as_jax(name):
    cfg, jcfg = load_config(name), jax_load_config(name)
    spec, ref = cfg.pyramid_spec(), jcfg.pyramid_spec()
    for f in dataclasses.fields(spec):
        assert getattr(spec, f.name) == getattr(ref, f.name), f.name
    model = cfg.build_model(device="cpu")
    if name not in SHAPE_PRESETS:
        return
    pts = jax.ShapeDtypeStruct((1, 1024, 3), jnp.float32)
    feats = jax.ShapeDtypeStruct((1, 1024, cfg.data.fea_dim), jnp.float32)
    shapes = jax.eval_shape(
        lambda p, f: jcfg.build_model().init(jax.random.PRNGKey(0), f,
                                             jax_pyramid.build_pyramid(p, ref), train=False),
        pts, feats)
    assert dict(_shapes(to_jax_variables(model))) == dict(_shapes(shapes))


def test_randla_preset_raises_naming_the_roadmap_item():
    """The preset builds with the random sampler, and with the windowed KNN
    (its spec JAX's); a bfloat16 ConvNet, which the port lacks, still
    raises naming the item."""
    cfg = load_config("s3dis_randla_cbl")
    assert cfg.pyramid_spec().sampler == "random"
    cfg.build_model(device="cpu")
    windowed = load_config("s3dis_randla_cbl", "model.knn_window:4")
    spec = windowed.pyramid_spec()
    ref = jax_load_config("s3dis_randla_cbl", "model.knn_window:4").pyramid_spec()
    assert spec.knn_window == 4
    for f in dataclasses.fields(spec):
        assert getattr(spec, f.name) == getattr(ref, f.name), f.name
    windowed.build_model(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 7"):
        load_config("s3dis_randla_cbl", "model.dtype:bfloat16").build_model(device="cpu")
