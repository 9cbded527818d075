"""The port's config (contrastboundary_tpu_torch/config/) against the JAX
package's: the same preset names and, for every preset, the same fields;
the same overrides (``--set`` strings and YAML files); the op-string DSL
agreeing with JAX's on every preset's string and on the DSL cases of
tests/test_heads_dsl.py wherever the port has the option, and raising
NotImplementedError (naming its ROADMAP item) where it does not; the
flagship's PyramidSpec and models. No tolerance: every field equal."""
import dataclasses
import importlib

import pytest
import torch

from contrastboundary_tpu.config import CONFIGS as JAX_CONFIGS
from contrastboundary_tpu.config import dsl as jax_dsl
from contrastboundary_tpu.config import load_config as jax_load_config
from contrastboundary_tpu_torch.config import CONFIGS, load_config
from contrastboundary_tpu_torch.config import dsl
from contrastboundary_tpu_torch.losses import ContrastConfig
from contrastboundary_tpu_torch.models import PointTransformerSeg
from contrastboundary_tpu_torch.ops.pyramid import PyramidSpec
from test_heads_dsl import PUBLISHED_OP_STRINGS

FLAGSHIP = "multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1"
# the DSL cases of tests/test_heads_dsl.py beyond the published strings
DSL_CASES = PUBLISHED_OP_STRINGS + [
    "contrast-Ua-softnn-logits-label-kl-w.1",
    "multi-Ua-sum-logits",
    "multi-Ua-concat-latent-lossSub.5",
    "multi-Ua-concat-latent-loss.3",
    "multi-Ua-concat-latent-concat1",
    "multi-Ua-concatmlp-fout",
    "multi-Ua-concat-latent-sep",
    "contrast-Ua-softnn-latent-label-l2-mS-w.1",
    "contrast-Ua-nce-latent-label-l2-mS-mask-w.1",
    "contrast-Ua-nce-latent-label-l2-mask.1-w.1",
    "contrast-Ua-softnn-latent-label-l2-p2-w.1",
    "contrast-Ua-softnn-latent-label-l2-p.5-w.1",
    "contrast-Ua-softnn-latent-label-l2-m.1-w.1",
    "contrast-Ua-softnn-latent-label-l2-mI-w.1",
    "contrast-Ua-softnn-latent-label-l2-mST2-w.1",
    "contrast-Ua-softnn-latent-label-max-l2-w.1",
    "contrast-Ua-softnn-latent-label-l2-mT.5-w.1",
    "pospool|2-xen-dp.5",
    "mlp-3-sigmoid-w.2",
    "1-xen-pred",
    "2-xen-class",
    "2-xen-center",
    "2-xen-banana",
    "contrast-Ua-softnn-latent-glb-l2-w.1",
    "contrast-Ua-softnn-latent-label-l2-w.1-banana",
    "multi-Ua-concat-latent-banana",
    "multi-U0-concat-latent|contrast-U012-softnn-latent-label-cos-T.5-w.2",
    "multi-Ua-concat-latent|contrast-D01_U34-softnn-latent-label-norml2-w.3",
    "|multi-Ua-concat-latent|contrast-Ua-softnn-fout-label-l2-w.1",
    "multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-proj-w.1",
    "multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2square-w.1",
    "multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-nn4-rand8-w.1",
    "multi-Ua-concat-latent-loss|contrast-Ua-softnn-latent-label-l2-w.1",
]
# the 19 presets of each package, registered when their module is imported
for _presets in ("contrastboundary_tpu.config.s3dis", "contrastboundary_tpu_torch.config.s3dis"):
    importlib.import_module(_presets)
PRESETS = sorted(CONFIGS)
assert len(PRESETS) == 19


@pytest.fixture(scope="module", autouse=True)
def one_thread_per_worker():
    """The models built here draw their fresh weights with one torch thread:
    under the suite's workers a thread a core oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_presets_equal_jax():
    assert sorted(CONFIGS) == sorted(JAX_CONFIGS)
    for name in sorted(CONFIGS):
        assert dataclasses.asdict(load_config(name)) == dataclasses.asdict(jax_load_config(name)), \
            name


def test_config_tree_fields_and_defaults_equal_jax():
    from contrastboundary_tpu.config import base as jb
    from contrastboundary_tpu_torch.config import base as tb

    for cls in ("DataConfig", "ModelConfig", "OptimConfig", "EvalConfig", "Config"):
        ours, ref = getattr(tb, cls), getattr(jb, cls)
        names = [f.name for f in dataclasses.fields(ours)]
        assert names == [f.name for f in dataclasses.fields(ref)]
        assert dataclasses.asdict(ours()) == dataclasses.asdict(ref()), cls


@pytest.mark.parametrize("sets", [
    "data.data_root:/x;optim.batch_size:2;optim.epochs:1;data.loop:2;eval.num_votes:1.0",
    'model.planes:[16,32,64,128,256];model.blocks:[1,1,1,1,1];log_freq:1;arch_out:"multi-Ua"',
    "model.dtype:bfloat16;model.bn_mode:stale;optim.grad_clip_norm:10",
])
def test_set_overrides_equal_jax(sets):
    assert dataclasses.asdict(load_config("s3dis_pt_cbl", sets)) == \
        dataclasses.asdict(jax_load_config("s3dis_pt_cbl", sets))
    with pytest.raises(KeyError):
        load_config("s3dis_pt_cbl", "data.nope:1")
    with pytest.raises(KeyError):
        load_config("no_such_preset")


def test_yaml_files_equal_jax(tmp_path):
    upd = tmp_path / "upd.yaml"
    upd.write_text("_base: synthetic_tiny\ndata:\n  voxel_size: 0.05\noptim.epochs: 3\n")
    preset = tmp_path / "mine.yaml"
    preset.write_text("_base: s3dis_pt_cbl\nmodel: {bn_mode: stale}\nseed: 5\n")
    for name, kw in ((str(preset), {}), ("s3dis_pt_cbl", {"cfg_file": str(upd)})):
        ours = load_config(name, "optim.epochs:4", **kw)
        ref = jax_load_config(name, "optim.epochs:4", **kw)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert load_config(str(preset)).name == "mine"


def _port_has(heads: dict) -> bool:
    """Whether the port has every option of JAX's parsed heads (every
    contrast option, ``sep`` and the plain mlp head's every option among
    them)."""
    multi = heads.get("multi")
    if multi is not None:
        flagship = dsl.flagship_multi()
        for k, v in multi.items():
            skip = k == "sep_head" or (k == "branch_weight" and not multi["branch_loss"])
            if not skip and v != flagship[k]:
                return False
    return True


def _port_view(heads: dict) -> dict:
    """JAX's parsed heads with its ContrastConfig as the port's, every field
    carried over (the two have the same fields)."""
    out = dict(heads)
    if "contrast" in out:
        out["contrast"] = ContrastConfig(**dataclasses.asdict(out["contrast"]))
    return out


@pytest.mark.parametrize("arch_out", DSL_CASES + sorted({c.get("arch_out", FLAGSHIP)
                                                          for c in JAX_CONFIGS.values()}))
def test_parse_arch_out_agrees_with_jax(arch_out):
    try:
        ref = jax_dsl.parse_arch_out(arch_out)
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            dsl.parse_arch_out(arch_out)
        return
    if _port_has(ref):
        assert dsl.parse_arch_out(arch_out) == _port_view(ref)
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 7"):
            dsl.parse_arch_out(arch_out)


def test_flagship_heads_and_stage_specs():
    heads = dsl.parse_arch_out(FLAGSHIP)
    assert heads["contrast"] == ContrastConfig()
    assert heads["multi"] == dsl.flagship_multi()
    assert heads["multi"] == jax_dsl.parse_multi_ops("multi-Ua-concat-latent")
    for spec in ("Ua", "U0", "D012_U34", "a", "", "u12_d0"):
        assert dsl.parse_stage(spec, 5) == jax_dsl.parse_stage(spec, 5)
    with pytest.raises(ValueError):
        dsl.parse_stage("X1", 5)


def test_flagship_pyramid_spec():
    spec = load_config("s3dis_pt_cbl").pyramid_spec()
    assert spec == PyramidSpec(k_contrast=(36, 24, 24, 24, 24), with_subscene=True)
    ref = jax_load_config("s3dis_pt_cbl").pyramid_spec()
    for f in dataclasses.fields(spec):
        assert getattr(spec, f.name) == getattr(ref, f.name), f.name
    # the flagship's contrast search shares the self search's geometry: one
    # merged search
    assert (spec.contrast_tile, spec.contrast_window) == (spec.self_tile, spec.self_window)
    assert load_config("s3dis_pt_cbl", 'arch_out:"multi-Ua-concat-latent"').pyramid_spec() == \
        PyramidSpec()


@pytest.mark.parametrize("name,dtype", [("s3dis_pt_cbl", torch.float32),
                                        ("s3dis_pt_cbl_bf16", torch.bfloat16)])
def test_build_model(name, dtype):
    cfg = load_config(name, "model.bn_mode:stale")
    model = cfg.build_model(device="cpu", generator=torch.Generator().manual_seed(1))
    ref = PointTransformerSeg(bn_mode="stale", dtype=dtype,
                              generator=torch.Generator().manual_seed(1))
    assert model.dtype == dtype and model.planes == (32, 64, 128, 256, 512)
    assert model.blocks == (2, 3, 4, 6, 3)
    sd, rd = model.state_dict(), ref.state_dict()
    assert sd.keys() == rd.keys() and all(torch.equal(sd[k], rd[k]) for k in sd)
    assert type(model.enc0_down.BatchNorm_0).__name__ == "StaleBatchNorm"
    with pytest.raises(RuntimeError, match="CUDA"):
        cfg.build_model()  # the card by default, and this CPU has none


@pytest.mark.parametrize("name,sets,item", [
    ("s3dis_conv_cbl", "model.dtype:bfloat16", "item 7"),
    ("s3dis_pt_cbl_paper", "model.dtype:bfloat16", "item 7"),
    ("s3dis_pt_cbl", 'arch_out:"multi-Ua-sum-latent"', "item 7"),
    ("s3dis_pt_cbl", "model.save_memory:true", "item 7"),
    ("s3dis_pt", 'arch_out:"mlp-1-xen|contrast-Ua-softnn-latent-label-l2-w.1"', "item 7"),
    ("s3dis_pt_cbl", 'arch_out:"multi-Ua-concat-latent-loss"', "item 7"),
    ("s3dis_pt_cbl", 'arch_out:"multi-Ua-concatmlp-latent"', "item 7"),
])
def test_unported_options_raise(name, sets, item):
    cfg = load_config(name, sets)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue A {item}"):
        cfg.build_model(device="cpu")


@pytest.mark.parametrize("arch_out,modules", [
    ("multi-Ua-concat-latent|contrast-Ua-nce-latent-label-l2-w.1", ()),
    ("multi-Ua-concat-latent-sep|contrast-Ua-nce-latent-label_recur-l2square-mS-mask-nn4-rand8-"
     "projmlp-w.1", ("sep_latent4", "project4.fc0")),
    ("multi-Ua-concat-latent|contrast-Ua-softnn-probs-labelkl.5-nst-kl-p2-w.1", ("branch_cls4",)),
    ("multi-Ua-concat-latent|contrast-Ua-softnn-fout-label-l2-w.1", ()),
    ("multi-Ua-concat-latent-sep|contrast-Ua-softnn-logits-label-max-l2-projlinear-w.1",
     ("sep_latent0", "sep_cls0", "project0")),
    ("multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-projmlp2-p.5-w.1",
     ("project2.fc1",)),
])
def test_contrast_options_build_with_the_jax_config(arch_out, modules):
    """The CBL options test_unported_options_raise once held as raising
    (ROADMAP Queue A item 7c): each builds its model, with the MultiHead's
    contrast-branch modules the options name, and parses to a
    ContrastConfig equal to JAX's on every field."""
    sets = f'arch_out:"{arch_out}";model.planes:[8,16,24,32,40];model.blocks:[1,1,1,1,1]'
    cfg = load_config("s3dis_pt_cbl", sets)
    ref = jax_load_config("s3dis_pt_cbl", sets).contrast
    assert dataclasses.asdict(cfg.contrast) == dataclasses.asdict(ref)
    model = cfg.build_model(device="cpu")
    names = dict(model.multihead.named_modules())
    assert all(m in names for m in modules), sorted(names)
    head = model.multihead
    assert (head.contrast_ftype, head.project) == (ref.ftype, ref.project)
    assert head.sep_head == cfg.heads["multi"]["sep_head"]


def _spec_equals_jax(name, sets=None):
    """The port's spec of the preset equals JAX's on every field both have."""
    spec, ref = load_config(name, sets).pyramid_spec(), jax_load_config(name, sets).pyramid_spec()
    shared = {f.name for f in dataclasses.fields(ref)} & {f.name for f in dataclasses.fields(spec)}
    for f in sorted(shared):
        assert getattr(spec, f) == getattr(ref, f), (name, f)
    return spec


@pytest.mark.parametrize("name,sets,sampler,head", [
    ("s3dis_randla_cbl", None, "random", "multihead"),
    ("s3dis_pt_cbl_paper", "model.sampler:random", "random", "multihead"),
    ("s3dis_pt", None, "strided", "cls_tower"),
])
def test_formerly_unported_presets_build(name, sets, sampler, head):
    """The three cases this test's list once held as raising: each builds
    its model, with the head its arch_out names, and its spec is JAX's."""
    spec = _spec_equals_jax(name, sets)
    assert spec.sampler == sampler
    model = load_config(name, sets).build_model(device="cpu")
    assert hasattr(model, head)
    assert hasattr(model, "cls") == (head == "cls_tower")


@pytest.mark.parametrize("name,sets,field,value", [
    ("synthetic_conv_tiny", "model.knn_window:4", "knn_window", 4),
    ("s3dis_pt_cbl_paper", "model.contrast_mode:tile", "contrast_mode", "tile"),
    ("s3dis_pt_cbl", "model.knn_recall:0.9", "knn_recall", 0.9),
    ("s3dis_pt_cbl", "model.contrast_window:2", "contrast_window", 2),
    ("s3dis_pt_cbl", "model.knn_window:4", "knn_window", 4),
])
def test_pyramid_options_build_with_the_jax_spec(name, sets, field, value):
    """The pyramid options test_unported_options_raise once held as raising
    (ROADMAP Queue A item 7b): each builds its model, and its spec, which
    carries the option, equals JAX's on every field both have."""
    spec = _spec_equals_jax(name, sets)
    assert getattr(spec, field) == value
    model = load_config(name, sets).build_model(device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


@pytest.mark.parametrize("name", ["s3dis_pt_cbl", "s3dis_pt_cbl_paper"])
def test_unknown_contrast_mode_raises(name):
    with pytest.raises(ValueError, match="contrast_mode"):
        load_config(name, "model.contrast_mode:global").build_model(device="cpu")


@pytest.mark.parametrize("name", PRESETS)
def test_every_preset_builds_with_the_jax_spec(name):
    _spec_equals_jax(name)
    model = load_config(name).build_model(device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 0


def test_both_heads_or_a_plain_head_with_cbl():
    with pytest.raises(ValueError, match="exactly one prediction path"):
        load_config("s3dis_pt", 'arch_out:"multi-Ua-concat-latent|mlp-2-xen"').build_model(
            device="cpu")
    with pytest.raises(ValueError, match="1 channel"):
        from contrastboundary_tpu_torch.losses import sigmoid_cross_entropy
        sigmoid_cross_entropy(torch.zeros(2, 3, 2), torch.zeros(2, 3, dtype=torch.long))
