"""Dataclass config tree, preset registry and CLI/YAML overrides
(counterpart of contrastboundary_tpu/config/base.py: the same fields,
defaults, presets and override grammar).

``pyramid_spec()`` and ``build_model()`` build the port's objects for the
option points the port has: the point transformer on the Morton-sorted
layout (``layout='sorted'``; float32 or bfloat16) or the natural one
(float32), with the strided (sorted only), serialized, fps, bucket_fps or
random sampler, batch or stale BN; the ConvNet family (every aggregation)
in float32 on the natural layout with the voxel or random sampler; the
pyramid options (the windowed KNN ``knn_window``, the natural layout's
tile contrast search ``contrast_mode='tile'``, a ``contrast_window`` of
its own, any ``knn_recall``: every search of the port is exact, and the
recall only selects the reference's CPU tie rule of the top-1 searches);
the flagship MultiHead with its contrast branch (``sep``, the contrast
feature source and projection) or the plain mlp head (its latent tower,
dropout, losses and class weights), and every CBL option (config/dsl.py).
Every other option raises NotImplementedError naming the ROADMAP Queue A
item that ports it (item 7): bfloat16 on the natural layout, the main
head's other options (and the plain head with a contrast head), remat.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..losses.contrast import ContrastConfig
from ..ops.pyramid import PyramidSpec
from .dsl import OPTIONS_ITEM, parse_arch_out

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class DataConfig:
    dataset: str = "synthetic"  # synthetic | s3dis
    data_root: str = ""
    test_area: int = 5
    num_classes: int = 13
    fea_dim: int = 3  # rgb
    voxel_size: float = 0.04
    voxel_max: int = 24000
    n_points: int = 16384  # static crop size (device shape)
    loop: int = 30
    ignore_label: int = -1
    crop_mode: str = "count"  # count (PT nearest-N) | radius (TF in_radius sphere)
    in_radius: float = 2.0
    # train crop centers: 'random' (PT stack, util/data_util.py:45-90) |
    # 'potential' (TF spatially-regular sampler, datasets/base.py:352-448 —
    # the ConvNet recipe; see data/pipeline.py::PotentialSampler)
    sampler: str = "random"
    # synthetic-only
    num_rooms: int = 16
    points_per_room: int = 120_000
    ignore_fraction: float = 0.0


@dataclasses.dataclass
class ModelConfig:
    arch: str = "pointtransformer"  # pointtransformer | convnet
    planes: Tuple[int, ...] = (32, 64, 128, 256, 512)
    blocks: Tuple[int, ...] = (2, 3, 4, 6, 3)
    share_planes: int = 8
    base_fdim: int = 32
    strides: Tuple[int, ...] = (1, 4, 4, 4, 4)
    nsample: Tuple[int, ...] = (8, 16, 16, 16, 16)  # backbone knn
    contrast_nsample: Tuple[int, ...] = (36, 24, 24, 24, 24)
    sampler: str = "bucket_fps"
    dtype: str = "float32"  # float32 | bfloat16
    save_memory: bool = False  # remat transformer blocks in backward
    # >0: Morton-tile windowed KNN in the pyramid (4x faster at N=65k,
    # recall ~0.97 at 4); 0 = dense approx (default, exact-recall parity)
    knn_window: int = 0
    # 'sorted': every pyramid level is kept Morton-sorted and the backbone
    # self-attention + CBL neighbor gathers run as tile-local one-hot MXU
    # matmuls (ops/tile_gather.py) — the point-transformer fast path.
    # ConvNet (global shadow-index radius semantics) requires 'natural'.
    layout: str = "natural"  # natural | sorted
    # 'tile': tile-local CBL gathers under the NATURAL layout (sorts the
    # contrast stages on the fly; implied for every stage under 'sorted')
    contrast_mode: str = "dense"  # dense | tile
    # BN semantics: 'batch' = exact nn.BatchNorm (reference parity);
    # 'stale' = normalize with running stats + update from batch stats
    # (fold-friendly fast path; models/blocks.py::StaleBatchNorm)
    bn_mode: str = "batch"
    # tile-window half-widths (sorted layout) and the approx-top-k recall
    # target (0 → exact lax.top_k; cheap within tile windows)
    self_window: int = 1
    contrast_window: int = 1
    knn_recall: float = 0.95
    # --- convnet family (reference config/s3dis/adapt.yaml defaults) ---
    aggregation: str = "adaptive_weight"  # pospool | adaptive_weight | pointwisemlp | pseudo_grid | identity
    agg_kwargs: Tuple[Tuple[str, Any], ...] = ()
    bottleneck_ratio: int = 2
    depth: int = 1
    base_radius: float = 0.1  # first_subsampling_dl * density_parameter / 2
    density_parameter: float = 5.0
    in_features: str = "1-rgb-Z"
    # radius-masked knn caps per level (reference neighborhood_limits)
    neighborhood_limits: Tuple[int, ...] = (26, 31, 38, 41, 39)


@dataclasses.dataclass
class OptimConfig:
    optimizer: str = "sgd"
    base_lr: float = 0.5
    momentum: float = 0.9
    weight_decay: float = 1e-4
    grad_clip_norm: Optional[float] = None
    schedule: str = "multistep"  # multistep | exponential
    milestones: Tuple[float, ...] = (0.6, 0.8)  # fraction of epochs
    multiplier: float = 0.1
    decay_rate: float = 0.9885531  # exponential (ConvNet recipe)
    epochs: int = 200
    batch_size: int = 4


@dataclasses.dataclass
class EvalConfig:
    batch_size: int = 4
    num_votes: float = 2.0
    smooth: float = 0.95
    eval_freq: int = 1


@dataclasses.dataclass
class Config:
    name: str = "default"
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)
    # head spec in the reference DSL; '' disables a head
    arch_out: str = "multi-Ua-concat-latent|contrast-Ua-softnn-latent-label-l2-w.1"
    seed: int = 7777
    save_path: str = "results"
    log_freq: int = 10
    save_freq: int = 1
    debug_nan: bool = False  # dump reproducer + per-var NaN stats on NaN loss
    runtime_freq: int = 0  # >0: capture a torch.profiler trace every N steps

    @property
    def num_layers(self) -> int:
        return len(self.model.strides)

    @property
    def heads(self) -> dict:
        return parse_arch_out(self.arch_out, self.num_layers) if self.arch_out else {}

    @property
    def contrast(self) -> Optional[ContrastConfig]:
        return self.heads.get("contrast")

    def _convnet_spec(self) -> PyramidSpec:
        """The ConvNet's natural-layout spec, as the reference's: radii
        base_radius·2^l, self caps ``neighborhood_limits``; the pooling
        search into level l takes the source level's radius and cap (the
        reference's kr_sample = kr_search[:-1]), so ``down_radii`` and
        ``k_down`` are shifted by one level."""
        m = self.model
        if m.layout != "natural":
            raise ValueError(
                "model.layout='sorted' is the point-transformer fast path; "
                "convnet needs global shadow-index neighbors (layout='natural')")
        if m.sampler not in ("voxel", "random"):
            raise NotImplementedError(
                f"model.sampler={m.sampler!r} is not ported for the ConvNet ({OPTIONS_ITEM}); "
                "the port builds the natural layout with the voxel or random sampler")
        nl = len(m.strides)
        radii = tuple(m.base_radius * 2**i for i in range(nl))
        limits = tuple(m.neighborhood_limits[:nl])
        return PyramidSpec(
            strides=tuple(m.strides),
            k_self=limits,
            k_down=(limits[0],) + limits[:-1],
            k_contrast=tuple(m.contrast_nsample) if self.contrast else None,
            with_subscene=self.contrast is not None,
            sampler=m.sampler,
            layout=m.layout,
            knn_window=m.knn_window,
            radii=radii,
            down_radii=(radii[0],) + radii[:-1],
            voxel_sizes=tuple(self.data.voxel_size * 2**i for i in range(nl)),
        )

    def pyramid_spec(self) -> PyramidSpec:
        """The port's PyramidSpec of this config (the training one: with the
        contrast and sub-scene searches where the CBL runs)."""
        m = self.model
        if m.arch == "convnet":
            return self._convnet_spec()
        if m.arch != "pointtransformer":
            raise ValueError(f"unknown arch {m.arch!r}")
        if m.layout not in ("sorted", "natural"):
            raise ValueError(f"unknown model.layout {m.layout!r}")
        if m.contrast_mode not in ("dense", "tile"):
            raise ValueError(f"unknown model.contrast_mode {m.contrast_mode!r}")
        if m.sampler not in ("strided", "serialized", "fps", "bucket_fps", "random"):
            raise ValueError(f"model.sampler {m.sampler!r} for the point transformer")
        contrast = self.contrast
        return PyramidSpec(
            strides=tuple(m.strides),
            k_self=tuple(m.nsample),
            k_down=tuple(m.nsample),
            k_contrast=tuple(m.contrast_nsample) if contrast else None,
            with_subscene=contrast is not None,
            sampler=m.sampler,
            layout=m.layout,
            self_window=m.self_window,
            knn_recall=m.knn_recall if m.knn_recall > 0 else None,
            knn_window=m.knn_window,
            contrast_mode=m.contrast_mode,
            contrast_window=m.contrast_window,
        )

    def build_model(self, device="cuda", generator: Optional[torch.Generator] = None):
        """The port's PointTransformerSeg or ConvNetSeg of this config on
        ``device``, its fresh weights flax's (models/init.py) drawn from
        ``generator``: with the MultiHead where ``arch_out`` has a 'multi'
        segment, else the plain mlp head (its 'mlp' segment's depth and
        dropout, or the defaults)."""
        from ..models import ConvNetSeg, PointTransformerSeg

        self.pyramid_spec()  # the model runs on the port's pyramid only
        m = self.model
        heads = self.heads
        multi, mlp = "multi" in heads, heads.get("mlp", {})
        if multi and mlp:
            raise ValueError(
                "arch_out selects both a 'multi' and a plain 'mlp' head; the model builds "
                "exactly one prediction path — pick one")
        if not multi and self.contrast is not None:
            raise NotImplementedError(
                f"arch_out {self.arch_out!r}: the plain mlp head with a contrast head is not "
                f"ported ({OPTIONS_ITEM})")
        contrast = self.contrast
        head_kw = dict(use_multihead=multi, mlp_depth=mlp.get("depth", 1),
                       mlp_drop=mlp.get("drop"),
                       contrast_project=contrast.project if contrast else "",
                       contrast_ftype=contrast.ftype if contrast else "latent",
                       multi_sep_head=heads.get("multi", {}).get("sep_head", False))
        if m.dtype not in DTYPES:
            raise ValueError(f"model.dtype {m.dtype!r} is not one of {sorted(DTYPES)}")
        if m.arch == "convnet":
            if m.dtype != "float32":
                raise NotImplementedError(
                    f"model.dtype={m.dtype!r} for the ConvNet is not ported ({OPTIONS_ITEM})")
            model = ConvNetSeg(
                num_classes=self.data.num_classes,
                base_fdim=m.base_fdim,
                bottleneck_ratio=m.bottleneck_ratio,
                depth=m.depth,
                base_radius=m.base_radius,
                num_layers=len(m.strides),
                aggregation=m.aggregation,
                agg_kwargs=tuple(m.agg_kwargs),
                density_parameter=m.density_parameter,
                bn_mode=m.bn_mode,
                in_features=m.in_features,
                fea_dim=self.data.fea_dim,
                generator=generator,
                **head_kw,
            )
            return model.to(resolve_device(device))
        if m.save_memory:
            raise NotImplementedError(f"model.save_memory (remat) is not ported ({OPTIONS_ITEM})")
        if m.layout == "natural" and m.dtype != "float32":
            raise NotImplementedError(
                f"model.dtype={m.dtype!r} on the natural layout is not ported ({OPTIONS_ITEM})")
        dev = resolve_device(device)
        model = PointTransformerSeg(
            num_classes=self.data.num_classes,
            planes=tuple(m.planes),
            blocks=tuple(m.blocks),
            share_planes=m.share_planes,
            base_fdim=m.base_fdim,
            in_features=self.data.fea_dim,
            bn_mode=m.bn_mode,
            dtype=DTYPES[m.dtype],
            generator=generator,
            **head_kw,
        )
        return model.to(dev)


def _update_dataclass(obj, updates: Dict[str, Any]):
    for k, v in updates.items():
        if "." in k:
            head, rest = k.split(".", 1)
            _update_dataclass(getattr(obj, head), {rest: v})
        else:
            if not hasattr(obj, k):
                raise KeyError(f"unknown config key {k!r} on {type(obj).__name__}")
            cur = getattr(obj, k)
            if isinstance(cur, (DataConfig, ModelConfig, OptimConfig, EvalConfig)):
                _update_dataclass(cur, v)
            else:
                if isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                    v = tuple(v)
                setattr(obj, k, v)


CONFIGS: Dict[str, Dict[str, Any]] = {}


def register_config(name: str, **overrides):
    CONFIGS[name] = overrides


def load_yaml_config(path: str) -> Dict[str, Any]:
    """Read a YAML update file into an override dict — the reference's
    config-file mechanism (tensorflow/config/utils.py:87-146 merges YAMLs
    like config/s3dis/adapt.yaml over generated configs; the whole PyTorch
    stack is YAML-configured, pytorch/util/config.py CfgNode).

    Keys are this repo's dotted config paths (`data.voxel_size: 0.02`) or
    nested sections (`data: {voxel_size: 0.02}`) — the same namespace as
    `--set`, so a reference YAML translates key-for-key. An optional `_base`
    key names the preset the file extends (default: the CLI `-c` preset)."""
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    if not isinstance(d, dict):
        raise ValueError(f"config file {path!r} must be a YAML mapping")
    return d


def load_config(
    name: str = "default",
    sets: Optional[str] = None,
    cfg_file: Optional[str] = None,
) -> Config:
    """Named preset + optional YAML update file + `--set a.b:v;c:v` overrides
    (reference main.py:42-44 + config/utils.py:87-146). Precedence: preset <
    YAML < --set. `name` may itself be a `.yaml`/`.yml` path — its `_base`
    key (or 'default') picks the preset it extends."""
    from . import s3dis as _s3dis  # noqa: F401  (registers presets)

    yaml_overrides: Dict[str, Any] = {}
    if name.endswith((".yaml", ".yml")):
        import os

        yaml_overrides = load_yaml_config(name)
        base = yaml_overrides.pop("_base", "default")
        cfg = Config(name=os.path.splitext(os.path.basename(name))[0])
        if base not in CONFIGS:
            raise KeyError(f"unknown _base {base!r}; known: {sorted(CONFIGS)}")
        _update_dataclass(cfg, CONFIGS[base])
    else:
        cfg = Config(name=name)
        if name not in CONFIGS:
            raise KeyError(f"unknown config {name!r}; known: {sorted(CONFIGS)}")
        _update_dataclass(cfg, CONFIGS[name])
    if cfg_file:
        upd = load_yaml_config(cfg_file)
        upd.pop("_base", None)  # the -c / path preset already decided
        yaml_overrides.update(upd)
    if yaml_overrides:
        _update_dataclass(cfg, yaml_overrides)
    if sets:
        upd = {}
        for kv in sets.split(";"):
            if not kv:
                continue
            k, v = kv.split(":", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            upd[k.strip()] = v
        _update_dataclass(cfg, upd)
    return cfg
