"""The ConvNet segmentation backbone with a pluggable local aggregation, its
nearest-upsample decoder and the flagship MultiHead (counterpart of
contrastboundary_tpu/models/convnet.py:30-213).

Encoder: input 1×1, the aggregation once at level 0, ``depth``
bottlenecks; then per stage a strided bottleneck (the aggregation over the
pooling search, a max-pool shortcut over the same neighbours) and ``depth``
bottlenecks, the width ×2 and the radius ×2 a stage. Decoder: each level
takes the deeper level's features at its nearest up neighbour, concatenates
its own and applies a 1×1. It runs on the natural-layout pyramid
(ops/pyramid.py): global neighbour rows with the shadow index N.

The head is the flagship MultiHead, or with ``use_multihead=False`` the
plain mlp head: ``mlp_depth`` 1×1s ``seg_head``, ``seg_head1``, … of
base_fdim on level 0, dropout ``cls_drop`` where ``mlp_drop`` is set, and
the linear ``cls`` (no latents).

Submodule names are the flax names (``input_conv_fc``, ``res2_strided_agg``,
``up_conv0_bn``, ``multihead``, …), so a flax tree maps onto the state_dict
(models/convert.py). Every 1×1 is a Dense without bias + BN(momentum 0.99,
eps 1e-6) of ``bn_mode``; the MultiHead's BNs keep flax's defaults, as the
reference builds it. float32 only.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.gather import batch_gather, shadow_gather
from ..ops.pyramid import Pyramid
from .blocks import make_bn
from .init import init_like_flax
from .local_aggregation import AGGREGATORS
from .pointtransformer import ModelOutput, MultiHead, apply_plain_head, plain_head

_NEG = -65535.0


def input_feature_width(kind: str, fea_dim: int) -> int:
    """Width of ``build_input_features`` for colours of ``fea_dim`` channels."""
    widths = {"1": 1, "rgb": fea_dim, "Z": 1, "xyz": 3}
    for tok in kind.split("-"):
        if tok not in widths:
            raise ValueError(f"unknown input feature token {tok!r}")
    return sum(widths[t] for t in kind.split("-"))


def build_input_features(points, colors, kind: str = "1-rgb-Z"):
    """The input features: a concatenation of a ones column ('1'), the
    colours ('rgb'), the height ('Z') and the coordinates ('xyz')."""
    parts = {"1": lambda: torch.ones_like(points[..., :1]), "rgb": lambda: colors,
             "Z": lambda: points[..., 2:3], "xyz": lambda: points}
    out = []
    for tok in kind.split("-"):
        if tok not in parts:
            raise ValueError(f"unknown input feature token {tok!r}")
        out.append(parts[tok]())
    return torch.cat(out, -1)


class ConvNetSeg(nn.Module):
    """The ConvNet + MultiHead. ``aggregation`` names an operator of
    models/local_aggregation.py and ``agg_kwargs`` its options (the
    presets' (key, value) pairs). Fresh weights are flax's
    (models/init.py), drawn from ``generator`` (seeded 0 where none is
    given)."""

    def __init__(self, num_classes: int = 13, base_fdim: int = 72,
                 bottleneck_ratio: int = 2, depth: int = 1, base_radius: float = 0.1,
                 num_layers: int = 5, aggregation: str = "adaptive_weight",
                 agg_kwargs: Tuple[Tuple[str, Any], ...] = (),
                 density_parameter: float = 5.0, bn_momentum: float = 0.99,
                 bn_eps: float = 1e-6, bn_mode: str = "batch",
                 in_features: str = "1-rgb-Z", fea_dim: int = 3,
                 generator: Optional[torch.Generator] = None, use_multihead: bool = True,
                 mlp_depth: int = 1, mlp_drop: Optional[float] = None,
                 contrast_project: str = "", contrast_ftype: str = "latent",
                 multi_sep_head: bool = False):
        super().__init__()
        if aggregation not in AGGREGATORS:
            raise ValueError(f"unknown aggregation {aggregation!r}")
        self.num_layers, self.depth = num_layers, depth
        self.base_radius = base_radius
        self.in_features = in_features
        self._bn_args = (bn_mode, bn_eps, bn_momentum)
        self.aggregation, self.agg_kwargs = aggregation, dict(agg_kwargs)
        self.density_parameter = density_parameter
        fdim = base_fdim

        d = self._conv("input_conv", input_feature_width(in_features, fea_dim), fdim)
        d = self._agg("simple_agg", d, fdim, base_radius)
        for i in range(depth):
            d = self._bottleneck(f"res1_btn{i}", d, 2 * fdim, base_radius, bottleneck_ratio)
        dims = [d]
        for stage in range(1, num_layers):
            out = 2 ** (stage + 1) * fdim
            name = f"res{stage + 1}_strided"
            d_mid = out // bottleneck_ratio
            self._conv(f"{name}_conv1", d, d_mid)
            self._agg(f"{name}_agg", d_mid, d_mid, base_radius * 2 ** (stage - 1))
            self._conv(f"{name}_conv3", d_mid, out)
            if d != out:
                self._conv(f"{name}_shortcut", d, out)
            d = out
            for i in range(depth):
                d = self._bottleneck(f"res{stage + 1}_btn{i}", d, out,
                                     base_radius * 2 ** stage, bottleneck_ratio)
            dims.append(d)
        up_dims = [None] * num_layers
        up_dims[-1] = dims[-1]
        for l in range(num_layers - 2, -1, -1):
            d = self._conv(f"up_conv{l}", d + dims[l], 2 ** l * fdim if l > 0 else fdim)
            up_dims[l] = d
        self.use_multihead, self.mlp_depth = use_multihead, mlp_depth
        if use_multihead:
            self.multihead = MultiHead(up_dims, num_classes, base_fdim,
                                       project=contrast_project, contrast_ftype=contrast_ftype,
                                       sep_head=multi_sep_head)
        else:
            for i in range(mlp_depth):
                d = self._conv(self._seg_head(i), d, fdim)
            plain_head(self, d, num_classes, mlp_drop)
        init_like_flax(self, generator if generator is not None
                       else torch.Generator().manual_seed(0))

    @staticmethod
    def _seg_head(i: int) -> str:
        return f"seg_head{i if i else ''}"

    def _conv(self, name, d_in, d_out):
        """Registers the 1×1 ``name``: Dense ``<name>_fc`` (no bias) + BN
        ``<name>_bn``. → d_out."""
        mode, eps, momentum = self._bn_args
        self.add_module(f"{name}_fc", nn.Linear(d_in, d_out, bias=False))
        self.add_module(f"{name}_bn", make_bn(mode, d_out, eps, momentum))
        return d_out

    def _agg(self, name, d_in, d_out, radius):
        kw = dict(self.agg_kwargs)
        if self.aggregation == "pseudo_grid":
            kw.setdefault("density_parameter", self.density_parameter)
            kw["radius"] = radius
        _, eps, momentum = self._bn_args
        self.add_module(name, AGGREGATORS[self.aggregation](
            d_in, d_out, bn_momentum=momentum, bn_eps=eps, **kw))
        return d_out

    def _bottleneck(self, name, d_in, out, radius, ratio):
        d_mid = out // ratio
        self._conv(f"{name}_conv1", d_in, d_mid)
        self._agg(f"{name}_agg", d_mid, d_mid, radius)
        self._conv(f"{name}_conv3", d_mid, out)
        if d_in != out:
            self._conv(f"{name}_shortcut", d_in, out)
        return out

    def _apply_conv(self, name, x, act=True):
        x = getattr(self, f"{name}_bn")(getattr(self, f"{name}_fc")(x))
        return F.relu(x) if act else x

    def _shortcut(self, name, x, out):
        return self._apply_conv(f"{name}_shortcut", x, act=False) if x.shape[-1] != out else x

    def _run_bottleneck(self, name, x, pyr, l, radius):
        """1×1 → aggregation over the level's self search → 1×1, + shortcut."""
        out = getattr(self, f"{name}_conv3_fc").out_features
        y = self._apply_conv(f"{name}_conv1", x)
        y = getattr(self, f"{name}_agg")(pyr.points[l], pyr.points[l], pyr.self_idx[l], y,
                                         radius)
        y = self._apply_conv(f"{name}_conv3", y, act=False)
        return F.relu(y + self._shortcut(name, x, out))

    def _run_strided(self, name, x, pyr, l, radius):
        """Level l → l+1: the aggregation over the pooling search, and the
        max-pool of x over the same neighbours as the shortcut."""
        out = getattr(self, f"{name}_conv3_fc").out_features
        y = self._apply_conv(f"{name}_conv1", x)
        y = getattr(self, f"{name}_agg")(pyr.points[l + 1], pyr.points[l],
                                         pyr.down_idx[l + 1], y, radius)
        y = self._apply_conv(f"{name}_conv3", y, act=False)
        nb, valid = shadow_gather(x, pyr.down_idx[l + 1], fill=0.0)
        sc = torch.where(valid[..., None], nb, _NEG).amax(2)
        return F.relu(y + self._shortcut(name, sc, out))

    def forward(self, features: torch.Tensor, pyramid: Pyramid, with_latents: bool = False,
                dropout_key=None):
        """features [B, N0, fea_dim] (colours) in the pyramid's row order →
        in eval mode logits [B, N0, num_classes]; in train mode, or with
        ``with_latents``, a ModelOutput with the per-stage latents too.
        ``dropout_key`` as PointTransformerSeg's."""
        if pyramid.order0 is not None:
            raise ValueError("ConvNetSeg needs the natural-layout pyramid")
        radius = self.base_radius
        x = build_input_features(pyramid.points[0], features.float(), self.in_features)
        x = self._apply_conv("input_conv", x)
        x = self.simple_agg(pyramid.points[0], pyramid.points[0], pyramid.self_idx[0], x,
                            radius)
        for i in range(self.depth):
            x = self._run_bottleneck(f"res1_btn{i}", x, pyramid, 0, radius)
        down_feats = [x]
        for stage in range(1, self.num_layers):
            x = self._run_strided(f"res{stage + 1}_strided", x, pyramid, stage - 1,
                                  radius * 2 ** (stage - 1))
            for i in range(self.depth):
                x = self._run_bottleneck(f"res{stage + 1}_btn{i}", x, pyramid, stage,
                                         radius * 2 ** stage)
            down_feats.append(x)

        up_feats = [None] * self.num_layers
        up_feats[-1] = down_feats[-1]
        for l in range(self.num_layers - 2, -1, -1):
            up = batch_gather(x, pyramid.up_idx[l + 1][..., 0])
            x = self._apply_conv(f"up_conv{l}", torch.cat([up, down_feats[l]], -1))
            up_feats[l] = x
        contrast = stage_logits = ()
        if self.use_multihead:
            logits, latents, contrast, stage_logits = self.multihead(up_feats, pyramid)
        else:
            for i in range(self.mlp_depth):
                x = self._apply_conv(self._seg_head(i), x)
            logits, latents = apply_plain_head(self, x, dropout_key), ()
        if not (self.training or with_latents):
            return logits
        return ModelOutput(logits=logits, latents=latents, contrast_feats=contrast,
                           stage_logits=stage_logits)
