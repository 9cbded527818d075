"""Point-transformer segmentation backbone with the flagship MultiHead or
the plain mlp head (counterpart of
contrastboundary_tpu/models/pointtransformer.py:30-411).

Two heads are ported: the flagship's ``multi-Ua-concat-latent`` (a latent
tower per up stage, each stage's latent taken to level 0 by its nearest
point, concatenated, one linear classifier) with the branch that feeds the
contrast loss (its feature source ``contrast_ftype``, its projection
``contrast_project`` and the separate towers of ``sep``), and the plain head of the
baseline without CBL (``use_multihead=False``: a latent tower of
``mlp_depth`` layers on level 0, dropout ``mlp_drop``, a linear classifier;
no latents). Submodule names are the flax names. ``dtype`` (float32, or
bfloat16 as the reference's bf16 presets) is every block's compute dtype
(models/blocks.py); the classifier stays float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.gather import batch_gather
from ..ops.pyramid import Pyramid
from ..ops.tile_gather import cross_window_gather
from ..utils.threefry import Key
from .blocks import (
    Dropout, MLPTower, PointTransformerBlock, TransitionDown, TransitionUp, dense,
)
from .init import init_like_flax


@dataclasses.dataclass
class ModelOutput:
    """The JAX ModelOutput fields that training and the feature eval step
    read: logits [B, N0, classes], the per-stage latents [B, N_i,
    base_fdim], the features the CBL runs on (``contrast_feats``: the
    MultiHead's contrast branch, each stage's) and the per-stage branch
    logits [B, N_i, classes] (``stage_logits``, None where not built);
    all three empty under the plain head."""

    logits: torch.Tensor
    latents: Tuple
    contrast_feats: Tuple = ()
    stage_logits: Tuple = ()


class MultiHead(nn.Module):
    """Latent tower per up stage (``latent<i>``: Dense+BN+ReLU to
    ``base_fdim``), nearest-point upsample to level 0, concat, linear ``cls``.
    The upsample is a cross-window gather on the sorted layout's pyramid and
    a row gather of ``near0_idx`` on the natural one, as the reference
    chooses by layout.

    The contrast branch (the reference's MultiHead, models/pointtransformer.py
    :143-211): each stage's ``contrast_ftype`` features, the decoder's f_out,
    the latent, or the float32 ``branch_cls<i>`` logits of the latent (or
    their softmax); with ``sep_head`` from towers of its own
    (``sep_latent<i>``, and ``sep_cls<i>`` where it needs logits) instead of
    the shared ones; then ``project<i>``: '' none, 'linear' a Dense to
    base_fdim, 'mlp' / 'mlp2' one or two Dense+BN+ReLU layers of
    base_fdim."""

    def __init__(self, planes: Sequence[int], num_classes: int, base_fdim: int = 32,
                 bn_mode: str = "batch", dtype: torch.dtype = torch.float32,
                 project: str = "", contrast_ftype: str = "latent", sep_head: bool = False):
        super().__init__()
        self.num_levels = len(planes)
        self.dtype, self.project = dtype, project
        self.contrast_ftype, self.sep_head = contrast_ftype, sep_head
        d = base_fdim
        for i, c in enumerate(planes):
            self.add_module(f"latent{i}", MLPTower(c, (d,), bn_mode, dtype))
        wants_logits = contrast_ftype in ("logits", "probs")
        self.need_logits = wants_logits and not sep_head
        for i in range(self.num_levels):
            if self.need_logits:
                self.add_module(f"branch_cls{i}", nn.Linear(d, num_classes))
        for i, c in enumerate(planes):
            if sep_head:
                self.add_module(f"sep_latent{i}", MLPTower(c, (d,), bn_mode, dtype))
                if wants_logits:
                    self.add_module(f"sep_cls{i}", nn.Linear(d, num_classes))
        source = {"f_out": None, "latent": d, "logits": num_classes, "probs": num_classes}
        for i, c in enumerate(planes):
            c_in = source[contrast_ftype] or c
            if project == "linear":
                self.add_module(f"project{i}", nn.Linear(c_in, d))
            elif project in ("mlp", "mlp2"):
                dims = (d,) if project == "mlp" else (d, d)
                self.add_module(f"project{i}", MLPTower(c_in, dims, bn_mode, dtype))
            elif project:
                raise ValueError(f"unknown contrast projection {project!r}")
        self.cls = nn.Linear(d * len(planes), num_classes)

    def _contrast_feat(self, i, up_feat, latent, logits):
        """Stage i's contrast features, projected."""
        ftype = self.contrast_ftype
        if self.sep_head:  # its towers run (and their statistics move) under f_out too
            latent = getattr(self, f"sep_latent{i}")(up_feat)
            if ftype in ("logits", "probs"):
                logits = getattr(self, f"sep_cls{i}")(latent.float())
        if ftype == "f_out":
            feat = up_feat
        else:
            feat = latent if ftype == "latent" else logits
            if ftype == "probs":
                feat = torch.softmax(feat, -1)
        if self.project == "linear":
            feat = dense(getattr(self, f"project{i}"), feat, self.dtype)
        elif self.project:
            feat = getattr(self, f"project{i}")(feat)
        return feat

    def forward(self, up_feats, pyramid: Pyramid):
        """→ (logits, per-stage latents at their own level, per-stage
        contrast features, per-stage branch logits or None)."""
        collected, latents, contrast, stage_logits = [], [], [], []
        for i in range(self.num_levels):
            lat = getattr(self, f"latent{i}")(up_feats[i])
            latents.append(lat)
            logits = getattr(self, f"branch_cls{i}")(lat.float()) if self.need_logits else None
            stage_logits.append(logits)
            contrast.append(self._contrast_feat(i, up_feats[i], lat, logits))
            if i > 0 and pyramid.near0_meta[i] is not None:  # sorted layout
                t, width, window = pyramid.near0_meta[i]
                li = pyramid.near0_local[i][..., None]
                lat = cross_window_gather(lat, li, lat.shape[1], t, width, window)[
                    ..., 0, :
                ]
            elif i > 0:  # natural layout
                lat = batch_gather(lat, pyramid.near0_idx[i])
            collected.append(lat)
        return (self.cls(torch.cat(collected, -1)), tuple(latents), tuple(contrast),
                tuple(stage_logits))


def plain_head(model: nn.Module, d: int, num_classes: int, drop: Optional[float]) -> None:
    """Register the plain mlp head's dropout ``cls_drop`` (where ``drop``
    is set) and its float32 linear classifier ``cls`` (d → num_classes) on
    ``model``, after its latent tower, at the model's top level as flax
    names them in both architectures."""
    if drop:
        model.cls_drop = Dropout(drop, "cls_drop")
    model.cls = nn.Linear(d, num_classes)


def apply_plain_head(model: nn.Module, y, dropout_key: Optional[Key]):
    """``cls_drop`` (where registered) and ``cls`` on the tower's output."""
    if hasattr(model, "cls_drop"):
        y = model.cls_drop(y, dropout_key)
    return model.cls(y.float())


class PointTransformerSeg(nn.Module):
    """U-shaped point transformer: encoder stage l is TransitionDown plus
    blocks[l] − 1 PointTransformerBlocks, the decoder a TransitionUp and one
    block per level, then the MultiHead (``use_multihead``) or the plain
    head (``cls_tower``: ``mlp_depth`` Dense+BN+ReLU layers of planes[0]
    on level 0, ``cls_drop`` where ``mlp_drop`` is set, ``cls``). Input
    features are rgb; xyz is concatenated in front (in_channels 6). Fresh
    weights are flax's (models/init.py), drawn from ``generator`` (a
    generator seeded 0 where none is given)."""

    def __init__(self, num_classes: int = 13,
                 planes: Sequence[int] = (32, 64, 128, 256, 512),
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 share_planes: int = 8, base_fdim: int = 32, in_features: int = 3,
                 bn_mode: str = "batch", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None, use_multihead: bool = True,
                 mlp_depth: int = 1, mlp_drop: Optional[float] = None,
                 contrast_project: str = "", contrast_ftype: str = "latent",
                 multi_sep_head: bool = False):
        super().__init__()
        self.planes, self.blocks = tuple(planes), tuple(blocks)
        self.dtype = dtype
        nl = len(planes)
        c_in = 3 + in_features
        for l in range(nl):
            stride = 1 if l == 0 else 4
            self.add_module(f"enc{l}_down",
                            TransitionDown(c_in, planes[l], stride, bn_mode, dtype))
            for b in range(1, blocks[l]):
                self.add_module(
                    f"enc{l}_blk{b}",
                    PointTransformerBlock(planes[l], share_planes, bn_mode, dtype),
                )
            c_in = planes[l]
        self.add_module(
            f"dec{nl - 1}_up", TransitionUp(planes[-1], planes[-1], True, bn_mode, dtype)
        )
        self.add_module(
            f"dec{nl - 1}_blk", PointTransformerBlock(planes[-1], share_planes, bn_mode, dtype)
        )
        for l in range(nl - 2, -1, -1):
            self.add_module(f"dec{l}_up",
                            TransitionUp(planes[l + 1], planes[l], False, bn_mode, dtype))
            self.add_module(f"dec{l}_blk",
                            PointTransformerBlock(planes[l], share_planes, bn_mode, dtype))
        self.use_multihead = use_multihead
        if use_multihead:
            self.multihead = MultiHead(planes, num_classes, base_fdim, bn_mode, dtype,
                                       contrast_project, contrast_ftype, multi_sep_head)
        else:
            self.cls_tower = MLPTower(planes[0], (planes[0],) * mlp_depth, bn_mode, dtype)
            plain_head(self, planes[0], num_classes, mlp_drop)
        init_like_flax(self, generator if generator is not None
                       else torch.Generator().manual_seed(0))

    def forward(self, features: torch.Tensor, pyramid: Pyramid, with_latents: bool = False,
                dropout_key: Optional[Key] = None):
        """features [B, N0, in_features] in the pyramid's row order (Morton
        order on the sorted layout, the caller's on the natural one) →
        in eval mode logits [B, N0, num_classes]; in train mode (batch
        statistics in BatchNorm), or with ``with_latents``, a ModelOutput
        with the latents too. ``dropout_key`` is the step's dropout key
        (flax's ``rngs={'dropout': key}``), needed in train mode where the
        plain head has dropout."""
        nl = len(self.planes)
        pts = pyramid.points

        def block(name, l, x):
            return getattr(self, name)(
                x, pyramid.self_idx[l], pyramid.self_rel[l], pyramid.self_local[l]
            )

        def meta(local, metas, l):  # None on the natural layout: global rows
            return None if metas[l] is None else (local[l],) + metas[l]

        x = torch.cat([pts[0], features], -1).to(self.dtype)
        down_feats = []
        for l in range(nl):
            if l == 0:
                x = self.enc0_down(pts[0], x)
            else:
                x = getattr(self, f"enc{l}_down")(
                    pts[l - 1], x, pts[l],
                    meta(pyramid.down_local, pyramid.down_meta, l),
                    pyramid.down_idx[l], pyramid.down_rel[l],
                )
            for b in range(1, self.blocks[l]):
                x = block(f"enc{l}_blk{b}", l, x)
            down_feats.append(x)

        up_feats = [None] * nl
        x = getattr(self, f"dec{nl - 1}_up")(down_feats[-1])
        x = block(f"dec{nl - 1}_blk", nl - 1, x)
        up_feats[-1] = x
        for l in range(nl - 2, -1, -1):
            x = getattr(self, f"dec{l}_up")(
                down_feats[l], x, pyramid.up_w[l + 1],
                meta(pyramid.up_local, pyramid.up_meta, l + 1), pyramid.up_idx[l + 1],
            )
            x = block(f"dec{l}_blk", l, x)
            up_feats[l] = x
        contrast = stage_logits = ()
        if self.use_multihead:
            logits, latents, contrast, stage_logits = self.multihead(up_feats, pyramid)
        else:
            logits = apply_plain_head(self, self.cls_tower(up_feats[0]), dropout_key)
            latents = ()
        if not (self.training or with_latents):
            return logits
        return ModelOutput(logits=logits, latents=latents, contrast_feats=contrast,
                           stage_logits=stage_logits)
