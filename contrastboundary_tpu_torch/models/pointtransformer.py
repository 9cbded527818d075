"""Point-transformer segmentation backbone with the flagship MultiHead
(counterpart of contrastboundary_tpu/models/pointtransformer.py:30-411).

Only the flagship head is ported: ``multi-Ua-concat-latent`` (a latent tower
per up stage, each stage's latent taken to level 0 by its nearest point,
concatenated, one linear classifier). Submodule names are the flax names.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from ..ops.pyramid import Pyramid
from ..ops.tile_gather import cross_window_gather
from .blocks import MLPTower, PointTransformerBlock, TransitionDown, TransitionUp


@dataclasses.dataclass
class ModelOutput:
    """The two JAX ModelOutput fields that the flagship's training reads:
    logits [B, N0, classes] and the per-stage latents [B, N_i, base_fdim],
    on which the CBL runs."""

    logits: torch.Tensor
    latents: Tuple


class MultiHead(nn.Module):
    """Latent tower per up stage (``latent<i>``: Dense+BN+ReLU to
    ``base_fdim``), nearest-point upsample to level 0, concat, linear ``cls``."""

    def __init__(self, planes: Sequence[int], num_classes: int, base_fdim: int = 32,
                 bn_mode: str = "batch"):
        super().__init__()
        self.num_levels = len(planes)
        for i, c in enumerate(planes):
            self.add_module(f"latent{i}", MLPTower(c, (base_fdim,), bn_mode))
        self.cls = nn.Linear(base_fdim * len(planes), num_classes)

    def forward(self, up_feats, pyramid: Pyramid):
        """→ (logits, per-stage latents at their own level)."""
        collected, latents = [], []
        for i in range(self.num_levels):
            lat = getattr(self, f"latent{i}")(up_feats[i])
            latents.append(lat)
            if i > 0:
                t, width, window = pyramid.near0_meta[i]
                li = pyramid.near0_local[i][..., None]
                lat = cross_window_gather(lat, li, lat.shape[1], t, width, window)[
                    ..., 0, :
                ]
            collected.append(lat)
        return self.cls(torch.cat(collected, -1)), tuple(latents)


class PointTransformerSeg(nn.Module):
    """U-shaped point transformer: encoder stage l is TransitionDown plus
    blocks[l] − 1 PointTransformerBlocks, the decoder a TransitionUp and one
    block per level, then the MultiHead. Input features are rgb; xyz is
    concatenated in front (in_channels 6)."""

    def __init__(self, num_classes: int = 13,
                 planes: Sequence[int] = (32, 64, 128, 256, 512),
                 blocks: Sequence[int] = (2, 3, 4, 6, 3),
                 share_planes: int = 8, base_fdim: int = 32, in_features: int = 3,
                 bn_mode: str = "batch"):
        super().__init__()
        self.planes, self.blocks = tuple(planes), tuple(blocks)
        nl = len(planes)
        c_in = 3 + in_features
        for l in range(nl):
            stride = 1 if l == 0 else 4
            self.add_module(f"enc{l}_down", TransitionDown(c_in, planes[l], stride, bn_mode))
            for b in range(1, blocks[l]):
                self.add_module(
                    f"enc{l}_blk{b}", PointTransformerBlock(planes[l], share_planes, bn_mode)
                )
            c_in = planes[l]
        self.add_module(
            f"dec{nl - 1}_up", TransitionUp(planes[-1], planes[-1], True, bn_mode)
        )
        self.add_module(
            f"dec{nl - 1}_blk", PointTransformerBlock(planes[-1], share_planes, bn_mode)
        )
        for l in range(nl - 2, -1, -1):
            self.add_module(f"dec{l}_up", TransitionUp(planes[l + 1], planes[l], False, bn_mode))
            self.add_module(f"dec{l}_blk", PointTransformerBlock(planes[l], share_planes, bn_mode))
        self.multihead = MultiHead(planes, num_classes, base_fdim, bn_mode)

    def forward(self, features: torch.Tensor, pyramid: Pyramid):
        """features [B, N0, in_features] in the pyramid's sorted row order →
        in eval mode logits [B, N0, num_classes]; in train mode (batch
        statistics in BatchNorm) a ModelOutput with the latents too."""
        nl = len(self.planes)
        pts = pyramid.points

        def block(name, l, x):
            return getattr(self, name)(
                x, pyramid.self_idx[l], pyramid.self_rel[l], pyramid.self_local[l]
            )

        def meta(local, metas, l):
            return (local[l],) + metas[l]

        x = torch.cat([pts[0], features], -1).float()
        down_feats = []
        for l in range(nl):
            if l == 0:
                x = self.enc0_down(pts[0], x)
            else:
                x = getattr(self, f"enc{l}_down")(
                    pts[l - 1], x, pts[l],
                    meta(pyramid.down_local, pyramid.down_meta, l),
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
                meta(pyramid.up_local, pyramid.up_meta, l + 1),
            )
            x = block(f"dec{l}_blk", l, x)
            up_feats[l] = x
        logits, latents = self.multihead(up_feats, pyramid)
        if not self.training:
            return logits
        return ModelOutput(logits=logits, latents=latents)
