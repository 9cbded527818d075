"""Contrastive Boundary Learning, the flagship configuration (counterpart
of contrastboundary_tpu/losses/contrast.py).

Ported: the soft sub-scene labels and the stage loss at the flagship
option point (softnn over the window-relative contrast neighbours, l2 or
norml2 distances, argmax-equality positives, each stage's masked mean ×
weight) on the reference's three routes of ``cbl_stage_loss``, chosen in
its order:

- the dense-window route (ops/cuda/cbl_dense.py), unless the environment
  has CBL_DENSE=off (the reference's switch, ops/pallas/cbl_dense.py:384);
- the fused v2 kernel (ops/cuda/cbl_tile2.py) when ContrastConfig.impl is
  'auto' or 'pallas'; there is no probe and no fallback here: the kernel
  launches, or its build or launch raises;
- otherwise the XLA tile route: the fused [label argmax, validity |
  features] rows gathered by ops/tile_gather.py, then plain tensor ops.

The reference's ContrastConfig options of other option points are not
fields here, so they raise.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.gather import batch_gather
from ..core.masking import EPS, INF, masked_mean
from ..ops.cuda.cbl_dense import cbl_dense_loss
from ..ops.cuda.cbl_tile2 import cbl_tile_softnn2
from ..ops.tile_gather import tile_window_gather

IMPLS = ("xla", "auto", "pallas")
DISTS = ("l2", "norml2")
_LOG_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ContrastConfig:
    """The fields of the reference's ContrastConfig that the flagship option
    point reads, with its defaults: the route is softnn over the contrast
    neighbours, count-normalised positives, the stage latents as features,
    soft sub-scene labels. ``dist`` is 'l2' or 'norml2' (rows normalised
    first); ``impl`` picks the kernel when the dense route is off: 'xla'
    (the tile route) or 'auto' / 'pallas' (the fused v2 kernel). Options of
    other option points are not fields, so passing one raises."""

    temperature: float = 1.0
    weight: float = 0.1
    stages: Tuple[int, ...] = (0, 1, 2, 3, 4)
    dist: str = "l2"
    impl: str = "xla"

    def __post_init__(self):
        if not self.temperature or self.temperature <= 0:
            raise ValueError(f"CBL temperature must be > 0, got {self.temperature}")
        if self.dist not in DISTS:
            raise ValueError(f"CBL dist {self.dist!r} is not ported (only {DISTS})")
        if self.impl not in IMPLS:
            raise ValueError(f"CBL impl {self.impl!r} is not one of {IMPLS}")


def dense_route() -> bool:
    """CBL_DENSE as the reference reads it: unset, 'auto' or 'on' take the
    dense-window route, 'off' skips it; its 'interpret' is a JAX test hook."""
    mode = os.environ.get("CBL_DENSE", "auto")
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"CBL_DENSE={mode!r}: the port takes auto, on or off")
    return mode != "off"


def subscene_labels(labels0: torch.Tensor, subscene_idx: Optional[torch.Tensor],
                    num_classes: int, ignore_label: int = -1) -> torch.Tensor:
    """Soft labels [B, M, ncls] of a level: the mean one-hot of its kr
    nearest level-0 points (``subscene_idx`` [B, M, kr] global rows; None →
    level 0's own one-hot). Ignored labels give a zero row."""
    valid = labels0 != ignore_label
    safe = torch.where(valid, labels0, 0).long()
    onehot = F.one_hot(safe, num_classes).float() * valid[..., None]
    if subscene_idx is None:
        return onehot
    idx = subscene_idx.long().clamp_max(labels0.shape[1] - 1)  # JAX clamps too
    return batch_gather(onehot, idx).mean(-2)


def _tile_route_loss(features, contrast_idx, label_soft, cfg, tile, width):
    """The reference's XLA tile route (losses/contrast.py:341-357, 426-537)
    at the flagship options: the 2-channel label pack [argmax, any valid]
    and the features gathered as one [B, M, K, 2 + C] tensor, then the
    masks, l2 distances with ε inside the sqrt, softnn with the −50 fill,
    and the masked mean. The label pack is data: the gather's gradient for
    its columns stops at the concatenation."""
    center_arg = label_soft.argmax(-1)
    lab_pack = torch.stack([center_arg.float(), (label_soft.sum(-1) > 0).float()], -1)
    fused = torch.cat([lab_pack, features.float()], -1)
    nb = tile_window_gather(fused, contrast_idx, tile, width)
    nb_label, nb_feat = nb[..., :2], nb[..., 2:]
    valid = (contrast_idx < tile * width) & (nb_label[..., 1] > 0.5)
    posmask = center_arg[..., None] == nb_label[..., 0].long()
    validf = valid.float()
    pos_cnt = (posmask * validf).sum(-1)
    valid_cnt = validf.sum(-1)
    center_valid = label_soft.sum(-1) > 0
    point_mask = (pos_cnt > 0) & (pos_cnt < valid_cnt) & center_valid
    posmask = posmask.float() * validf

    dist = torch.sqrt(((features.float()[..., None, :] - nb_feat) ** 2).sum(-1) + _LOG_EPS)
    d = -dist
    d = d - torch.where(valid, d, -INF).amax(-1, keepdim=True).detach()
    d = torch.where(valid, d / cfg.temperature, -50.0)
    e = torch.exp(d) * validf
    loss = -torch.log((e * posmask).sum(-1) / torch.clamp_min(e.sum(-1), EPS) + EPS)
    return masked_mean(loss, point_mask) * cfg.weight


def cbl_stage_loss(features: torch.Tensor, contrast_idx: torch.Tensor,
                   label_soft: torch.Tensor, cfg: ContrastConfig,
                   local: Tuple[int, int]) -> torch.Tensor:
    """CBL loss of one stage (× cfg.weight): features [B, M, C] and
    label_soft [B, M, ncls] in sorted order, contrast_idx [B, M, K]
    window-relative with local = (tile, width)."""
    if local is None:
        raise ValueError("the port's CBL takes window-relative contrast indices")
    tile, width = local
    window = (width - 1) // 2
    if cfg.dist == "norml2":
        features = features / torch.clamp_min(
            torch.linalg.vector_norm(features, dim=-1, keepdim=True), EPS)
    label_soft = label_soft.float()
    if dense_route():
        return cbl_dense_loss(features, label_soft, contrast_idx, float(cfg.temperature),
                              tile, width, window, weight=cfg.weight)
    if cfg.impl in ("auto", "pallas"):
        loss_sum, mask_sum = cbl_tile_softnn2(
            features.float(), label_soft, contrast_idx, float(cfg.temperature), tile,
            width, window,
        )
        return loss_sum.sum() / torch.clamp_min(mask_sum.sum(), 1.0) * cfg.weight
    return _tile_route_loss(features, contrast_idx, label_soft, cfg, tile, width)


def cbl_loss(latents, pyramid, labels0: torch.Tensor, num_classes: int,
             cfg: ContrastConfig, ignore_label: int = -1):
    """Σ over the configured stages → (total, {"cbl_stage<i>": loss})."""
    losses = {}
    total = 0.0
    stages = [i for i in cfg.stages if i < len(latents) and latents[i] is not None]
    for i in stages:
        label_soft = subscene_labels(
            labels0, pyramid.subscene_idx[i], num_classes, ignore_label
        )
        li = cbl_stage_loss(
            latents[i], pyramid.contrast_idx[i], label_soft, cfg,
            pyramid.contrast_local[i],
        )
        losses[f"cbl_stage{i}"] = li
        total = total + li
    return total, losses
