"""Contrastive Boundary Learning (counterpart of
contrastboundary_tpu/losses/contrast.py).

Ported: the soft sub-scene labels and the stage loss of softnn over the
contrast neighbours, l2 or norml2 distances, argmax-equality (``cnt``) or
KL-threshold (``kl``) positives, each stage's masked mean × weight (across
ranks, this rank's share of the mean over the global batch, as the
reference's mean is under its batch-sharded jit). The reference's routes
of ``cbl_stage_loss`` are chosen in its order:

- with window-relative neighbours (the sorted layout, or the natural one's
  tile contrast search, whose stages are first taken in the level's Morton
  order) and cnt positives,
  the dense-window route (ops/cuda/cbl_dense.py), unless the environment
  has CBL_DENSE=off (the reference's switch, ops/pallas/cbl_dense.py:384);
- then, on the same option point, the fused v2 kernel
  (ops/cuda/cbl_tile2.py) when ContrastConfig.impl is 'auto' or 'pallas';
  there is no probe and no fallback here: the kernel launches, or its build
  or launch raises;
- otherwise plain tensor ops over the gathered [labels | features] rows:
  the tile route (ops/tile_gather.py) for window-relative neighbours, the
  global route (a row gather, the natural layout's) for global ones.

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
from ..core.masking import EPS, INF, masked_global_mean
from ..ops.cuda.cbl_dense import cbl_dense_loss
from ..ops.cuda.cbl_tile2 import cbl_tile_softnn2
from ..ops.tile_gather import tile_window_gather
from ..parallel.mesh import global_mean

IMPLS = ("xla", "auto", "pallas")
DISTS = ("l2", "norml2")
POSITIVES = ("cnt", "kl")
_LOG_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ContrastConfig:
    """The fields of the reference's ContrastConfig that the ported option
    points read, with its defaults: softnn over the contrast neighbours,
    the stage latents as features, soft sub-scene labels. ``dist`` is 'l2'
    or 'norml2' (rows normalised first); ``pos`` is 'cnt' (a neighbour is
    positive when its label argmax is the centre's) or 'kl' (when
    KL(centre ‖ neighbour) < ``kl_threshold``); ``impl`` picks the kernel
    when the dense route is off: 'xla' (plain ops) or 'auto' / 'pallas'
    (the fused v2 kernel). Options of other option points are not fields,
    so passing one raises."""

    temperature: float = 1.0
    weight: float = 0.1
    stages: Tuple[int, ...] = (0, 1, 2, 3, 4)
    dist: str = "l2"
    impl: str = "xla"
    pos: str = "cnt"
    kl_threshold: float = 0.5

    def __post_init__(self):
        if self.pos not in POSITIVES:
            raise ValueError(f"CBL pos {self.pos!r} is not one of {POSITIVES}")
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


def _posmask_kl(label_soft, nb_label, threshold):
    """KL(label ‖ neighbour label) < threshold, the `kl` positives, with
    both distributions floored at 1e-12 inside the logs."""
    lab = label_soft[..., None, :]
    kl = (lab * (torch.log(torch.clamp_min(lab, _LOG_EPS))
                 - torch.log(torch.clamp_min(nb_label, _LOG_EPS)))).sum(-1)
    return kl < threshold


def _gathered_loss(features, contrast_idx, label_soft, cfg, gather, shadow):
    """The reference's plain route (losses/contrast.py:341-357, 426-537 of
    the JAX package): the label pack (cnt: the 2 channels [argmax, any
    valid]; kl: the whole distribution) and the features gathered as one
    [B, M, K, n + C] tensor by ``gather``, then the masks, l2 distances
    with ε inside the sqrt, softnn with the −50 fill, and the masked mean.
    The label pack is data: the gather's gradient for its columns stops at
    the concatenation. ``shadow`` is the index of an invalid slot."""
    if cfg.pos == "cnt":
        center_arg = label_soft.argmax(-1)
        lab_pack = torch.stack([center_arg.float(), (label_soft.sum(-1) > 0).float()], -1)
    else:
        lab_pack = label_soft
    n_lab = lab_pack.shape[-1]
    nb = gather(torch.cat([lab_pack, features.float()], -1))
    nb_label, nb_feat = nb[..., :n_lab], nb[..., n_lab:]
    if cfg.pos == "cnt":
        valid = (contrast_idx < shadow) & (nb_label[..., 1] > 0.5)
        posmask = center_arg[..., None] == nb_label[..., 0].long()
    else:
        valid = (contrast_idx < shadow) & (nb_label.sum(-1) > 0)
        posmask = _posmask_kl(label_soft, nb_label, cfg.kl_threshold)
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
    return masked_global_mean(loss, point_mask) * cfg.weight


def cbl_stage_loss(features: torch.Tensor, contrast_idx: torch.Tensor,
                   label_soft: torch.Tensor, cfg: ContrastConfig,
                   local: Optional[Tuple[int, int]]) -> torch.Tensor:
    """CBL loss of one stage (× cfg.weight): features [B, M, C] and
    label_soft [B, M, ncls] in the pyramid's row order, contrast_idx
    [B, M, K]: window-relative with local = (tile, width) (the sorted
    layout, shadow tile·width), or global rows with local None (the natural
    layout, shadow M)."""
    m = features.shape[1]
    if cfg.dist == "norml2":
        features = features / torch.clamp_min(
            torch.linalg.vector_norm(features, dim=-1, keepdim=True), EPS)
    label_soft = label_soft.float()
    if local is None:
        def gather(fused):
            return batch_gather(fused, torch.where(contrast_idx < m, contrast_idx, 0))

        return _gathered_loss(features, contrast_idx, label_soft, cfg, gather, m)
    tile, width = local
    window = (width - 1) // 2
    if cfg.pos == "cnt" and dense_route():
        return cbl_dense_loss(features, label_soft, contrast_idx, float(cfg.temperature),
                              tile, width, window, weight=cfg.weight)
    if cfg.pos == "cnt" and cfg.impl in ("auto", "pallas"):
        loss_sum, mask_sum = cbl_tile_softnn2(
            features.float(), label_soft, contrast_idx, float(cfg.temperature), tile,
            width, window,
        )
        return global_mean(loss_sum.sum(), mask_sum.sum()) * cfg.weight

    def gather(fused):
        return tile_window_gather(fused, contrast_idx, tile, width)

    return _gathered_loss(features, contrast_idx, label_soft, cfg, gather, tile * width)


def cbl_loss(latents, pyramid, labels0: torch.Tensor, num_classes: int,
             cfg: ContrastConfig, ignore_label: int = -1):
    """Σ over the configured stages → (total, {"cbl_stage<i>": loss}).
    Where the natural layout's contrast search ran in tile mode
    (``pyramid.contrast_order[i]`` set) the stage's latents and labels are
    first taken in that order, the rows its window-relative indices name;
    the loss is a masked mean, so nothing is put back."""
    losses = {}
    total = 0.0
    stages = [i for i in cfg.stages if i < len(latents) and latents[i] is not None]
    for i in stages:
        label_soft = subscene_labels(
            labels0, pyramid.subscene_idx[i], num_classes, ignore_label
        )
        feats, order = latents[i], pyramid.contrast_order[i]
        if order is not None:
            feats, label_soft = batch_gather(feats, order), batch_gather(label_soft, order)
        li = cbl_stage_loss(
            feats, pyramid.contrast_idx[i], label_soft, cfg, pyramid.contrast_local[i],
        )
        losses[f"cbl_stage{i}"] = li
        total = total + li
    return total, losses
