"""Contrastive Boundary Learning, the flagship configuration (counterpart
of contrastboundary_tpu/losses/contrast.py).

Ported: the soft sub-scene labels and the stage loss on the reference's
dense-window route (``cbl_stage_loss`` :359-395 there, which the flagship
takes on a TPU): softnn over the window-relative contrast neighbours, l2
distances, argmax-equality positives, each stage's masked mean × weight. The statistics run in
ops/cuda/cbl_dense.py (a CUDA kernel for CUDA tensors). The reference's
ContrastConfig options of other routes are not fields here, so they raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.gather import batch_gather
from ..ops.cuda.cbl_dense import cbl_dense_loss


@dataclasses.dataclass(frozen=True)
class ContrastConfig:
    """The fields of the reference's ContrastConfig that the flagship route
    reads, with its defaults. The route itself is fixed: softnn over the
    contrast neighbours, l2 distances, count-normalised positives, the
    stage latents as features, soft sub-scene labels. Options of other
    routes are not fields, so passing one raises."""

    temperature: float = 1.0
    weight: float = 0.1
    stages: Tuple[int, ...] = (0, 1, 2, 3, 4)

    def __post_init__(self):
        if not self.temperature or self.temperature <= 0:
            raise ValueError(f"CBL temperature must be > 0, got {self.temperature}")


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


def cbl_stage_loss(features: torch.Tensor, contrast_idx: torch.Tensor,
                   label_soft: torch.Tensor, cfg: ContrastConfig,
                   local: Tuple[int, int]) -> torch.Tensor:
    """CBL loss of one stage (× cfg.weight): features [B, M, C] and
    label_soft [B, M, ncls] in sorted order, contrast_idx [B, M, K]
    window-relative with local = (tile, width)."""
    if local is None:
        raise ValueError("the port's CBL takes window-relative contrast indices")
    tile, width = local
    return cbl_dense_loss(
        features, label_soft.float(), contrast_idx, float(cfg.temperature),
        tile, width, (width - 1) // 2, weight=cfg.weight,
    )


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
