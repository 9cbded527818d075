"""The train step (counterpart of contrastboundary_tpu/train/trainer.py::
make_train_step): pyramid, features and labels into Morton order, the model
in train mode, cross-entropy plus the 5-stage CBL, backward, the SGD update,
and the confusion of the step's predictions."""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import torch

from ..core.gather import batch_gather
from ..device import resolve_device
from ..eval.metrics import confusion_matrix
from ..losses.contrast import ContrastConfig, cbl_loss
from ..losses.segmentation import cross_entropy
from ..ops.pyramid import PyramidSpec, build_pyramid


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """The fields of the JAX TrainStepConfig that the flagship uses (main
    loss 'xen' with weight 1 and no class weights, no branch loss)."""

    num_classes: int
    spec: PyramidSpec
    contrast: Optional[ContrastConfig] = None
    ignore_label: int = -1


def make_train_step(model: torch.nn.Module, cfg: TrainStepConfig,
                    optimizer: torch.optim.Optimizer, device="cuda") -> Callable:
    """Move ``model`` to ``device`` in train mode and return step(batch) →
    metrics, which updates the model's parameters (through ``optimizer``,
    built over them) and its BatchNorm statistics in place. ``batch`` maps
    points [B, N, 3], features [B, N, F] and labels [B, N] (arrays or
    tensors, any row order). metrics: ce, cbl, cbl_stage<i>, loss (0-d
    tensors) and confusion [C, C], on the device, without gradient."""
    dev = resolve_device(device)
    model.to(dev).train()

    def step(batch: Mapping):
        points = torch.as_tensor(batch["points"], dtype=torch.float32, device=dev)
        features = torch.as_tensor(batch["features"], dtype=torch.float32, device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        pyramid = build_pyramid(points, cfg.spec)
        # the pyramid is in Morton order; every loss below is permutation
        # invariant, so nothing is un-sorted
        features = batch_gather(features, pyramid.order0)
        labels = batch_gather(labels, pyramid.order0)

        out = model(features, pyramid)
        ce = cross_entropy(out.logits, labels, cfg.ignore_label)
        total = ce
        metrics = {"ce": ce}
        if cfg.contrast is not None:
            cb, per_stage = cbl_loss(
                out.latents, pyramid, labels, cfg.num_classes, cfg.contrast, cfg.ignore_label
            )
            total = total + cb
            metrics["cbl"] = cb
            metrics.update(per_stage)
        metrics["loss"] = total

        optimizer.zero_grad(set_to_none=True)
        total.backward()
        optimizer.step()
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["confusion"] = confusion_matrix(
                out.logits.argmax(-1), labels, cfg.num_classes, cfg.ignore_label
            )
        return metrics

    return step
