"""The eval step: pyramid, model forward, predictions in the caller's row
order (un-permuted from Morton order on the sorted layout), confusion (counterpart of contrastboundary_tpu/train/trainer.py::
make_eval_step)."""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import torch

from ..core.gather import batch_gather
from ..device import resolve_device
from ..ops.pyramid import PyramidSpec, build_pyramid
from .metrics import confusion_matrix


def make_eval_step(model: torch.nn.Module, spec: PyramidSpec, device="cuda", *,
                   num_classes: int = 13, ignore_label: int = -1,
                   with_features: bool = False, output: str = "probs") -> Callable:
    """Move ``model`` to ``device`` and return step(batch) → (probs [B, N,
    C] f32, confusion [C, C] f32), both on the device, the model in eval
    mode. ``batch`` maps points [B, N, 3], features [B, N, F] and labels
    [B, N] to arrays or tensors in the caller's row order. The eval pyramid
    has no contrast or sub-scene searches.

    ``output='logits'`` returns the raw logits in place of the probs (the
    enumeration protocol accumulates logits). ``with_features=True`` also
    returns {f"latent{i}": [B, N, d_i]}: each stage's latent taken to level
    0 by its nearest point (``pyramid.near0_idx``), in the caller's row
    order, for the feature distances across boundaries."""
    if output not in ("probs", "logits"):
        raise ValueError(f"output must be 'probs' or 'logits', not {output!r}")
    dev = resolve_device(device)
    model = model.to(dev).eval()
    eval_spec = dataclasses.replace(spec, k_contrast=None, with_subscene=False)

    @torch.no_grad()
    def step(batch: Mapping):
        model.eval()  # a train step on the same model may have run since
        points = torch.as_tensor(batch["points"], dtype=torch.float32, device=dev)
        features = torch.as_tensor(batch["features"], dtype=torch.float32, device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        pyramid = build_pyramid(points, eval_spec)
        order0 = pyramid.order0

        def unsort(x):  # sorted layout: back to the caller's rows
            return x if order0 is None else batch_gather(x, inv0)

        if order0 is not None:
            features = batch_gather(features, order0)
            inv0 = torch.empty_like(order0)
            inv0.scatter_(1, order0, torch.arange(order0.shape[1], device=dev).expand_as(order0))
        out = model(features, pyramid, with_latents=with_features)
        logits = out.logits if with_features else out
        probs = logits if output == "logits" else torch.softmax(logits, -1)
        probs = unsort(probs)
        conf = confusion_matrix(probs.argmax(-1), labels, num_classes, ignore_label)
        if not with_features:
            return probs, conf
        feats = {}
        for i, lat in enumerate(out.latents):
            if lat is None:
                continue
            f0 = lat if i == 0 else batch_gather(lat, pyramid.near0_idx[i])
            feats[f"latent{i}"] = unsort(f0)
        return probs, conf, feats

    return step
