"""The train step (counterpart of contrastboundary_tpu/train/trainer.py::
make_train_step): pyramid, features and labels into its row order (Morton
order on the sorted layout, the caller's on the natural one), the model in
train mode, the main loss (cross-entropy, optionally class-weighted, the
binary sigmoid cross-entropy or none, times its weight) plus the 5-stage
CBL on the MultiHead's contrast features (its ``rand<k>`` rows keyed by the
update count), backward, the optimizer's update, and the confusion of the step's
predictions; and ``Trainer``, the minimal epoch loop over it
(::Trainer)."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Mapping, Optional

import torch

from ..core.gather import batch_gather
from ..device import resolve_device
from ..eval.metrics import AverageMeter, confusion_matrix, metrics_from_confusion
from ..losses.contrast import ContrastConfig, cbl_loss
from ..losses.segmentation import cross_entropy, sigmoid_cross_entropy
from ..ops.pyramid import PyramidSpec, build_pyramid
from ..parallel.mesh import all_reduce_grads, all_reduce_metrics
from ..utils import threefry
from .state import set_learning_rate

MAIN_LOSSES = ("xen", "sigmoid", "none")
DROPOUT_SEED = 17  # the JAX trainer's: rngs={'dropout': fold_in(PRNGKey(17), step)}
CBL_SEED = 13  # the JAX trainer's key of the rand<k> rows: fold_in(PRNGKey(13), step)


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    """The fields of the JAX TrainStepConfig that the port's heads use (no
    branch loss): the main loss ``main_loss`` (xen | sigmoid | none) times
    ``main_weight``, the xen's per-class weights ``class_weights`` (a
    tuple, indexed by the label clipped to the classes), and
    ``has_dropout``, which threads the dropout key into the model."""

    num_classes: int
    spec: PyramidSpec
    contrast: Optional[ContrastConfig] = None
    ignore_label: int = -1
    main_loss: str = "xen"
    main_weight: float = 1.0
    class_weights: Optional[tuple] = None
    has_dropout: bool = False


def dropout_key(step: int) -> threefry.Key:
    """The dropout key of the update ``step`` (updates applied before it),
    the JAX trainer's ``fold_in(PRNGKey(17), state.step)``."""
    return threefry.fold_in(threefry.prng_key(DROPOUT_SEED), step)


def cbl_key(step: int) -> threefry.Key:
    """The key of the CBL's ``rand<k>`` rows at the update ``step``, the
    JAX trainer's ``fold_in(PRNGKey(13), state.step)``."""
    return threefry.fold_in(threefry.prng_key(CBL_SEED), step)


def main_loss(cfg: TrainStepConfig, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The unweighted main loss of ``cfg`` (JAX train_step's): sigmoid,
    none (0), or xen with the class weights where given."""
    if cfg.main_loss == "sigmoid":
        return sigmoid_cross_entropy(logits, labels, cfg.ignore_label)
    if cfg.main_loss == "none":
        return torch.zeros((), device=logits.device)
    if cfg.main_loss != "xen":
        raise ValueError(f"main_loss {cfg.main_loss!r} is not one of {MAIN_LOSSES}")
    pw = None
    if cfg.class_weights is not None:
        table = torch.tensor(cfg.class_weights, dtype=torch.float32, device=logits.device)
        pw = table[labels.clamp(0, len(cfg.class_weights) - 1)]
    return cross_entropy(logits, labels, cfg.ignore_label, weight=pw)


def make_train_step(model: torch.nn.Module, cfg: TrainStepConfig,
                    optimizer: torch.optim.Optimizer, device="cuda",
                    start_step: int = 0) -> Callable:
    """Move ``model`` to ``device`` and return step(batch) → metrics, which
    puts the model in train mode and updates its parameters (through
    ``optimizer``, built over them) and its BatchNorm statistics in place.
    ``batch`` maps points [B, N, 3], features [B, N, F] and labels [B, N]
    (arrays or tensors, any row order): this rank's share of the global
    batch. metrics: ce, cbl, cbl_stage<i>, loss (0-d tensors) and
    confusion [C, C] of the global batch, on the device, without
    gradient. The step counts the updates it applies from ``start_step``
    (``step.count``, JAX's ``state.step``), which keys the dropout."""
    dev = resolve_device(device)
    model.to(dev)

    def step(batch: Mapping):
        model.train()  # an eval step on the same model may have run since
        points = torch.as_tensor(batch["points"], dtype=torch.float32, device=dev)
        features = torch.as_tensor(batch["features"], dtype=torch.float32, device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev).long()
        pyramid = build_pyramid(points, cfg.spec)
        if pyramid.order0 is not None:
            # the sorted layout's pyramid is in Morton order; every loss
            # below is permutation invariant, so nothing is un-sorted
            features = batch_gather(features, pyramid.order0)
            labels = batch_gather(labels, pyramid.order0)

        key = dropout_key(step.count) if cfg.has_dropout else None
        out = model(features, pyramid, dropout_key=key)
        ce = main_loss(cfg, out.logits, labels)
        total = cfg.main_weight * ce
        metrics = {"ce": ce}
        if cfg.contrast is not None:
            # the MultiHead's contrast branch where it has one, else the latents
            feats = (out.contrast_feats if any(f is not None for f in out.contrast_feats)
                     else out.latents)
            rand_key = cbl_key(step.count) if cfg.contrast.extra_neg_rand else None
            cb, per_stage = cbl_loss(feats, pyramid, labels, cfg.num_classes, cfg.contrast,
                                     cfg.ignore_label, key=rand_key)
            total = total + cb
            metrics["cbl"] = cb
            metrics.update(per_stage)
        metrics["loss"] = total

        optimizer.zero_grad(set_to_none=True)
        if total.requires_grad:
            total.backward()
        else:  # main loss 'none' and no CBL: JAX's gradient is zero, decay still applies
            for p in model.parameters():
                p.grad = torch.zeros_like(p)
        all_reduce_grads(model.parameters())
        optimizer.step()
        step.count += 1
        with torch.no_grad():
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics["confusion"] = confusion_matrix(
                out.logits.argmax(-1), labels, cfg.num_classes, cfg.ignore_label
            )
        return all_reduce_metrics(metrics)

    step.count = int(start_step)
    return step


class Trainer:
    """Minimal epoch loop: meters, periodic logging, the summed confusion
    and steps/s. ``schedule`` (train/schedule.py) sets every parameter
    group's rate before each update at the update count, from ``step`` (0
    for a fresh run), as optax's scale_by_learning_rate(schedule) counts;
    without one the optimizer's rates stay as they are."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 cfg: TrainStepConfig, schedule: Optional[Callable[[int], float]] = None,
                 device="cuda", log_fn: Callable = print, step: int = 0):
        self.model, self.optimizer, self.cfg = model, optimizer, cfg
        self.schedule = schedule
        self.step = step
        self.train_step = make_train_step(model, cfg, optimizer, device, start_step=step)
        self.log = log_fn

    def train_epoch(self, batches: Iterable, log_freq: int = 10) -> Dict[str, float]:
        meters: Dict[str, AverageMeter] = {}
        conf_sum = None
        t0 = time.time()
        n = 0
        for i, batch in enumerate(batches):
            if self.schedule is not None:
                set_learning_rate(self.optimizer, self.schedule, self.step)
            metrics = self.train_step(batch)
            self.step += 1
            conf = metrics.pop("confusion")
            conf_sum = conf if conf_sum is None else conf_sum + conf
            for k, v in metrics.items():
                meters.setdefault(k, AverageMeter()).update(float(v))
            n += 1
            if log_freq and (i + 1) % log_freq == 0:
                self.log(f"step {i + 1}: "
                         + " ".join(f"{k}={m.avg:.4f}" for k, m in meters.items()))
        out = {k: m.avg for k, m in meters.items()}
        if conf_sum is not None:
            m = metrics_from_confusion(conf_sum.cpu().numpy())
            out.update({k: m[k] for k in ("mIoU", "OA", "mACC")})
        out["steps_per_sec"] = n / max(time.time() - t0, 1e-9)
        return out
