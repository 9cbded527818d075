"""The optimizers of the reference's recipes (counterpart of
contrastboundary_tpu/train/state.py::make_optimizer): SGD with momentum and
coupled weight decay (the point transformer), the same with gradients
clipped by global norm (the ConvNet), Adam and AdamW; each a torch
optimizer whose update is optax's chain clip → (decay, trace | adam[,
decay]) → learning rate.
"""
from __future__ import annotations

from typing import Callable, Iterable, Optional, Union

import torch

OPTIMIZERS = ("sgd", "adam", "adamw")


def _clip_by_global_norm(max_norm: float) -> Callable:
    """A step pre-hook: optax.clip_by_global_norm over every gradient of the
    optimizer, before its decay and moments. With n the l2 norm of all
    gradients together (float32), each gradient g stays where n < max_norm
    and becomes (g / n)·max_norm otherwise, computed on the device (no
    synchronization)."""
    def hook(optimizer, args, kwargs):
        grads = [p.grad for group in optimizer.param_groups for p in group["params"]
                 if p.grad is not None]
        if not grads:
            return
        norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return hook


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: Union[float, Callable[[int], float]],
                   optimizer: str = "sgd", momentum: float = 0.9,
                   weight_decay: float = 1e-4,
                   grad_clip_norm: Optional[float] = None) -> torch.optim.Optimizer:
    """The reference's optimizer over all ``params``.

    'sgd': optax's add_decayed_weights(wd) → trace(momentum, nesterov=False)
    → scale_by_learning_rate(lr) computes g' = g + wd·p, m ← μ·m + g',
    p ← p − lr·m; ``torch.optim.SGD(momentum=μ, dampening=0,
    nesterov=False, weight_decay=wd)`` is the same update (its first step
    sets m = g', as optax's trace from a zero state does).

    'adam': optax's scale_by_adam() → scale_by_learning_rate(lr), with no
    decay (the reference ignores ``weight_decay`` here): m ← β₁m + (1−β₁)g,
    v ← β₂v + (1−β₂)g², p ← p − lr·m̂/(√v̂ + ε) with m̂ = m/(1−β₁ᵗ), v̂ =
    v/(1−β₂ᵗ), t counted from 1 at the first update (optax increments its
    count before the correction). ``torch.optim.Adam`` takes the same t and
    computes (lr/(1−β₁ᵗ))·m/(√v/√(1−β₂ᵗ) + ε): the same value, rounded in
    another order. β = (0.9, 0.999), ε = 1e-8 in both.

    'adamw': optax's scale_by_adam() → add_decayed_weights(wd) →
    scale_by_learning_rate(lr) gives p ← p − lr·(m̂/(√v̂ + ε) + wd·p) =
    p·(1 − lr·wd) − lr·m̂/(√v̂ + ε), which is ``torch.optim.AdamW``'s
    decoupled decay (p scaled by 1 − lr·wd, then the Adam step).

    ``grad_clip_norm``: the gradients clipped by their global norm first
    (optax.clip_by_global_norm, the chain's first link), by a step
    pre-hook. ``learning_rate`` is a float or a schedule (train/
    schedule.py), of which the groups start at step 0's rate; the caller
    sets each later step's rate with ``set_learning_rate``."""
    lr = learning_rate(0) if callable(learning_rate) else learning_rate
    if optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=momentum, dampening=0.0,
                              nesterov=False, weight_decay=weight_decay)
    elif optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    elif optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}; the port has {OPTIMIZERS}")
    if grad_clip_norm is not None:
        opt.register_step_pre_hook(_clip_by_global_norm(float(grad_clip_norm)))
    return opt


def set_learning_rate(optimizer: torch.optim.Optimizer,
                      learning_rate: Union[float, Callable[[int], float]], count: int) -> float:
    """Set every parameter group's rate to ``learning_rate(count)`` (or the
    constant) before an update; ``count`` is the number of updates applied
    before it, from 0, as optax's scale_by_learning_rate(schedule) counts."""
    lr = learning_rate(count) if callable(learning_rate) else learning_rate
    for group in optimizer.param_groups:
        group["lr"] = lr
    return lr
