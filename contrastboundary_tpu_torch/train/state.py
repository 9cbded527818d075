"""The flagship optimizer (counterpart of contrastboundary_tpu/train/
state.py::make_optimizer with optimizer='sgd')."""
from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   momentum: float = 0.9, weight_decay: float = 1e-4) -> torch.optim.SGD:
    """SGD with momentum and coupled weight decay over all parameters.

    optax's chain add_decayed_weights(wd) → trace(momentum, nesterov=False)
    → scale_by_learning_rate(lr) computes g' = g + wd·p, m ← μ·m + g',
    p ← p − lr·m; ``torch.optim.SGD(momentum=μ, dampening=0, nesterov=False,
    weight_decay=wd)`` is the same update (its first step sets m = g', as
    optax's trace from a zero state does). A schedule (train/schedule.py)
    is applied by setting each param group's ``lr`` before a step."""
    return torch.optim.SGD(
        params, lr=learning_rate, momentum=momentum, dampening=0.0,
        nesterov=False, weight_decay=weight_decay,
    )
