"""Learning-rate schedules, per step, parameterized by epoch boundaries
(counterpart of contrastboundary_tpu/train/schedule.py): the point
transformer's multistep (×0.1 at 0.6 and 0.8 of the epochs) and the
ConvNet's exponential per-epoch decay with a floor. Each is a function
step → learning rate computed in float32, where step counts the updates
applied before it from 0, as optax's scale_by_learning_rate counts
(train/state.py::set_learning_rate applies one to an optimizer).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np


def multistep_epoch_decay(base_lr: float, milestones_epochs: Sequence[float],
                          multiplier: float, steps_per_epoch: int) -> Callable[[int], float]:
    """step → learning rate, computed in float32 as optax's
    piecewise_constant_schedule does: the base rate times ``multiplier`` for
    every boundary int(epoch·steps_per_epoch) that ``step`` has reached."""
    boundaries = sorted(int(e * steps_per_epoch) for e in milestones_epochs)

    def schedule(step: int) -> float:
        lr = np.float32(base_lr)
        for bnd in boundaries:
            if step >= bnd:
                lr = np.float32(lr * np.float32(multiplier))
        return float(lr)

    return schedule


def exponential_epoch_decay(base_lr: float, decay_per_epoch: float, steps_per_epoch: int,
                            min_lr: float = 0.0) -> Callable[[int], float]:
    """step → learning rate as optax's exponential_decay(staircase=True,
    end_value=min_lr or None) computes it in float32: base_lr ·
    decay^floor(step / steps_per_epoch) from step 1 on (base_lr at step 0),
    then at least ``min_lr`` (at most, where the rate grows) when it is > 0.

    The power is float32's correctly rounded one. XLA's float32 pow on the
    CPU, which optax's runs through, is one ulp off it at some exponents
    (49 of the first 2,000 at decay 0.9885531); every exponent of the
    first epochs gives optax's bits."""
    if steps_per_epoch <= 0 or decay_per_epoch == 0:
        return lambda step: float(np.float32(base_lr))
    base, rate = np.float32(base_lr), np.float32(decay_per_epoch)
    floor = np.float32(min_lr) if min_lr > 0 else None
    clip = max if decay_per_epoch < 1.0 else min

    def schedule(step: int) -> float:
        if step <= 0:
            lr = base
        else:
            p = np.floor(np.float32(step) / np.float32(steps_per_epoch))
            lr = np.float32(base * np.float32(np.power(np.float64(rate), np.float64(p))))
        if floor is not None:
            lr = clip(lr, floor)
        return float(lr)

    return schedule
