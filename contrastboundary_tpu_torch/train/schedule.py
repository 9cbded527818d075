"""Learning-rate schedule of the flagship (counterpart of
contrastboundary_tpu/train/schedule.py::multistep_epoch_decay): the base rate
times ``multiplier`` at each milestone epoch (the point transformer's ×0.1 at
0.6 and 0.8 of the epochs), per step."""
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
