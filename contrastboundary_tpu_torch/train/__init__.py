from .checkpoint import CheckpointManager, find_best_snapshot
from .debug import dump_nan_state, nan_report, tree_finite
from .schedule import exponential_epoch_decay, multistep_epoch_decay
from .state import make_optimizer, set_learning_rate
from .trainer import Trainer, TrainStepConfig, make_train_step

__all__ = [
    "CheckpointManager", "TrainStepConfig", "Trainer", "dump_nan_state",
    "exponential_epoch_decay", "find_best_snapshot", "make_optimizer", "make_train_step",
    "multistep_epoch_decay", "nan_report", "set_learning_rate", "tree_finite",
]
