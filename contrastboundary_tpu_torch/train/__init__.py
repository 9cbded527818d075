from .schedule import multistep_epoch_decay
from .state import make_optimizer
from .trainer import TrainStepConfig, make_train_step

__all__ = ["TrainStepConfig", "make_optimizer", "make_train_step", "multistep_epoch_decay"]
