from .metrics import AverageMeter, confusion_matrix, metrics_from_confusion
from .step import make_eval_step
from .voting import VotingEvaluator

__all__ = [
    "AverageMeter", "VotingEvaluator", "confusion_matrix", "make_eval_step",
    "metrics_from_confusion",
]
