from .boundary import BoundaryEvaluator, load_eval_h5, save_eval_h5
from .enumerate import EnumerateEvaluator
from .metrics import AverageMeter, Metrics, confusion_matrix, metrics_from_confusion
from .run import (
    analyze, predict_request, run_boundary_suite, run_enumerate_eval, run_voting_eval,
)
from .step import make_eval_step
from .voting import VotingEvaluator

__all__ = [
    "AverageMeter", "BoundaryEvaluator", "EnumerateEvaluator", "Metrics", "VotingEvaluator",
    "analyze", "confusion_matrix", "load_eval_h5", "make_eval_step", "metrics_from_confusion",
    "predict_request", "run_boundary_suite", "run_enumerate_eval", "run_voting_eval",
    "save_eval_h5",
]
