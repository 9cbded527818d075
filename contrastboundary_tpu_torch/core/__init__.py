from .gather import batch_gather, shadow_gather
from .masking import EPS, INF, masked_mean

__all__ = ["EPS", "INF", "batch_gather", "masked_mean", "shadow_gather"]
