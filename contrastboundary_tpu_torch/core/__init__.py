from .gather import batch_gather, shadow_gather

__all__ = ["batch_gather", "shadow_gather"]
