from .contrast import ContrastConfig, cbl_loss, cbl_stage_loss, subscene_labels
from .segmentation import cross_entropy

__all__ = ["ContrastConfig", "cbl_loss", "cbl_stage_loss", "cross_entropy", "subscene_labels"]
