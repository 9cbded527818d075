from .synthetic import SyntheticSceneDataset, voxelize

__all__ = ["SyntheticSceneDataset", "voxelize"]
