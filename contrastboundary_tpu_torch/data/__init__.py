from .synthetic import SyntheticSceneDataset, train_batch, voxelize

__all__ = ["SyntheticSceneDataset", "train_batch", "voxelize"]
