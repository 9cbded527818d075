from .pipeline import PotentialSampler, crop_around, pad_to_fixed_size, prepare_crop, voxelize
from .s3dis import S3DIS_NAMES, S3DISDataset, SyntheticSceneDataset, make_batch_iterator
from .synthetic import train_batch
from .transforms import (
    Compose,
    chromatic_auto_contrast,
    chromatic_jitter,
    chromatic_translation,
    default_train_transform,
    hue_saturation_translation,
    random_drop_color,
    random_flip,
    random_jitter,
    random_rotate,
    random_scale,
    random_shift,
)

__all__ = [
    "Compose", "PotentialSampler", "S3DIS_NAMES", "S3DISDataset", "SyntheticSceneDataset",
    "chromatic_auto_contrast", "chromatic_jitter", "chromatic_translation", "crop_around",
    "default_train_transform", "hue_saturation_translation", "make_batch_iterator",
    "pad_to_fixed_size", "prepare_crop", "random_drop_color", "random_flip",
    "random_jitter", "random_rotate", "random_scale", "random_shift", "train_batch", "voxelize",
]
