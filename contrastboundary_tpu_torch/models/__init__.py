from .convert import (
    flax_path, from_jax_variables, load_checkpoint, load_jax_variables, to_jax_variables,
)
from .convnet import ConvNetSeg
from .init import init_like_flax, lecun_normal_
from .pointtransformer import ModelOutput, MultiHead, PointTransformerSeg

__all__ = [
    "ConvNetSeg", "ModelOutput", "MultiHead", "PointTransformerSeg",
    "flax_path", "from_jax_variables", "init_like_flax", "lecun_normal_", "load_checkpoint",
    "load_jax_variables", "to_jax_variables",
]
