from .convert import (
    from_jax_variables, load_checkpoint, load_jax_variables, to_jax_variables,
)
from .pointtransformer import ModelOutput, MultiHead, PointTransformerSeg

__all__ = [
    "ModelOutput", "MultiHead", "PointTransformerSeg",
    "from_jax_variables", "load_checkpoint", "load_jax_variables", "to_jax_variables",
]
