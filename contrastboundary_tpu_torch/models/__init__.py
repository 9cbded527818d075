from .convert import from_jax_variables, load_checkpoint, load_jax_variables
from .pointtransformer import MultiHead, PointTransformerSeg

__all__ = [
    "MultiHead", "PointTransformerSeg",
    "from_jax_variables", "load_checkpoint", "load_jax_variables",
]
