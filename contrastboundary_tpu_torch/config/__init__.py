from .base import (
    CONFIGS,
    Config,
    DataConfig,
    EvalConfig,
    ModelConfig,
    OptimConfig,
    load_config,
    register_config,
)
from .dsl import parse_arch_out, parse_contrast_ops, parse_mlp_ops, parse_multi_ops, parse_stage

__all__ = [
    "CONFIGS", "Config", "DataConfig", "EvalConfig", "ModelConfig", "OptimConfig",
    "load_config", "parse_arch_out", "parse_contrast_ops", "parse_mlp_ops",
    "parse_multi_ops", "parse_stage", "register_config",
]
