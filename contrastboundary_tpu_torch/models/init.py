"""Fresh weights as flax initializes the reference's modules.

Every layer of the reference is a flax ``nn.Dense`` with its defaults: the
kernel ``lecun_normal`` (variance_scaling(1, 'fan_in', 'truncated_normal'):
a normal truncated to [−2σ, 2σ] with σ = √(1/fan_in)/0.87962566103423978, so
that the truncated draw has variance 1/fan_in) and a zero bias; flax
``nn.BatchNorm`` starts at scale one, bias zero, mean zero and variance one.
``nn.Linear``'s own default (a Kaiming-uniform weight of a third of that
variance and a nonzero uniform bias) is overwritten. A module with
parameters of another flax initializer draws them in its own
``init_like_flax(generator)`` (the KPConv weights' xavier_uniform,
models/local_aggregation.py).
"""
from __future__ import annotations

import math

import torch
from torch import nn

# the std of a standard normal truncated to [-2, 2]
# (flax.linen.initializers.variance_scaling's constant)
TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Fill an ``nn.Linear`` weight [out, in] in place with flax's
    lecun_normal draw for fan_in = in: Φ⁻¹ of a uniform draw between Φ(−2)
    and Φ(2), times σ = √(1/fan_in)/TRUNC_STD, clamped to [−2σ, 2σ]."""
    std = math.sqrt(1.0 / weight.shape[1]) / TRUNC_STD
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    with torch.no_grad():
        u = torch.empty(weight.shape, dtype=torch.float64)
        u.uniform_(2.0 * lo - 1.0, 2.0 * hi - 1.0, generator=generator)
        w = torch.erfinv(u) * (std * math.sqrt(2.0))
        weight.copy_(w.clamp(-2.0 * std, 2.0 * std))
    return weight


def init_like_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Every ``nn.Linear`` of ``model`` (in module order) drawn by
    ``lecun_normal_`` from ``generator``, with a zero bias, and every
    module with an ``init_like_flax`` method drawn by it from the same
    generator; every other module's parameters and buffers as the port's
    modules build them (the BatchNorms at flax's start)."""
    for module in model.modules():
        if hasattr(module, "init_like_flax"):
            module.init_like_flax(generator)
        if isinstance(module, nn.Linear):
            lecun_normal_(module.weight, generator)
            if module.bias is not None:
                with torch.no_grad():
                    module.bias.zero_()
    return model
