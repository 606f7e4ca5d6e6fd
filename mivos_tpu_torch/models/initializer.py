"""Random initialization following flax's defaults (counterpart of the
`init()` the JAX package gets from flax).

Convs: lecun-normal, a normal truncated at two standard deviations and
rescaled to variance 1/fan_in; conv biases zero; FrozenBatchNorm scale
1, bias 0, mean 0, var 1. Random-init towers built this way give banks
with the statistics of the JAX gate's random-init fallback
(scripts/pallas_kernel_check.py:97-100).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from mivos_tpu_torch.models.layers import FrozenBatchNorm

# Standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it so the truncated draw has variance 1).
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialize every conv and FrozenBatchNorm of `module` in place
    from `generator` (which must live on the parameters' device)."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    return module
