"""Random initialization (counterpart of the `init()` the JAX package
gets from flax, and of mivos_tpu/models/initializer.py), and the
frozen-statistics calibration from-scratch training uses
(`calibrate_frozen_bn`).

Flavour 'default', flax's defaults: convs lecun-normal, a normal
truncated at two standard deviations and rescaled to variance 1/fan_in;
conv biases zero; FrozenBatchNorm scale 1, bias 0, mean 0, var 1.
Random-init towers built this way give banks with the statistics of the
JAX gate's random-init fallback (scripts/pallas_kernel_check.py:97-100).
Flavour 'gluon', the reference's from-scratch distribution
(fbrs/model/initializer.py:11-44, 79-105): then every conv or linear
weight redrawn from XavierGluon (uniform, avg, magnitude 3), biases and
BN betas 0, BN gammas 1, running statistics untouched (`apply_initializer`).
The draws come from a torch.Generator, so they match jax.random's in
distribution, not bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch
from torch import nn

from mivos_tpu_torch.models.layers import FrozenBatchNorm

# Standard deviation of a unit normal truncated to [-2, 2] (flax's
# variance_scaling divides by it so the truncated draw has variance 1).
_TRUNC_STD = 0.87962566103423978


# XavierGluon's defaults (fbrs/model/initializer.py:79-105): uniform
# draws, the factor the average of fan in and fan out, magnitude 3.
GLUON_MAGNITUDE = 3.0


def xavier_gluon(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gluon's Xavier draw into `weight` (a conv's OIHW or a linear's
    (out, in)), in place: uniform in [-s, s], s = sqrt(magnitude /
    ((fan_in + fan_out) / 2)) (mivos_tpu/models/initializer.py:43-66)."""
    rf = int(np.prod(weight.shape[2:])) if weight.ndim > 2 else 1
    fan_in, fan_out = weight.shape[1] * rf, weight.shape[0] * rf
    scale = math.sqrt(GLUON_MAGNITUDE / max((fan_in + fan_out) / 2.0, 1.0))
    return weight.uniform_(-scale, scale, generator=generator)


@torch.no_grad()
def apply_initializer(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The reference's `model.apply(Initializer)` (initializer.py:11-44;
    mivos_tpu/models/initializer.py:69-97), in place: every conv and
    linear weight redrawn by xavier_gluon, one draw per weight in module
    traversal order; every bias and FrozenBatchNorm bias 0, every
    FrozenBatchNorm weight 1; running statistics left as they are."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            xavier_gluon(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, FrozenBatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return module


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator,
                init_flavor: str = "default") -> nn.Module:
    """Initialize every conv and FrozenBatchNorm of `module` in place
    from `generator` (which must live on the parameters' device), in the
    flavour 'default' or 'gluon' (mivos_tpu/models/initializer.py:100-117:
    flax's defaults, then apply_initializer for 'gluon')."""
    if init_flavor not in ("default", "gluon"):
        raise ValueError(f"unknown init_flavor {init_flavor!r}")
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
    if init_flavor == "gluon":
        apply_initializer(module, generator)
    return module


@torch.no_grad()
def calibrate_frozen_bn(net: nn.Module, forward: Callable[[], object],
                        iters: int = 3) -> nn.Module:
    """Write measured input statistics into every FrozenBatchNorm's
    running_mean and running_var, in place (counterpart of
    mivos_tpu/models/initializer.py:120-176).

    A fresh init leaves the frozen statistics at (0, 1), so deep residual
    towers stack variance unnormalized and the first optimizer step can
    saturate the head. Each iteration runs `forward()` (the net on a
    representative batch) with a pre-hook on every FrozenBatchNorm that
    keeps its last call's input, then writes that input's per-channel
    fp32 mean and variance over N, H and W: non-finite means become 0, a
    NaN variance 1, an infinite one 1e30, and the variance is clipped to
    [1e-4, 1e30] so that a constant input cannot re-amplify by
    1/sqrt(eps). Iterated because calibrating upstream shifts downstream
    statistics (depth-35 towers need about 10). Every other tensor and
    buffer is left alone, and the hooks are removed even when `forward`
    raises."""
    inputs: Dict[nn.Module, torch.Tensor] = {}

    def keep_input(module, args):
        inputs[module] = args[0]

    handles = [m.register_forward_pre_hook(keep_input)
               for m in net.modules() if isinstance(m, FrozenBatchNorm)]
    try:
        for _ in range(iters):
            inputs.clear()
            forward()
            for m, x in inputs.items():
                x32 = x.to(torch.float32)
                dims = [d for d in range(x32.ndim) if d != 1]
                mean = x32.mean(dim=dims)
                var = x32.var(dim=dims, unbiased=False)
                m.running_mean.copy_(torch.nan_to_num(
                    mean, nan=0.0, posinf=0.0, neginf=0.0))
                m.running_var.copy_(torch.nan_to_num(
                    var, nan=1.0, posinf=1e30).clamp(1e-4, 1e30))
    finally:
        for h in handles:
            h.remove()
    return net
