"""Weights from a seed, under the published MiVOS parameter names.

One state dict for the propagation network and one for FusionNet, made
on the device from a `torch.Generator` there in one draw: every
convolution's weight is a slice of one standard-normal tensor, scaled
to variance 1 / fan_in (LeCun normal); biases are zero and every frozen
batch norm is the identity (weight 1, bias 0, mean 0, variance 1). The
names and shapes are the reference networks' (`ivos_bench/reference/
nets.py`), built on the meta device. Values are rounded to the dtype the
configuration serves them in and kept as float32, so that the program
and the reference start from the same numbers.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ivos_bench.reference.nets import FrozenBN, FusionNet, PropagationNetwork

StateDict = Dict[str, torch.Tensor]


def _fills(module: torch.nn.Module) -> Dict[str, float]:
    """The constant of every tensor that is not a convolution weight:
    1 for a frozen batch norm's weight and variance, else 0."""
    fills = {}
    for name, m in module.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(m, FrozenBN):
            fills.update({pre + "weight": 1.0, pre + "bias": 0.0,
                          pre + "running_mean": 0.0, pre + "running_var": 1.0})
        elif isinstance(m, torch.nn.Conv2d) and m.bias is not None:
            fills[pre + "bias"] = 0.0
    return fills


def make_weights(seed: int, dtype: torch.dtype, device,
                 fusion: bool = True) -> Tuple[StateDict, StateDict | None]:
    """(propagation state dict, FusionNet state dict or None) on
    `device` from `seed`, values representable in `dtype`."""
    with torch.device("meta"):
        nets = [PropagationNetwork()] + ([FusionNet()] if fusion else [])
    shapes = [{k: v.shape for k, v in net.state_dict().items()} for net in nets]
    fills = [_fills(net) for net in nets]
    conv_w = [(i, k, s) for i, sh in enumerate(shapes)
              for k, s in sh.items() if k not in fills[i]]
    total = sum(math.prod(s) for _, _, s in conv_w)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out = [{} for _ in nets]
    off = 0
    for i, key, shape in conv_w:
        n = math.prod(shape)
        fan_in = math.prod(shape[1:])
        out[i][key] = (flat[off:off + n].view(shape) / math.sqrt(fan_in)).to(
            dtype).to(torch.float32)
        off += n
    for i, sh in enumerate(shapes):
        for key, value in fills[i].items():
            out[i][key] = torch.full(sh[key], value, device=device)
    return out[0], (out[1] if fusion else None)
