"""The arithmetic the reference runs in: its own float32 with TF32 off,
or a control one step below a configuration's precision.

A control is the reference put in the program's place and computed in
the nearest precision below the one the configuration states: TF32 for
a float32 configuration (TF32 off), float8 (e4m3, one scale a tensor)
for a bfloat16 one. A control has to come out as not correct.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch

from ivos_bench.reference.nets import identity, set_quant

FP8_MAX = 448.0   # the largest finite float8_e4m3fn
# The control of a configuration, by the dtype it states.
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale (amax / 448), back in
    x's dtype."""
    scale = x.detach().abs().amax().float().clamp_min(1e-30) / FP8_MAX
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


@contextlib.contextmanager
def tf32(enabled: bool) -> Iterator[None]:
    """TF32 on or off for cuDNN convolutions and matrix products inside
    the block; the process's settings come back after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def arithmetic(name: str, nets) -> tuple[contextlib.AbstractContextManager,
                                         Callable[[torch.Tensor], torch.Tensor]]:
    """(context to run in, rounding of stored tensors) for `name`:
    'fp32' the reference, 'tf32' and 'fp8' the controls. Sets the
    rounding on every convolution and on the reads of `nets`."""
    if name not in ("fp32", "tf32", "fp8"):
        raise ValueError(f"unknown arithmetic {name!r}")
    quant = fp8_round if name == "fp8" else identity
    for net in nets:
        if net is not None:
            set_quant(net, quant)
            if hasattr(net, "quant"):
                net.quant = quant
    return tf32(name == "tf32"), quant
