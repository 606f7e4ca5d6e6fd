"""Interpolation ops on NCHW tensors (counterpart of mivos_tpu/ops/resize.py).

The reference uses F.interpolate bilinear with align_corners=False for
upsampling and 'area' for the integer /16 mask downsample; both are
PyTorch's own operators here. The align_corners variant belongs to
f-BRS and is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def bilinear_resize(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) to (N, C, h, w), half-pixel
    centres. Only ever used to upsample, where it equals
    jax.image.resize(method='bilinear')."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    return bilinear_resize(x, (x.shape[-2] * 2, x.shape[-1] * 2))


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Mean-pool (N, C, H, W) by an integer factor (torch mode='area')."""
    h, w = x.shape[-2:]
    if h % factor or w % factor:
        raise ValueError(f"{(h, w)} not divisible by {factor}")
    return F.avg_pool2d(x, factor)
