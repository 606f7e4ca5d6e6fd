"""Interpolation ops on NCHW tensors (counterpart of mivos_tpu/ops/resize.py).

The reference uses F.interpolate bilinear with align_corners=False for
upsampling and 'area' for the integer /16 mask downsample; both are
PyTorch's own operators here. f-BRS resizes with align_corners=True
throughout; that variant follows the JAX package's definition, two
interpolation matmuls, because F.interpolate differs from it at an
output size of 1.
"""
from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=64)
def _align_corners_matrix(n_in: int, n_out: int, device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """(n_out, n_in) weights: output i samples input i*(n_in-1)/(n_out-1).
    An output of size 1 averages every input (the JAX definition;
    F.interpolate takes input 0 there). Built in fp32 on the host and
    cached, so a repeated resize (each L-BFGS evaluation's) costs one
    matmul pair and no construction."""
    if n_out == 1:
        m = torch.full((1, n_in), 1.0 / n_in)
    elif n_in == 1:
        m = torch.ones((n_out, 1))
    else:
        rows = torch.arange(n_out)
        src = rows * (n_in - 1) / (n_out - 1)
        lo = src.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(0, n_in - 1)
        w_hi = src - lo
        m = torch.zeros((n_out, n_in))
        m.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
        m.index_put_((rows, hi), w_hi, accumulate=True)
    return m.to(device=device, dtype=dtype)


def bilinear_resize_align_corners(x: torch.Tensor,
                                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W) to (..., h, w) with torch
    align_corners=True sampling (mivos_tpu/ops/resize.py:35-64), as two
    1-D interpolation matmuls in x's dtype."""
    h, w = x.shape[-2:]
    my = _align_corners_matrix(h, out_hw[0], x.device, x.dtype)
    mx = _align_corners_matrix(w, out_hw[1], x.device, x.dtype)
    return my @ x @ mx.t()


def area_downsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Mean-pool (N, C, H, W) by an integer factor (torch mode='area')."""
    h, w = x.shape[-2:]
    if h % factor or w % factor:
        raise ValueError(f"{(h, w)} not divisible by {factor}")
    return F.avg_pool2d(x, factor)
