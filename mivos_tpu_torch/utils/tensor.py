"""Tensor utilities: padding, one-hot masks, bf16 parameter casting
(counterpart of mivos_tpu/utils/tensor.py; reference util/tensor_util.py).

Layouts follow the JAX package at the public boundary: frames
(H, W, 3), masks (K, H, W, 1). `pad_divide_by`/`unpad` take the spatial
axes explicitly so NCHW tensors inside the port use the same functions.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Pad = Tuple[int, int, int, int]  # (left_w, right_w, top_h, bottom_h)


def time_buckets(cap: int = 8192) -> Tuple[int, ...]:
    """The JAX session's ladder of video lengths (8, then steps of
    max(8, a quarter) up to `cap`; mivos_tpu/utils/tensor.py:141). The
    query cache's byte cap is held against the length rounded up to it,
    as the JAX session holds it."""
    out = [8]
    while out[-1] < cap:
        out.append(out[-1] + max(8, out[-1] // 4))
    return tuple(out)


def next_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (ascending buckets; the last is a cap)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


def compute_pad(h: int, w: int, d: int = 16) -> Pad:
    """Symmetric padding that rounds (h, w) up to multiples of d; the
    smaller half goes left/top (reference util/tensor_util.py:62-80).
    Returns (lw, uw, lh, uh)."""
    new_h = h + (d - h % d) % d
    new_w = w + (d - w % d) % d
    lh, uh = (new_h - h) // 2, (new_h - h) - (new_h - h) // 2
    lw, uw = (new_w - w) // 2, (new_w - w) - (new_w - w) // 2
    return (lw, uw, lh, uh)


def _hw_axes(x: torch.Tensor, hw_axes: Tuple[int, int]) -> Tuple[int, int]:
    return hw_axes[0] % x.ndim, hw_axes[1] % x.ndim


def pad_divide_by(x: torch.Tensor, d: int = 16,
                  hw_axes: Tuple[int, int] = (-3, -2)):
    """Zero-pad the spatial axes (NHWC default: -3, -2) to multiples of
    d. Returns (padded, pad) with pad = (lw, uw, lh, uh)."""
    h_ax, w_ax = _hw_axes(x, hw_axes)
    lw, uw, lh, uh = compute_pad(x.shape[h_ax], x.shape[w_ax], d)
    # F.pad lists (before, after) pairs from the LAST axis backwards.
    cfg = [0, 0] * (x.ndim - min(h_ax, w_ax))
    cfg[2 * (x.ndim - 1 - h_ax): 2 * (x.ndim - 1 - h_ax) + 2] = [lh, uh]
    cfg[2 * (x.ndim - 1 - w_ax): 2 * (x.ndim - 1 - w_ax) + 2] = [lw, uw]
    return F.pad(x, cfg), (lw, uw, lh, uh)


def unpad(x: torch.Tensor, pad: Pad,
          hw_axes: Tuple[int, int] = (-3, -2)) -> torch.Tensor:
    """Inverse of pad_divide_by (reference util/tensor_util.py:82-94)."""
    lw, uw, lh, uh = pad
    h_ax, w_ax = _hw_axes(x, hw_axes)
    idx = [slice(None)] * x.ndim
    idx[h_ax] = slice(lh, x.shape[h_ax] - uh)
    idx[w_ax] = slice(lw, x.shape[w_ax] - uw)
    return x[tuple(idx)]


def one_hot_mask(labels: torch.Tensor, num_objects: int) -> torch.Tensor:
    """Label map (H, W) -> per-object float masks (K, H, W, 1); object
    ids are 1..num_objects, 0 is background."""
    k = torch.arange(1, num_objects + 1, device=labels.device)
    oh = (labels[None] == k[:, None, None]).to(torch.float32)
    return oh[..., None]


def labels_to_probs(labels, num_objects: int) -> torch.Tensor:
    """Label map (H, W) (numpy or tensor) -> (K+1, H, W, 1) hard fp32
    probabilities, background first (1 - sum of the objects): the mask
    `InferenceCore.interact` takes."""
    fg = one_hot_mask(torch.as_tensor(labels), num_objects)
    return torch.cat([1.0 - fg.sum(0, keepdim=True), fg], dim=0)


def cast_params_bf16(module: nn.Module) -> nn.Module:
    """Pre-cast every conv's weight and bias to bfloat16 IN PLACE,
    keeping FrozenBatchNorm statistics in fp32 (they fold in fp32 and
    cast to the activation dtype, mivos_tpu/utils/tensor.py:20-40).
    `module.to(torch.bfloat16)` would cast the BN buffers too."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.data = m.weight.data.to(torch.bfloat16)
            if m.bias is not None:
                m.bias.data = m.bias.data.to(torch.bfloat16)
    return module
