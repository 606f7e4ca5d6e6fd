"""Shared building blocks, NCHW (counterpart of mivos_tpu/models/layers.py).

Module and attribute names follow the reference's state_dict keys, so
the published .pth files and the JAX parameter trees
(checkpoint/from_jax.py) load with strict=True. A module name contains
"bn" only if it is a FrozenBatchNorm.

Compute dtype: the JAX layers take a `dtype` and cast their inputs to
it (flax Conv(dtype=...)). Here a conv casts its input to its own weight
dtype, so pre-casting the conv weights (utils/tensor.cast_params_bf16)
selects bf16 compute while FrozenBatchNorm statistics stay fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.ops.resize import upsample2x


class Conv2d(nn.Conv2d):
    """nn.Conv2d that runs in its weight's dtype (casts the input)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class SyncBatchNorm(nn.Module):
    """Trainable batch norm with statistics synchronized over processes
    (counterpart of mivos_tpu/models/layers.py::SyncBatchNorm), the
    module over ops/syncbn.py. MiVOS never trains a batch norm (fusion
    training keeps them frozen, reference fusion_model.py:199-200); this
    completes the training surface for fine-tuning the f-BRS click
    models, whose upstream training used SyncBN.

    Training mode normalizes with the batch statistics of every rank of
    `process_group` (None: the default group, when one is up) and
    updates the running averages as the JAX module does: momentum 0.9 on
    the old value and the biased variance (torch.nn.SyncBatchNorm keeps
    the unbiased one). Eval mode applies the running averages.
    Parameters and buffers carry torch's batch-norm names (weight, bias,
    running_mean, running_var); checkpoint/from_jax.py maps flax's
    scale/bias and batch_stats mean/var onto them."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-5,
                 process_group=None):
        super().__init__()
        self.momentum, self.eps, self.process_group = momentum, eps, process_group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from mivos_tpu_torch.ops.syncbn import sync_batch_norm

        shape = (1, -1) + (1,) * (x.ndim - 2)
        if self.training:
            y, (mean, var) = sync_batch_norm(x, self.weight, self.bias,
                                             self.process_group, self.eps)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
            return y
        rs = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * rs).to(x.dtype).view(shape)
        add = (self.bias - self.running_mean * self.weight * rs).to(
            x.dtype).view(shape)
        return x * mul + add


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics, a per-channel affine transform.
    The scale and shift fold in fp32 and are then cast to the
    activation dtype (mivos_tpu/models/layers.py:98-102)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rs = torch.rsqrt(self.running_var + self.eps)
        mul = (self.weight * rs).to(x.dtype).view(1, -1, 1, 1)
        add = (self.bias - self.running_mean * self.weight * rs).to(
            x.dtype).view(1, -1, 1, 1)
        return x * mul + add


def conv3x3(in_ch: int, out_ch: int, stride: int = 1, dilation: int = 1,
            bias: bool = True) -> Conv2d:
    return Conv2d(in_ch, out_ch, 3, stride=stride, padding=dilation,
                  dilation=dilation, bias=bias)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1,
            bias: bool = True) -> Conv2d:
    return Conv2d(in_ch, out_ch, 1, stride=stride, bias=bias)


def conv_bn_relu(in_ch: int, out_ch: int, kernel: int = 1,
                 dilation: int = 1) -> nn.Sequential:
    """Bias-free 1x1 or dilated 3x3 conv, FrozenBatchNorm, ReLU (the
    DeepLab heads' unit; Sequential indices 0, 1, 2)."""
    conv = (conv1x1(in_ch, out_ch, bias=False) if kernel == 1
            else conv3x3(in_ch, out_ch, dilation=dilation, bias=False))
    return nn.Sequential(conv, FrozenBatchNorm(out_ch), nn.ReLU())


class ResBlock(nn.Module):
    """Pre-activation residual block of the propagation decoder
    (reference model/propagation/modules.py:15-35)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.conv1 = conv3x3(in_dim, out_dim)
        self.conv2 = conv3x3(out_dim, out_dim)
        self.downsample = conv3x3(in_dim, out_dim) if in_dim != out_dim else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        if self.downsample is not None:
            x = self.downsample(x)
        return x + r


class UpsampleBlock(nn.Module):
    """Skip-connected 2x upsampling block (reference modules.py:92-104).
    The skip tower (`skip`) is object-independent; sessions precompute
    it per frame in the batched query pre-encode and call with
    preskip=True."""

    def __init__(self, skip_c: int, up_c: int, out_c: int):
        super().__init__()
        self.skip_conv1 = conv3x3(skip_c, up_c)
        self.skip_conv2 = ResBlock(up_c, up_c)
        self.out_conv = ResBlock(up_c, out_c)

    def skip(self, skip_f: torch.Tensor) -> torch.Tensor:
        return self.skip_conv2(self.skip_conv1(skip_f))

    def forward(self, skip_f: torch.Tensor, up_f: torch.Tensor,
                preskip: bool = False) -> torch.Tensor:
        """skip_f: encoder skip features, or with preskip=True the
        already-computed `skip(skip_f)` output (batch 1 or K; it
        broadcasts over the K objects of up_f)."""
        x = skip_f if preskip else self.skip(skip_f)
        x = x + upsample2x(up_f).to(x.dtype)
        return self.out_conv(x)


class KeyValue(nn.Module):
    """3x3 key/value projection heads (reference modules.py:107-114)."""

    def __init__(self, in_dim: int, key_dim: int = 128, val_dim: int = 512):
        super().__init__()
        self.key_proj = conv3x3(in_dim, key_dim)
        self.val_proj = conv3x3(in_dim, val_dim)

    def forward(self, x: torch.Tensor):
        return self.key_proj(x), self.val_proj(x)
