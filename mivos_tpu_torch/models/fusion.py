"""Difference-aware fusion network, NCHW (counterpart of
mivos_tpu/models/fusion.py::FusionNet; reference model/fusion_net.py).

A small residual CNN over 9 channels: RGB(3) + seg1(1) + seg2(1) +
attention(2) + time coefficients(2, broadcast). Submodule names follow
the reference's Sequential indices (conv1.0, conv2.0/conv2.2,
conv3.0/conv3.2, final_conv). The training-time AttentionReadNetwork is
not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.models.layers import conv3x3


class FusionNet(nn.Module):
    """dtype: the compute dtype the session casts the conv weights to."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Sequential(conv3x3(9, 32), nn.ReLU())
        self.conv2 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.conv3 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.final_conv = conv3x3(32, 1)

    def forward(self, im: torch.Tensor, seg1: torch.Tensor, seg2: torch.Tensor,
                attn: torch.Tensor, time_coef: torch.Tensor) -> torch.Tensor:
        """im (K, 3, H, W); seg1/seg2 (K, 1, H, W); attn (K, 2, H, W);
        time_coef (K, 2), broadcast over space. Returns (K, 1, H, W)
        fp32 logits."""
        k, _, h, w = im.shape
        t = time_coef.to(im.dtype)[:, :, None, None].expand(k, 2, h, w)
        x = self.conv1(torch.cat([im, seg1, seg2, attn, t], dim=1))
        x = F.relu(x + self.conv2(x))
        x = F.relu(x + self.conv3(x))
        return self.final_conv(x).to(torch.float32)
