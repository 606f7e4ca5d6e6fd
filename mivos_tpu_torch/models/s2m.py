"""Scribble-to-mask network: DeepLabV3+ / ResNet-50 with a 6-channel stem
(RGB, previous mask, positive and negative scribbles), NCHW
(counterpart of mivos_tpu/models/s2m.py; reference
model/s2m/{s2m_network,s2m_resnet,_deeplab,utils}.py,
deeplabv3plus_resnet50(num_classes=1, output_stride=16)).

Module names are the reference s2m.pth keys (backbone.layer4.0.downsample.0,
classifier.aspp.convs.4.1, classifier.classifier.3, ...), so the .pth
loads with strict=True and mivos_tpu/checkpoint/convert.py::convert_s2m
maps this state_dict onto the flax tree. Sequential indices keep the
port's rule that a name contains "bn" only on a FrozenBatchNorm. Every
conv is bias-free except the final 1x1 classifier. Dropout (eval mode)
is left out: it holds no weights.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.models.layers import (Conv2d, FrozenBatchNorm, conv1x1,
                                           conv3x3, conv_bn_relu)
from mivos_tpu_torch.models.resnet import ResNet50
from mivos_tpu_torch.ops.resize import bilinear_resize


class ASPPPooling(nn.Sequential):
    """Global-pool branch: pool, 1x1 conv, BN, ReLU (conv at index 1, BN
    at 2, as in the reference), broadcast back over the map."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(nn.AdaptiveAvgPool2d(1),
                         Conv2d(in_ch, out_ch, 1, bias=False),
                         FrozenBatchNorm(out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).expand(-1, -1, *x.shape[-2:])


class ASPP(nn.Module):
    """1x1 branch, three dilated 3x3 branches (padding = rate) and the
    pooling branch, projected 1280 -> 256 (reference _deeplab.py:135-164)."""

    def __init__(self, in_ch: int = 2048, rates: Sequence[int] = (6, 12, 18),
                 out_ch: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            [conv_bn_relu(in_ch, out_ch)]
            + [conv_bn_relu(in_ch, out_ch, 3, r) for r in rates]
            + [ASPPPooling(in_ch, out_ch)])
        self.project = conv_bn_relu(out_ch * (len(rates) + 2), out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([c(x) for c in self.convs], dim=1))


class DeepLabHeadV3Plus(nn.Module):
    """Low-level projection (256 -> 48) + ASPP, upsampled to 1/4, then a
    3x3 conv-BN-ReLU and the biased 1x1 classifier
    (reference _deeplab.py:30-53)."""

    def __init__(self, in_ch: int = 2048, low_ch: int = 256,
                 num_classes: int = 1):
        super().__init__()
        self.project = conv_bn_relu(low_ch, 48)
        self.aspp = ASPP(in_ch)
        self.classifier = nn.Sequential(
            conv3x3(48 + 256, 256, bias=False), FrozenBatchNorm(256),
            nn.ReLU(), conv1x1(256, num_classes, bias=True))

    def forward(self, out_feat: torch.Tensor,
                low_feat: torch.Tensor) -> torch.Tensor:
        low = self.project(low_feat)
        x = bilinear_resize(self.aspp(out_feat), low.shape[-2:])
        return self.classifier(torch.cat([low, x], dim=1))


class S2MNetwork(nn.Module):
    """(B, 6, H, W) -> (B, num_classes, H, W) fp32 logits at input size
    (reference s2m_network.py:56-64, utils.py:15-20). dtype: the compute
    dtype a controller casts the conv weights to."""

    def __init__(self, num_classes: int = 1, in_chans: int = 6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.backbone = ResNet50(in_chans=in_chans, num_stages=4,
                                 layer4_dilation=2)
        self.classifier = DeepLabHeadV3Plus(num_classes=num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _, _, low = self.backbone(x)
        logits = self.classifier(out, low).to(torch.float32)
        return bilinear_resize(logits, x.shape[-2:])
