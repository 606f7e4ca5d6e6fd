"""ResNet-50 feature backbone, NCHW, frozen BN
(counterpart of mivos_tpu/models/resnet.py; reference
model/propagation/modules.py:67-89, mod_resnet.py:115-157 and
model/s2m/s2m_resnet.py).

Stride sits on the 3x3 conv of each bottleneck (ResNet v1.5). The
propagation towers stop after layer3 (1/16); the S2M backbone runs
layer4 as well, with its stride replaced by dilation 2 (torchvision's
replace_stride_with_dilation), so it stays at 1/16.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.models.layers import (Conv2d, FrozenBatchNorm, conv1x1,
                                           conv3x3)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, conv_bias: bool = False):
        super().__init__()
        out_ch = planes * self.expansion
        self.conv1 = conv1x1(in_ch, planes, bias=conv_bias)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, stride=stride, dilation=dilation,
                             bias=conv_bias)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv1x1(planes, out_ch, bias=conv_bias)
        self.bn3 = FrozenBatchNorm(out_ch)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                conv1x1(in_ch, out_ch, stride=stride, bias=conv_bias),
                FrozenBatchNorm(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class ResNetStage(nn.Sequential):
    """One layer group: `blocks` bottlenecks. With dilate=True the stage
    keeps stride 1: its first block runs undilated (with the 1x1
    downsample that widens the channels) and the rest at dilation
    `stride` (mivos_tpu/models/resnet.py:79-93)."""

    def __init__(self, in_ch: int, planes: int, blocks: int, stride: int = 1,
                 conv_bias: bool = False, dilate: bool = False):
        first_stride, rest_dilation = (1, stride) if dilate else (stride, 1)
        layers = [Bottleneck(in_ch, planes, first_stride, 1, conv_bias)]
        layers += [Bottleneck(planes * 4, planes, 1, rest_dilation, conv_bias)
                   for _ in range(1, blocks)]
        super().__init__(*layers)


class ResNet50(nn.Module):
    """Feature-pyramid ResNet-50: (N, in_chans, H, W) -> (f16, f8, f4),
    or with num_stages=4 (f32, f16, f8, f4), where f32 is at 1/16 when
    layer4_dilation=2.

    conv_bias: biased convs (the mod_resnet flavour of the 5-channel
    mask encoder). stem_bias: a bias on the stem conv alone (None:
    follow conv_bias; mivos_tpu/models/resnet.py:111). layer1_name: the reference's RGBEncoder calls its
    first stage `res2` (modules.py:76), the other towers `layer1`.
    """

    def __init__(self, in_chans: int = 3, num_stages: int = 3,
                 conv_bias: bool = False, layer1_name: str = "layer1",
                 layer4_dilation: int = 1, stem_bias: Optional[bool] = None):
        super().__init__()
        if num_stages not in (3, 4) or layer4_dilation not in (1, 2):
            raise ValueError(f"num_stages {num_stages}, layer4_dilation "
                             f"{layer4_dilation}: expected 3|4 and 1|2")
        self.conv1 = Conv2d(in_chans, 64, 7, stride=2, padding=3,
                            bias=conv_bias if stem_bias is None else stem_bias)
        self.bn1 = FrozenBatchNorm(64)
        self.layer1_name = layer1_name
        self.add_module(layer1_name, ResNetStage(64, 64, 3, 1, conv_bias))
        self.layer2 = ResNetStage(256, 128, 4, 2, conv_bias)
        self.layer3 = ResNetStage(512, 256, 6, 2, conv_bias)
        self.layer4 = (ResNetStage(1024, 512, 3, 2, conv_bias,
                                   dilate=layer4_dilation > 1)
                       if num_stages == 4 else None)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        f4 = getattr(self, self.layer1_name)(x)
        f8 = self.layer2(f4)
        f16 = self.layer3(f8)
        if self.layer4 is None:
            return f16, f8, f4
        return self.layer4(f16), f16, f8, f4
