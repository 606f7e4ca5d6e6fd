"""f-BRS interactive segmentation model, NCHW: DistMaps + DeepLabV3+
(dilated ResNetV1b, output stride 8) + separable-conv heads
(counterpart of mivos_tpu/models/fbrs.py; reference
fbrs/model/is_deeplab_model.py and fbrs/model/modeling/
{deeplab_v3,resnetv1b,basic_blocks}.py).

Module names are the reference's attribute paths (rgb_conv.{0,2,3},
feature_extractor.backbone.conv1.{0,1,3,4,6}, ...aspp.concurent.4.gap.1,
...head.block.0.body.1, head.layers.2, ...), so a reference fbrs .pth
loads with strict=True and mivos_tpu/checkpoint/convert.py::convert_fbrs
maps this state_dict onto the flax tree. Every BatchNorm is frozen, every
resize is align_corners=True, and dropout (eval mode) is left out.

The model exposes the entry points the f-BRS predictors use: for each
insertion point a head input (computed once per click) and a head replay
(the differentiable tail the L-BFGS evaluates): `head_input`/
`head_replay` after the ASPP (f-BRS-B), `head_input_c4`/`head_replay_c4`
after c4 (f-BRS-A), `head_input_deeplab`/`head_replay_deeplab` after the
DeepLab head (f-BRS-C); `forward_with_input_bias` for RGB-BRS and
DistMap-BRS; and `forward`, the full network.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.models.layers import (Conv2d, FrozenBatchNorm, conv1x1,
                                           conv3x3, conv_bn_relu)
from mivos_tpu_torch.ops.distmaps import dist_maps
from mivos_tpu_torch.ops.resize import bilinear_resize_align_corners as up_ac

# ASPP dilation rates at output stride 8, and the width c1 is projected
# to before it joins the ASPP output (deeplab_v3.py:39-41, 115-147).
ASPP_RATES = (12, 24, 36)
SKIP_CH = 32


def _downsample(in_ch: int, out_ch: int, stride: int) -> nn.Sequential:
    return nn.Sequential(conv1x1(in_ch, out_ch, stride=stride, bias=False),
                         FrozenBatchNorm(out_ch))


class V1bBottleneck(nn.Module):
    """BottleneckV1b (resnetv1b.py:42-82): the stride and dilation sit on
    the 3x3 conv."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv1x1(in_ch, planes, bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, stride=stride, dilation=dilation,
                             bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.conv3 = conv1x1(planes, planes * 4, bias=False)
        self.bn3 = FrozenBatchNorm(planes * 4)
        self.downsample = (_downsample(in_ch, planes * 4, stride)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class V1bBasicBlock(nn.Module):
    """BasicBlockV1b (resnetv1b.py:6-39): conv1 carries the block's
    dilation, conv2 the stage's."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 dil1: int = 1, dil2: int = 1, has_downsample: bool = False):
        super().__init__()
        self.conv1 = conv3x3(in_ch, planes, stride=stride, dilation=dil1,
                             bias=False)
        self.bn1 = FrozenBatchNorm(planes)
        self.conv2 = conv3x3(planes, planes, dilation=dil2, bias=False)
        self.bn2 = FrozenBatchNorm(planes)
        self.downsample = (_downsample(in_ch, planes, stride)
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


class V1bStage(nn.Sequential):
    """resnetv1b _make_layer (resnetv1b.py:154-197): with dilation d > 1
    the stage keeps stride 1 and its first block runs at d // 2
    (dilation 2 -> first block 1, dilation 4 -> first block 2)."""

    def __init__(self, in_ch: int, planes: int, blocks: int, stride: int = 1,
                 dilation: int = 1, block: str = "bottleneck"):
        first_dil = {1: 1, 2: 1, 4: 2}[dilation]
        if block == "bottleneck":
            out_ch = planes * 4
            layers = [V1bBottleneck(in_ch, planes, stride, first_dil,
                                    stride != 1 or in_ch != out_ch)]
            layers += [V1bBottleneck(out_ch, planes, dilation=dilation)
                       for _ in range(1, blocks)]
        else:
            layers = [V1bBasicBlock(in_ch, planes, stride, first_dil, dilation,
                                    stride != 1 or in_ch != planes)]
            layers += [V1bBasicBlock(planes, planes, dil1=dilation,
                                     dil2=dilation) for _ in range(1, blocks)]
        super().__init__(*layers)


# Reference backbone family (resnetv1b.py:227-266): arch -> stage plan.
RESNETV1B_ARCHS = {
    "resnet34": dict(layers=(3, 4, 6, 3), block="basic", deep_stem=False),
    "resnet50": dict(layers=(3, 4, 6, 3), block="bottleneck", deep_stem=True),
    "resnet101": dict(layers=(3, 4, 23, 3), block="bottleneck",
                      deep_stem=True),
    "resnet152": dict(layers=(3, 8, 36, 3), block="bottleneck",
                      deep_stem=True),
}


class ResNetV1b(nn.Module):
    """Dilated ResNetV1b -> (c1, c2, c3, c4) at strides 4/8/8/8
    (resnetv1b.py:85-214, dilated=True): the deep-stem bottleneck v1s
    variants (3x 3x3 stem convs, stem_width 64 -> 128) and the plain-stem
    basic-block resnet34_v1b."""

    def __init__(self, layers: Tuple[int, int, int, int] = (3, 4, 6, 3),
                 block: str = "bottleneck", deep_stem: bool = True,
                 stem_width: int = 64):
        super().__init__()
        sw = stem_width
        if deep_stem:
            self.conv1 = nn.Sequential(
                conv3x3(3, sw, stride=2, bias=False), FrozenBatchNorm(sw),
                nn.ReLU(), conv3x3(sw, sw, bias=False), FrozenBatchNorm(sw),
                nn.ReLU(), conv3x3(sw, 2 * sw, bias=False))
            in_ch = 2 * sw
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
            in_ch = 64
        self.bn1 = FrozenBatchNorm(in_ch)
        exp = 4 if block == "bottleneck" else 1
        self.layer1 = V1bStage(in_ch, 64, layers[0], block=block)
        self.layer2 = V1bStage(64 * exp, 128, layers[1], stride=2, block=block)
        self.layer3 = V1bStage(128 * exp, 256, layers[2], dilation=2,
                               block=block)
        self.layer4 = V1bStage(256 * exp, 512, layers[3], dilation=4,
                               block=block)
        self.out_channels = (64 * exp, 128 * exp, 256 * exp, 512 * exp)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        c1 = self.layer1(x)
        c2 = self.layer2(c1)
        c3 = self.layer3(c2)
        return c1, c2, c3, self.layer4(c3)


class SeparableConvBNReLU(nn.Module):
    """SeparableConv2d (basic_blocks.py:57-71): depthwise 3x3, pointwise
    1x1, BN, ReLU in `body`."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.body = nn.Sequential(
            Conv2d(in_ch, in_ch, 3, padding=1, groups=in_ch, bias=False),
            conv1x1(in_ch, out_ch, bias=False), FrozenBatchNorm(out_ch),
            nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class _AsppPooling(nn.Module):
    """Global-pool branch (deeplab_v3.py:150-166); its align-corners
    upsample from 1x1 is a broadcast."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.gap = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                 conv1x1(in_ch, out_ch, bias=False),
                                 FrozenBatchNorm(out_ch), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gap(x).expand(-1, -1, *x.shape[-2:])


class FBRSASPP(nn.Module):
    """_ASPP (deeplab_v3.py:115-147): 1x1, three dilated 3x3 (rates
    12/24/36 at output stride 8) and the pooling branch, projected to
    out_ch."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.concurent = nn.ModuleList(
            [conv_bn_relu(in_ch, out_ch)]
            + [conv_bn_relu(in_ch, out_ch, 3, r) for r in ASPP_RATES]
            + [_AsppPooling(in_ch, out_ch)])
        self.project = conv_bn_relu(out_ch * (len(ASPP_RATES) + 2), out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.project(torch.cat([b(x) for b in self.concurent], dim=1))


class _SkipProject(nn.Module):
    """c1 -> SKIP_CH channels (deeplab_v3.py:39-41, 84-98)."""

    def __init__(self, in_ch: int):
        super().__init__()
        self.skip_project = conv_bn_relu(in_ch, SKIP_CH)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.skip_project(x)


class _DeepLabHead(nn.Module):
    """_DeepLabHead (deeplab_v3.py:100-113): two separable convs and a
    biased 1x1."""

    def __init__(self, in_ch: int, ch: int):
        super().__init__()
        self.block = nn.Sequential(SeparableConvBNReLU(in_ch, ch),
                                   SeparableConvBNReLU(ch, ch),
                                   conv1x1(ch, ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class _SepConvHead(nn.Module):
    """SepConvHead (basic_blocks.py:27-52): two separable convs to ch//2
    and a biased 1x1 to one logit."""

    def __init__(self, ch: int):
        super().__init__()
        self.layers = nn.Sequential(SeparableConvBNReLU(ch, ch // 2),
                                    SeparableConvBNReLU(ch // 2, ch // 2),
                                    conv1x1(ch // 2, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x)


class _FeatureExtractor(nn.Module):
    """DeepLabV3Plus (deeplab_v3.py:14-98): backbone, c1 skip projection,
    ASPP over c4 and the DeepLab head."""

    def __init__(self, arch: str, ch: int):
        super().__init__()
        self.backbone = ResNetV1b(**RESNETV1B_ARCHS[arch])
        c1_ch, _, _, c4_ch = self.backbone.out_channels
        self.skip_project = _SkipProject(c1_ch)
        self.aspp = FBRSASPP(c4_ch, ch)
        self.head = _DeepLabHead(ch + SKIP_CH, ch)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """-> (B, ch + SKIP_CH, H/4, W/4): upsampled ASPP output and the
        projected c1."""
        c1, _, _, c4 = self.backbone(x)
        c1 = self.skip_project(c1)
        a = up_ac(self.aspp(c4), c1.shape[-2:])
        return torch.cat([a, c1], dim=1)


class FBRSDeepLabModel(nn.Module):
    """DistMapsModel (is_deeplab_model.py:30-66). `arch` selects the
    ResNetV1b depth; `ch` is deeplab_ch (the reference GUI's
    resnet50_dh128_lvis has 128)."""

    def __init__(self, arch: str = "resnet50", ch: int = 256,
                 norm_radius: float = 260.0):
        super().__init__()
        self.arch, self.ch, self.norm_radius = arch, ch, norm_radius
        self.rgb_conv = nn.Sequential(conv1x1(5, 8), nn.LeakyReLU(0.2),
                                      FrozenBatchNorm(8), conv1x1(8, 3))
        self.feature_extractor = _FeatureExtractor(arch, ch)
        self.head = _SepConvHead(ch)

    def head_input(self, image: torch.Tensor,
                   points: torch.Tensor) -> torch.Tensor:
        """image (B, 3, H, W), points (B, 2P, 2) -> (B, ch + 32, H/4, W/4)
        after-ASPP features: the tensor f-BRS-B scales and biases
        (brs.py:121-140, insertion_mode 'after_aspp')."""
        return self.feature_extractor.features(self._rgb_input(image, points))

    def _rgb_input(self, image: torch.Tensor, points: torch.Tensor,
                   coord_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rgb_conv over the image and its click distance maps (plus
        DistMap-BRS's bias)."""
        coord = dist_maps(points, image.shape[-2], image.shape[-1],
                          self.norm_radius)
        if coord_bias is not None:
            coord = coord + coord_bias
        return self.rgb_conv(torch.cat([image, coord], dim=1))

    def head_replay(self, feats: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
        """The differentiable tail of f-BRS-B (brs.py:82-103): DeepLab
        head, SepConvHead, align-corners upsample to out_hw ->
        (B, 1, h, w) logits."""
        return self.head_replay_deeplab(self.feature_extractor.head(feats),
                                        out_hw)

    def head_input_c4(self, image: torch.Tensor, points: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """f-BRS-A's insertion ('after_c4', brs.py:121-140): the backbone's
        c4 (the scale and bias target) and the projected c1, which stays
        constant through the optimization."""
        c1, _, _, c4 = self.feature_extractor.backbone(
            self._rgb_input(image, points))
        return c4, self.feature_extractor.skip_project(c1)

    def head_replay_c4(self, c4: torch.Tensor, c1: torch.Tensor,
                       out_hw: Tuple[int, int]) -> torch.Tensor:
        """f-BRS-A's replay (brs.py:91-103): ASPP over c4, upsampled and
        joined to the cached c1, then both heads."""
        a = up_ac(self.feature_extractor.aspp(c4), c1.shape[-2:])
        return self.head_replay(torch.cat([a, c1], dim=1), out_hw)

    def head_input_deeplab(self, image: torch.Tensor,
                           points: torch.Tensor) -> torch.Tensor:
        """f-BRS-C's insertion ('after_deeplab', brs.py:54-67): the DeepLab
        feature extractor's output, ch wide; only SepConvHead replays."""
        return self.feature_extractor.head(self.head_input(image, points))

    def head_replay_deeplab(self, feats: torch.Tensor,
                            out_hw: Tuple[int, int]) -> torch.Tensor:
        return up_ac(self.head(feats), out_hw)

    def forward_with_input_bias(self, image: torch.Tensor, points: torch.Tensor,
                                rgb_bias: torch.Tensor,
                                coord_bias: torch.Tensor) -> torch.Tensor:
        """Input-space BRS forward (reference InputBRSPredictor,
        brs.py:228-280): additive biases on the RGB input (RGB-BRS) and
        on the click distance maps (DistMap-BRS) -> (B, 1, H, W) logits."""
        x = self._rgb_input(image + rgb_bias, points, coord_bias)
        return self.head_replay(self.feature_extractor.features(x),
                                image.shape[-2:])

    def forward(self, image: torch.Tensor,
                points: torch.Tensor) -> torch.Tensor:
        """Full forward -> (B, 1, H, W) logits (is_deeplab_model.py:50-66)."""
        return self.head_replay(self.head_input(image, points),
                                image.shape[-2:])
