"""HRNet-W18/32/48 + OCR f-BRS click model, NCHW (counterpart of
mivos_tpu/models/hrnet.py; reference fbrs/model/modeling/hrnet_ocr.py,
fbrs/model/modeling/ocr.py and fbrs/model/is_hrnet_model.py:24-87).

Module names are the reference's attribute paths
(feature_extractor.stage2.0.branches.0.0.conv1,
...stage3.0.fuse_layers.2.0.1.0, ...transition1.1.0.0, ...conv3x3_ocr.0,
...ocr_distri_head.object_context_block.f_pixel.1.0,
...ocr_distri_head.conv_bn_dropout.0, ...aux_head.3, ...cls_head), so a
reference hrnet .pth loads with strict=True and
mivos_tpu/checkpoint/convert.py::convert_fbrs_hrnet maps this
state_dict onto the flax tree. Every BatchNorm is frozen, every resize
is align_corners=True and dropout (eval mode) is left out.

Architecture:
  * stem: two stride-2 3x3 convs (3 -> 64 -> 64), then the Bottleneck
    layer1 (4 blocks, 2 when small);
  * stage s has s branches at strides 4..32 with widths w * 2^i; every
    stride-2 3x3 conv gives ceil(n / 2), and each upsample resizes to the
    exact size of its target branch, so odd sizes (480x854) work;
  * fuse: for j > i a 1x1 conv + BN then an align-corners upsample; for
    j < i a chain of stride-2 3x3 conv + BN, a ReLU after every step but
    the last;
  * head: every branch upsampled to stride 4 and concatenated (15 * w
    channels); aux head, then OCR (spatial gather over the aux logits,
    object-context attention with ocr_width keys, 2 * ocr_width wide),
    then the 1x1 cls head.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.models.fbrs import V1bBasicBlock, V1bBottleneck
from mivos_tpu_torch.models.layers import FrozenBatchNorm, conv1x1, conv3x3
from mivos_tpu_torch.ops.distmaps import dist_maps
from mivos_tpu_torch.ops.resize import bilinear_resize_align_corners as up_ac


def _conv_bn(in_ch: int, out_ch: int, stride: int = 2,
             relu: bool = True) -> nn.Sequential:
    """Bias-free 3x3 conv and FrozenBatchNorm (indices 0, 1), then a ReLU."""
    layers = [conv3x3(in_ch, out_ch, stride=stride, bias=False),
              FrozenBatchNorm(out_ch)]
    return nn.Sequential(*layers, *([nn.ReLU()] if relu else []))


class HRModule(nn.Module):
    """HighResolutionModule (hrnet_ocr.py:13-153): per-branch BasicBlocks,
    then the full cross-resolution fuse."""

    def __init__(self, channels: Sequence[int], num_blocks: int):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[V1bBasicBlock(c, c) for _ in range(num_blocks)])
            for c in channels)
        self.fuse_layers = nn.ModuleList()
        for i in range(n):
            row = nn.ModuleList()
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        conv1x1(channels[j], channels[i], bias=False),
                        FrozenBatchNorm(channels[i])))
                elif j < i:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j],
                                 channels[i] if k == i - j - 1 else channels[j],
                                 relu=k != i - j - 1)
                        for k in range(i - j)]))
                else:
                    row.append(None)
            self.fuse_layers.append(row)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        fused = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                if j == i:
                    y = ys[j]
                elif j > i:
                    y = up_ac(layer(ys[j]), ys[i].shape[-2:])
                else:
                    y = layer(ys[j])
                acc = y if acc is None else acc + y
            fused.append(F.relu(acc))
        return fused


def spatial_gather(feats: torch.Tensor, probs: torch.Tensor) -> torch.Tensor:
    """Class-context vectors (ocr.py:7-27): the feature average weighted
    by a softmax over pixels of each class's logits. feats (B, C, H, W),
    probs (B, K, H, W) -> (B, K, C)."""
    b, c = feats.shape[:2]
    p = torch.softmax(probs.reshape(b, probs.shape[1], -1), dim=2)
    return torch.bmm(p, feats.reshape(b, c, -1).transpose(1, 2))


def _key_proj(in_ch: int, out_ch: int, depth: int) -> nn.Sequential:
    """ObjectAttentionBlock2D's projections (ocr.py:59-88): depth x (bias-
    free 1x1 conv, Sequential(FrozenBatchNorm, ReLU))."""
    layers = []
    for d in range(depth):
        layers += [conv1x1(in_ch if d == 0 else out_ch, out_ch, bias=False),
                   nn.Sequential(FrozenBatchNorm(out_ch), nn.ReLU())]
    return nn.Sequential(*layers)


class _ObjectAttentionBlock(nn.Module):
    """Object-context attention (ocr.py:45-110): pixel queries against one
    key and value per object region, softmax over the regions."""

    def __init__(self, in_ch: int, key_ch: int):
        super().__init__()
        self.key_ch = key_ch
        self.f_pixel = _key_proj(in_ch, key_ch, 2)
        self.f_object = _key_proj(in_ch, key_ch, 2)
        self.f_down = _key_proj(in_ch, key_ch, 1)
        self.f_up = _key_proj(key_ch, in_ch, 1)

    def forward(self, feats: torch.Tensor, proxy: torch.Tensor) -> torch.Tensor:
        """feats (B, C, H, W), proxy (B, K, C) -> context (B, C, H, W)."""
        b, _, h, w = feats.shape
        region = proxy.transpose(1, 2)[..., None]          # (B, C, K, 1)
        q = self.f_pixel(feats).reshape(b, self.key_ch, -1).transpose(1, 2)
        k = self.f_object(region).reshape(b, self.key_ch, -1)
        v = self.f_down(region).reshape(b, self.key_ch, -1).transpose(1, 2)
        sim = torch.softmax(torch.bmm(q, k) * self.key_ch ** -0.5, dim=-1)
        ctx = torch.bmm(sim, v).transpose(1, 2).reshape(b, self.key_ch, h, w)
        return self.f_up(ctx)


class SpatialOCR(nn.Module):
    """SpatialOCR_Module (ocr.py:113-141): the object context concatenated
    before the features, projected back to in_ch."""

    def __init__(self, in_ch: int, key_ch: int):
        super().__init__()
        self.object_context_block = _ObjectAttentionBlock(in_ch, key_ch)
        self.conv_bn_dropout = nn.Sequential(
            conv1x1(2 * in_ch, in_ch, bias=False),
            nn.Sequential(FrozenBatchNorm(in_ch), nn.ReLU()))

    def forward(self, feats: torch.Tensor, proxy: torch.Tensor) -> torch.Tensor:
        ctx = self.object_context_block(feats, proxy)
        return self.conv_bn_dropout(torch.cat([ctx, feats], dim=1))


class HighResolutionNet(nn.Module):
    """HighResolutionNet with OCR (hrnet_ocr.py:155-316): width 18/32/48;
    small halves the block counts and drops a module from stages 3 and 4.
    Binary heads: one class."""

    def __init__(self, width: int = 18, ocr_width: int = 256,
                 small: bool = False):
        super().__init__()
        w, nb = width, 2 if small else 4
        self.conv1 = conv3x3(3, 64, stride=2, bias=False)
        self.bn1 = FrozenBatchNorm(64)
        self.conv2 = conv3x3(64, 64, stride=2, bias=False)
        self.bn2 = FrozenBatchNorm(64)
        self.layer1 = nn.Sequential(
            V1bBottleneck(64, 64, has_downsample=True),
            *[V1bBottleneck(256, 64) for _ in range(1, nb)])

        def new_branch(i, in_ch):
            return nn.Sequential(_conv_bn(in_ch, w * 2 ** i))

        # transitionN[i]: None where branch i passes through; the new
        # branch is a stride-2 conv from the last one.
        self.transition1 = nn.ModuleList(
            [_conv_bn(256, w, stride=1), new_branch(1, 256)])
        self.stage2 = nn.Sequential(HRModule((w, 2 * w), nb))
        self.transition2 = nn.ModuleList([None, None, new_branch(2, 2 * w)])
        self.stage3 = nn.Sequential(*[HRModule((w, 2 * w, 4 * w), nb)
                                      for _ in range(3 if small else 4)])
        self.transition3 = nn.ModuleList([None, None, None,
                                          new_branch(3, 4 * w)])
        self.stage4 = nn.Sequential(*[HRModule((w, 2 * w, 4 * w, 8 * w), nb)
                                      for _ in range(2 if small else 3)])

        last, mid = 15 * w, 2 * ocr_width
        self.aux_head = nn.Sequential(conv1x1(last, last), FrozenBatchNorm(last),
                                      nn.ReLU(), conv1x1(last, 1))
        self.conv3x3_ocr = nn.Sequential(conv3x3(last, mid), FrozenBatchNorm(mid),
                                         nn.ReLU())
        self.ocr_distri_head = SpatialOCR(mid, ocr_width)
        self.cls_head = conv1x1(mid, 1)

    def forward(self, x: torch.Tensor, mode: str = "full"):
        """mode 'full': image -> (cls, aux) logits at stride 4;
        'features': image -> the concatenated stride-4 features (HRNet
        insertion 'A', reference brs.py:146-160); 'head': features ->
        (cls, aux); 'ocr_features': features -> the 2 * ocr_width object-
        context features (insertion 'C', brs.py:215-225); 'cls': those
        features -> cls logits."""
        if mode == "head":
            return self._head(x)
        if mode == "ocr_features":
            return self._ocr(x)[0]
        if mode == "cls":
            return self.cls_head(x)
        feats = self._features(x)
        if mode == "features":
            return feats
        if mode != "full":
            raise ValueError(f"unknown mode {mode}")
        return self._head(feats)

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = [t(x) for t in self.transition1]
        xs = self.stage2(xs)
        for transition, stage in ((self.transition2, self.stage3),
                                  (self.transition3, self.stage4)):
            xs = stage(xs + [transition[-1](xs[-1])])
        size = xs[0].shape[-2:]
        return torch.cat([xs[0]] + [up_ac(t, size) for t in xs[1:]], dim=1)

    def _ocr(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Aux head and the OCR pipeline -> (OCR features, aux logits)."""
        out_aux = self.aux_head(feats)
        f = self.conv3x3_ocr(feats)
        f = self.ocr_distri_head(f, spatial_gather(f, out_aux))
        return f, out_aux

    def _head(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f, out_aux = self._ocr(feats)
        return self.cls_head(f), out_aux


class FBRSHRNetModel(nn.Module):
    """DistMaps, rgb_conv and HRNet-OCR (is_hrnet_model.py:24-66), with the
    f-BRS entry points of FBRSDeepLabModel: head_input/head_replay insert
    scale and bias on the concatenated stride-4 features ('A'),
    head_input_ocr/head_replay_cls on the OCR features ('C'), and
    forward_with_input_bias serves RGB-BRS and DistMap-BRS."""

    def __init__(self, width: int = 18, ocr_width: int = 64,
                 small: bool = False, norm_radius: float = 260.0):
        super().__init__()
        self.width, self.ocr_width, self.small = width, ocr_width, small
        self.norm_radius = norm_radius
        self.rgb_conv = nn.Sequential(conv1x1(5, 8), nn.LeakyReLU(0.2),
                                      FrozenBatchNorm(8), conv1x1(8, 3))
        self.feature_extractor = HighResolutionNet(width, ocr_width, small)

    def _rgb_input(self, image: torch.Tensor, points: torch.Tensor,
                   coord_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """rgb_conv over the image and its click distance maps (plus
        DistMap-BRS's bias)."""
        coord = dist_maps(points, image.shape[-2], image.shape[-1],
                          self.norm_radius)
        if coord_bias is not None:
            coord = coord + coord_bias
        return self.rgb_conv(torch.cat([image, coord], dim=1))

    def head_input(self, image: torch.Tensor,
                   points: torch.Tensor) -> torch.Tensor:
        """-> (B, 15 * width, H/4, W/4) features: insertion 'A' (f-BRS-A
        and f-BRS-B, reference predictors/__init__.py:63)."""
        return self.feature_extractor(self._rgb_input(image, points),
                                      mode="features")

    def head_replay(self, feats: torch.Tensor,
                    out_hw: Tuple[int, int]) -> torch.Tensor:
        out, _ = self.feature_extractor(feats, mode="head")
        return up_ac(out, out_hw)

    def head_input_ocr(self, image: torch.Tensor,
                       points: torch.Tensor) -> torch.Tensor:
        """-> (B, 2 * ocr_width, H/4, W/4) OCR features: insertion 'C'
        (f-BRS-C); only cls_head replays per L-BFGS evaluation."""
        return self.feature_extractor(self.head_input(image, points),
                                      mode="ocr_features")

    def head_replay_cls(self, feats: torch.Tensor,
                        out_hw: Tuple[int, int]) -> torch.Tensor:
        return up_ac(self.feature_extractor(feats, mode="cls"), out_hw)

    def forward_with_input_bias(self, image: torch.Tensor, points: torch.Tensor,
                                rgb_bias: torch.Tensor,
                                coord_bias: torch.Tensor) -> torch.Tensor:
        """Input-space BRS forward (reference InputBRSPredictor,
        brs.py:228-280): additive biases on the RGB input and on the click
        distance maps -> (B, 1, H, W) logits."""
        x = self._rgb_input(image + rgb_bias, points, coord_bias)
        out, _ = self.feature_extractor(x)
        return up_ac(out, image.shape[-2:])

    def forward(self, image: torch.Tensor, points: torch.Tensor,
                with_aux: bool = False):
        """image (B, 3, H, W) normalized, points (B, 2P, 2) (y, x) ->
        (B, 1, H, W) logits, and the aux logits with_aux."""
        hw = image.shape[-2:]
        out, aux = self.feature_extractor(self._rgb_input(image, points))
        out = up_ac(out, hw)
        return (out, up_ac(aux, hw)) if with_aux else out
