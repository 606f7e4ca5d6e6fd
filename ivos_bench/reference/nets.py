"""Plain PyTorch MiVOS networks: the propagation network and FusionNet.

Written from MiVOS's `model/propagation/prop_net.py`,
`model/propagation/modules.py`, `model/propagation/mod_resnet.py`,
`model/fusion_net.py` and `model/attn_network.py`: NCHW, float32, no
kernel of any package, parameter names those of the published `.pth`
files. It imports nothing of the program under test.

`Quant` is the one hook the control uses: every convolution and every
matrix product of the read and of the attention read passes its operands
through `quant`, which is the identity in the reference itself and a
rounding to a lower precision in the control (`ivos_bench/reference/
precision.py`).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

Quant = Callable[[torch.Tensor], torch.Tensor]
KEY_DIM, VAL_DIM = 128, 512


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class Conv2d(nn.Conv2d):
    """nn.Conv2d whose operands pass through `self.quant` first."""

    quant: Quant = staticmethod(identity)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.quant
        bias = None if self.bias is None else q(self.bias)
        return F.conv2d(q(x), q(self.weight), bias, self.stride, self.padding,
                        self.dilation, self.groups)


def set_quant(module: nn.Module, quant: Quant) -> nn.Module:
    for m in module.modules():
        if isinstance(m, Conv2d):
            m.quant = quant
    return module


def conv3x3(cin: int, cout: int, stride: int = 1, bias: bool = True) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=bias)


def conv1x1(cin: int, cout: int, stride: int = 1, bias: bool = True) -> Conv2d:
    return Conv2d(cin, cout, 1, stride=stride, bias=bias)


class FrozenBN(nn.Module):
    """BatchNorm2d in eval mode: the published statistics as buffers."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        for name, fill in (("weight", 1.0), ("bias", 0.0),
                           ("running_mean", 0.0), ("running_var", 1.0)):
            self.register_buffer(name, torch.full((c,), fill))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, self.eps)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (stride on the 3x3 conv)."""

    def __init__(self, cin: int, planes: int, stride: int, bias: bool):
        super().__init__()
        cout = planes * 4
        self.conv1 = conv1x1(cin, planes, bias=bias)
        self.bn1 = FrozenBN(planes)
        self.conv2 = conv3x3(planes, planes, stride, bias=bias)
        self.bn2 = FrozenBN(planes)
        self.conv3 = conv1x1(planes, cout, bias=bias)
        self.bn3 = FrozenBN(cout)
        self.downsample = (nn.Sequential(conv1x1(cin, cout, stride, bias=bias),
                                         FrozenBN(cout))
                           if stride != 1 or cin != cout else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(out + res)


def _stage(cin: int, planes: int, blocks: int, stride: int, bias: bool):
    return nn.Sequential(Bottleneck(cin, planes, stride, bias),
                         *[Bottleneck(planes * 4, planes, 1, bias)
                           for _ in range(1, blocks)])


class ResNetTo16(nn.Module):
    """ResNet-50 up to layer3: (f16, f8, f4). The mask encoder
    (MaskRGBEncoder, mod_resnet with biased convs) takes 5 channels; the
    query encoder (RGBEncoder) names its first stage `res2`."""

    def __init__(self, in_chans: int, bias: bool, layer1: str):
        super().__init__()
        self.conv1 = Conv2d(in_chans, 64, 7, stride=2, padding=3, bias=bias)
        self.bn1 = FrozenBN(64)
        self.layer1_name = layer1
        self.add_module(layer1, _stage(64, 64, 3, 1, bias))
        self.layer2 = _stage(256, 128, 4, 2, bias)
        self.layer3 = _stage(512, 256, 6, 2, bias)

    def forward(self, x: torch.Tensor):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        f4 = getattr(self, self.layer1_name)(x)
        f8 = self.layer2(f4)
        return self.layer3(f8), f8, f4


class ResBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv1 = conv3x3(cin, cout)
        self.conv2 = conv3x3(cout, cout)
        self.downsample = conv3x3(cin, cout) if cin != cout else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self.conv2(F.relu(self.conv1(F.relu(x))))
        return (x if self.downsample is None else self.downsample(x)) + r


class UpsampleBlock(nn.Module):
    def __init__(self, skip_c: int, up_c: int, out_c: int):
        super().__init__()
        self.skip_conv1 = conv3x3(skip_c, up_c)
        self.skip_conv2 = ResBlock(up_c, up_c)
        self.out_conv = ResBlock(up_c, out_c)

    def forward(self, skip_f: torch.Tensor, up_f: torch.Tensor) -> torch.Tensor:
        x = self.skip_conv2(self.skip_conv1(skip_f))
        x = x + F.interpolate(up_f, scale_factor=2, mode="bilinear",
                              align_corners=False)
        return self.out_conv(x)


class KeyValue(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.key_proj = conv3x3(cin, KEY_DIM)
        self.val_proj = conv3x3(cin, VAL_DIM)

    def forward(self, x: torch.Tensor):
        return self.key_proj(x), self.val_proj(x)


class Decoder(nn.Module):
    def __init__(self):
        super().__init__()
        self.compress = ResBlock(1024, 512)
        self.up_16_8 = UpsampleBlock(512, 512, 256)
        self.up_8_4 = UpsampleBlock(256, 256, 256)
        self.pred = conv3x3(256, 1)

    def forward(self, f16: torch.Tensor, f8: torch.Tensor,
                f4: torch.Tensor) -> torch.Tensor:
        x = self.up_8_4(f4, self.up_16_8(f8, self.compress(f16)))
        x = self.pred(F.relu(x))
        return F.interpolate(x, scale_factor=4, mode="bilinear",
                             align_corners=False)


class PropagationNetwork(nn.Module):
    """prop_net.py's PropagationNetwork at inference: `memorize`,
    `get_query_values`, `segment_with_query` over an exact top-k read,
    and `get_attention` (AttentionMemory)."""

    def __init__(self, top_k: int = 50):
        super().__init__()
        self.top_k = top_k
        self.quant: Quant = identity
        self.mask_rgb_encoder = ResNetTo16(5, True, "layer1")
        self.rgb_encoder = ResNetTo16(3, False, "res2")
        self.kv_m_f16 = KeyValue(1024)
        self.kv_q_f16 = KeyValue(1024)
        self.decoder = Decoder()

    def memorize(self, frame: torch.Tensor, masks: torch.Tensor):
        """frame (1, 3, H, W), masks (K, 1, H, W) -> keys (K, 128, n) and
        values (K, 512, n), n = H/16 * W/16 (row-major positions)."""
        k = masks.shape[0]
        if k != 1:
            others = torch.cat([masks[[j for j in range(k) if j != i]].sum(
                0, keepdim=True) for i in range(k)])
        else:
            others = torch.zeros_like(masks)
        x = torch.cat([frame.expand(k, -1, -1, -1), masks, others], 1)
        k16, v16 = self.kv_m_f16(self.mask_rgb_encoder(x)[0])
        return k16.flatten(2), v16.flatten(2)

    def get_query_values(self, frame: torch.Tensor):
        """frame (1, 3, H, W) -> (f8, f4, k16, v16)."""
        f16, f8, f4 = self.rgb_encoder(frame)
        k16, v16 = self.kv_q_f16(f16)
        return f8, f4, k16, v16

    def read(self, mem_k: torch.Tensor, mem_v: torch.Tensor,
             qk: torch.Tensor, block_bytes: int = 4 << 30) -> torch.Tensor:
        """The exact top-k read (EvalMemoryReader with softmax_w_top):
        mem_k (K, 128, M), mem_v (K, 512, M), qk (128, N) -> (K, 512, N).
        Query columns go in blocks, so that the (K, block, M) affinity
        stays under `block_bytes`."""
        q = self.quant
        kk, _, m = mem_k.shape
        n = qk.shape[1]
        top = min(self.top_k, m)
        mk, qq = q(mem_k), q(qk)
        mv_rows = q(mem_v).transpose(1, 2).contiguous()          # (K, M, 512)
        step = max(1, min(n, block_bytes // (4 * kk * m)))
        out = []
        for c0 in range(0, n, step):
            qb = qq[:, c0:c0 + step].t().expand(kk, -1, -1)       # (K, n_b, 128)
            aff = torch.bmm(qb, mk) / math.sqrt(KEY_DIM)          # (K, n_b, M)
            vals, idx = torch.topk(aff, top, dim=-1)
            del aff
            w = torch.exp(vals - vals[..., :1])
            w = w / w.sum(-1, keepdim=True)                       # (K, n_b, top)
            rows = torch.stack([mv_rows[o][idx[o]] for o in range(kk)])  # (K, n_b, top, 512)
            out.append(torch.einsum("knt,kntc->kcn", q(w), rows))
        return torch.cat(out, 2)

    def segment(self, mem_k, mem_v, f8, f4, k16, v16) -> torch.Tensor:
        """(K, 1, H, W) sigmoid probabilities of the query frame."""
        kk = mem_k.shape[0]
        h, w = k16.shape[-2:]
        mem = self.read(mem_k, mem_v, k16[0].flatten(1)).view(kk, VAL_DIM, h, w)
        x = torch.cat([mem, v16.expand(kk, -1, -1, -1)], 1)
        return torch.sigmoid(self.decoder(x, f8, f4))

    def get_attention(self, mk16: torch.Tensor, pos: torch.Tensor,
                      neg: torch.Tensor, qk16: torch.Tensor) -> torch.Tensor:
        """mk16 (1, 128, n) keys of the interacted frame, pos/neg
        (1, 1, H, W) mask changes, qk16 (1, 128, h, w) -> (1, 2, H, W)."""
        q = self.quant
        h, w = qk16.shape[-2:]
        aff = torch.bmm(q(mk16).transpose(1, 2), q(qk16.flatten(2)))
        aff = torch.softmax(aff / math.sqrt(KEY_DIM), dim=1)   # (1, M, N)
        maps = [torch.bmm(q(F.interpolate(m, scale_factor=1 / 16, mode="area")
                            .flatten(2)), q(aff)) for m in (pos, neg)]
        attn = torch.cat(maps, 1).view(1, 2, h, w)
        return F.interpolate(attn, scale_factor=16, mode="bilinear",
                             align_corners=False)


class FusionNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(conv3x3(9, 32), nn.ReLU())
        self.conv2 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.conv3 = nn.Sequential(conv3x3(32, 32), nn.ReLU(), conv3x3(32, 32))
        self.final_conv = conv3x3(32, 1)

    def forward(self, im, seg1, seg2, attn, time) -> torch.Tensor:
        h, w = im.shape[-2:]
        time = time.unsqueeze(2).unsqueeze(2).repeat(1, 1, h, w)
        x = self.conv1(torch.cat([im, seg1, seg2, attn, time], 1))
        x = F.relu(x + self.conv2(x))
        x = F.relu(x + self.conv3(x))
        return self.final_conv(x)


def build(state_dict: dict, device, top_k: int = 50,
          fusion: Optional[dict] = None):
    """The reference networks in float32 on `device`, loaded strictly
    from the propagation (and, if given, fusion) state dicts."""
    prop = PropagationNetwork(top_k)
    prop.load_state_dict({k: v.float() for k, v in state_dict.items()})
    fuse = None
    if fusion is not None:
        fuse = FusionNet()
        fuse.load_state_dict({k: v.float() for k, v in fusion.items()})
        fuse = fuse.to(device).eval()
    return prop.to(device).eval(), fuse
