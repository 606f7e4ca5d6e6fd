"""Difference-aware fusion network and the training-time attention
reader, NCHW (counterpart of mivos_tpu/models/fusion.py; reference
model/fusion_net.py and model/attn_network.py).

FusionNet is a small residual CNN over 9 channels: RGB(3) + seg1(1) +
seg2(1) + attention(2) + time coefficients(2, broadcast). Submodule
names follow the reference's Sequential indices (conv1.0,
conv2.0/conv2.2, conv3.0/conv3.2, final_conv). It is the only trainable
module; the reader runs frozen.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mivos_tpu_torch.models.layers import KeyValue, conv3x3
from mivos_tpu_torch.models.propagation import KEY_DIM, VAL_DIM
from mivos_tpu_torch.models.resnet import ResNet50
from mivos_tpu_torch.ops.memory_read import full_softmax_affinity
from mivos_tpu_torch.ops.resize import area_downsample, bilinear_resize


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


class AttentionReadNetwork(nn.Module):
    """Frozen training-time attention reader (reference
    attn_network.py:30-80): the propagation network's encoders and f16
    key heads, under its module names, so its weights come from a
    propagation checkpoint (`checkpoint/pth.py::attention_read_state_dict`).
    The trainer freezes its parameters and runs it under no_grad."""

    def __init__(self):
        super().__init__()
        self.mask_rgb_encoder = ResNet50(in_chans=5, conv_bias=True)
        self.rgb_encoder = ResNet50(in_chans=3, conv_bias=False,
                                    layer1_name="res2")
        self.kv_m_f16 = KeyValue(1024, KEY_DIM, VAL_DIM)
        self.kv_q_f16 = KeyValue(1024, KEY_DIM, VAL_DIM)

    def _attention_map(self, f16: torch.Tensor, qk: torch.Tensor,
                       pos: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
        """f16 (B, 1024, h16, w16) memory features, qk (B, N, 128) query
        keys, pos/neg (B, 1, H, W) -> (B, 2, H, W) [pos, neg] maps."""
        b, _, h, w = pos.shape
        # Keys only: the reader reads no values (the JAX reader's value
        # convolutions are dead code that XLA drops).
        mk = self.kv_m_f16.key_proj(f16).flatten(2).transpose(1, 2)  # (B, M, 128)
        aff = full_softmax_affinity(mk, qk)                      # (B, M, N)
        pn = area_downsample(torch.cat([pos, neg], 1), 16).flatten(2)
        attn = torch.matmul(pn.to(torch.float32), aff)           # (B, 2, N)
        return bilinear_resize(attn.reshape(b, 2, h // 16, w // 16), (h, w))

    def forward(self, image: torch.Tensor, mask11: torch.Tensor,
                mask21: torch.Tensor, mask12: torch.Tensor,
                mask22: torch.Tensor, query_image: torch.Tensor):
        """image/query_image (B, 3, H, W), masks (B, 1, H, W): object 1's
        and 2's masks before (x1) and after (x2) the change on `image`.
        Returns the two objects' (B, 2, H, W) attention maps."""
        b = image.shape[0]
        # Both objects' memory encodings in one batch of 2B.
        f16 = self.mask_rgb_encoder(torch.cat([
            torch.cat([image, mask21, mask22], 1),
            torch.cat([image, mask22, mask21], 1)], 0))[0]
        qk = self.kv_q_f16.key_proj(self.rgb_encoder(query_image)[0])
        qk = qk.flatten(2).transpose(1, 2)                        # (B, N, 128)
        attn1 = self._attention_map(f16[:b], qk, (mask21 - mask11).clamp(0, 1),
                                    (mask11 - mask21).clamp(0, 1))
        attn2 = self._attention_map(f16[b:], qk, (mask22 - mask12).clamp(0, 1),
                                    (mask12 - mask22).clamp(0, 1))
        return attn1, attn2
