"""Scribble-to-mask controller (counterpart of
mivos_tpu/interactive/s2m_controller.py; reference
interact/s2m_controller.py and davis_processor.py:38-70).

All K objects run as one batched S2M forward on the session's device
(the reference loops over objects). The 6-channel input is built on
the device in the order RGB, previous hard mask, positive scribbles,
negative scribbles; the DAVIS protocol's 3x3 scribble dilation
(cv2.dilate with a 3x3 ones kernel) is a 3x3 max-pool with -inf
padding, which equals it exactly on 0/1 maps.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.ops.aggregate import aggregate_wbg
from mivos_tpu_torch.utils.tensor import cast_params_bf16, pad_divide_by


class S2MController:
    """ignore_class is usually 255 for GUI scribbles and -1 for DAVIS
    protocol scribbles; 0 is the (real) background label. The net moves
    to `device`; a net whose `dtype` is bfloat16 gets its conv weights
    cast in place (FrozenBatchNorm statistics stay fp32)."""

    def __init__(self, s2m_net: S2MNetwork, num_objects: int,
                 ignore_class: int = 255, dilate_radius: int = 0,
                 device: torch.device | str = "cpu"):
        self.device = torch.device(device)
        self.net = s2m_net.to(self.device).eval()
        if s2m_net.dtype == torch.bfloat16:
            cast_params_bf16(self.net)
        self.num_objects = num_objects
        self.ignore_class = ignore_class
        self.dilate_radius = dilate_radius

    def _scribble_channels(self, scr_mask) -> torch.Tensor:
        """(h, w) indexed scribble map -> (K, 2, h, w) float pos/neg."""
        scr = torch.as_tensor(scr_mask).to(self.device)
        ids = torch.arange(1, self.num_objects + 1,
                           device=self.device)[:, None, None]
        pos = scr[None] == ids
        neg = (scr[None] != ids) & (scr != self.ignore_class)[None]
        srb = torch.stack([pos, neg], dim=1).to(torch.float32)
        if self.dilate_radius > 0:
            # The JAX controller dilates by 3x3 whatever the radius.
            srb = F.max_pool2d(srb, 3, stride=1, padding=1)
        return srb

    @torch.no_grad()
    def interact(self, image: torch.Tensor, prev_mask, scr_mask,
                 aggregate_hard: bool = False) -> torch.Tensor:
        """image: (H, W, 3) PADDED normalized frame. prev_mask: (H, W)
        indexed hard mask (PADDED). scr_mask: (h, w) UNPADDED indexed
        scribble map. Returns (K, H, W, 1) per-object probabilities, or
        the hard-aggregated (K+1, H, W, 1) distribution if
        aggregate_hard."""
        k = self.num_objects
        srb = pad_divide_by(self._scribble_channels(scr_mask), 16,
                            hw_axes=(-2, -1))[0]
        prev = torch.as_tensor(prev_mask).to(self.device)
        ids = torch.arange(1, k + 1, device=self.device)[:, None, None]
        prev_hard = (prev[None] == ids).to(torch.float32)[:, None]
        im = torch.as_tensor(image).to(self.device, torch.float32)
        im = im.movedim(-1, 0)[None].expand(k, -1, -1, -1)
        x = torch.cat([im, prev_hard, srb], dim=1)
        prob = torch.sigmoid(self.net(x)).movedim(1, -1)
        if aggregate_hard:
            return aggregate_wbg(prob, keep_bg=True, hard=True)
        return prob
