"""Junction between the DAVIS interactive protocol and InferenceCore
(counterpart of mivos_tpu/core/davis_processor.py; reference
davis_processor.py).

Per interaction round: rasterize the round's scribbles, run S2M for all
objects against the current hard mask, then either propagate + fuse or
only store the frame, following the reference's [2, 5, 7] schedule
(davis_processor.py:34): propagation happens on the processor's 3rd,
6th and 8th interactions, the others update the interacted frame only.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.interactive.s2m_controller import S2MController
from mivos_tpu_torch.interactive.scribbles import (scribbles2mask,
                                                   select_single_frame)
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork


class DAVISProcessor:
    def __init__(self, prop_net: PropagationNetwork,
                 fuse_net: Optional[FusionNet], s2m_net: S2MNetwork, images,
                 num_objects: int, mem: MemoryConfig = MemoryConfig(),
                 device: torch.device | str = "cuda", mesh=None):
        """images: (T, h, w, 3) normalized (or uint8 RGB), UNPADDED.
        device, mesh: as InferenceCore's (mesh: a sharded session, whose
        S2M runs on the session's device)."""
        self.k = num_objects
        self.processor = InferenceCore(prop_net, fuse_net, images, num_objects,
                                       mem=mem, device=device, mesh=mesh)
        device = self.processor.device
        self.t, self.h, self.w = (self.processor.t, self.processor.h,
                                  self.processor.w)
        self.pad = self.processor.pad
        self.nh, self.nw = self.processor.nh, self.processor.nw
        # DAVIS scribbles use -1 as "no scribble" and are thickened with
        # a 3x3 dilation (reference davis_processor.py:53-60).
        self.s2m = S2MController(s2m_net, num_objects, ignore_class=-1,
                                 dilate_radius=1, device=device)
        self.interacted_count = 0
        self.davis_schedule = [2, 5, 7]  # reference davis_processor.py:34

    def to_mask(self, scribble: Dict) -> Tuple[torch.Tensor, int]:
        """One round's scribbles -> hard-aggregated (K+1, nh, nw, 1) mask
        and the interacted frame index (reference davis_processor.py:38-70)."""
        scribble, idx = select_single_frame(scribble)
        scr_mask = scribbles2mask(scribble, (self.h, self.w))[0]
        mask = self.s2m.interact(self.processor.get_image(idx),
                                 self._padded_hard_mask(idx), scr_mask,
                                 aggregate_hard=True)
        return mask, idx

    def _padded_hard_mask(self, idx: int) -> np.ndarray:
        lab = np.zeros((self.nh, self.nw), np.uint8)
        lw, uw, lh, uh = self.pad
        lab[lh: self.nh - uh, lw: self.nw - uw] = self.processor.np_masks[idx]
        return lab

    def interact(self, scribble: Dict):
        """Returns (masks (T, h, w) uint8, next_interact, frame_idx)
        (reference davis_processor.py:72-92)."""
        mask, idx = self.to_mask(scribble)
        # InferenceCore takes the mask on the raw grid; crop the padding.
        lw, uw, lh, uh = self.pad
        raw_mask = mask[:, lh: self.nh - uh, lw: self.nw - uw, :]

        if self.interacted_count == self.davis_schedule[0]:
            self.davis_schedule = self.davis_schedule[1:]
            next_interact = None
            out_masks = self.processor.interact(raw_mask, idx)
        else:
            next_interact = [idx]
            out_masks = self.processor.update_mask_only(raw_mask, idx)

        self.interacted_count += 1
        return out_masks, next_interact, idx
