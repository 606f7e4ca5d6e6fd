"""Propagated probability maps for fusion training (counterpart of
mivos_tpu/core/fusion_generator.py; reference
generation/fusion_generator.py).

A stripped session: a ground-truth mask placed on one frame propagates
forward and backward over a [left, right] window, and the aggregated
probabilities of every frame are kept. Each pass has a fresh bank that
holds only the interacted frame, commits a frame every `mem_freq` frames
with no bank-cap thinning, and no fusion runs.

The query features of every frame (the RGB tower, key/value heads and
the decoder's skip towers) are encoded once per video in 16-frame
batches, the first time a pass needs them, and every pass of every
reference frame reads them from that cache; the JAX generator encodes
each frame again in each pass. The reads go through the memory-read
dispatcher, so on the card they launch the memory-read kernels.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mivos_tpu_torch.core.inference import InferenceCore, prepare_net
from mivos_tpu_torch.core.memory_bank import MemoryBank
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.aggregate import aggregate_wbg
from mivos_tpu_torch.utils.tensor import pad_divide_by, unpad


class FusionGenerator:
    """images: (T, h, w, 3) float32 ImageNet-normalized, UNPADDED (numpy
    or tensor). The net is moved to `device` and, when its dtype is
    bfloat16, its conv weights are cast in place (`prepare_net`); the
    bank is kept in that dtype."""

    def __init__(self, prop_net: PropagationNetwork, images,
                 mem_freq: int = 5, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.prop_net = prepare_net(prop_net, self.device)
        self.mem_freq = mem_freq
        imgs = torch.as_tensor(images).to(self.device, torch.float32)
        self.t, self.h, self.w = imgs.shape[:3]
        # (T, nh, nw, 3), zero in the /16 padding band.
        self.images, self.pad = pad_divide_by(imgs, 16)
        self.nh, self.nw = self.images.shape[1:3]
        self.n16 = (self.nh // 16) * (self.nw // 16)
        self._qcache: Optional[tuple] = None
        self.k = 0
        self.prob: List[Optional[torch.Tensor]] = []
        self.bank: Optional[MemoryBank] = None

    def reset(self, k: int) -> None:
        """A new object count (reference fusion_generator.py:33-35)."""
        self.k = k
        self.prob = [None] * self.t
        self.bank = MemoryBank(k, self.n16, dtype=self.prop_net.dtype,
                               device=self.device)

    def _encode_queries(self) -> None:
        """(skip8, skip4, k16, v16) of every frame, (T, C, h, w) each, in
        the session's pre-encode batches."""
        b = InferenceCore._QC_BATCH
        parts = [self.prop_net.get_query_values_batched(self.images[i:i + b])
                 for i in range(0, self.t, b)]
        self._qcache = tuple(torch.cat(p) for p in zip(*parts))

    def _do_pass(self, idx: int, limit: int, forward: bool) -> None:
        frames = (range(idx + 1, limit + 1) if forward
                  else range(idx - 1, limit - 1, -1))
        if not frames:
            return
        if self._qcache is None:
            self._encode_queries()
        total_m = (len(frames) - 1) // self.mem_freq + 1 + 1
        key_k, key_v = self.prop_net.memorize(self.images[idx],
                                              self.prob[idx][1:].movedim(1, -1))
        self.bank.reset(total_m, key_k, key_v)
        m_front, last_ti, prev_in_mem = 1, idx, True
        for ti in frames:
            mem_k, mem_v = self.bank.live(include_transient=not prev_in_mem)
            skip8, skip4, k16, v16 = (c[ti:ti + 1] for c in self._qcache)
            prob = self.prop_net.segment_with_query(
                mem_k, mem_v, None, None, skip8, skip4, k16, v16, preskip=True)
            agg = aggregate_wbg(prob.movedim(-1, 1), keep_bg=True)
            mk, mv = self.prop_net.memorize(self.images[ti],
                                            agg[1:].movedim(1, -1))
            self.bank.write(m_front, mk, mv)
            if ti != frames[-1]:
                if abs(ti - last_ti) >= self.mem_freq:
                    m_front += 1
                    self.bank.num_slots = m_front
                    last_ti, prev_in_mem = ti, True
                else:
                    prev_in_mem = False
            self.prob[ti] = agg

    @torch.no_grad()
    def interact_mask(self, mask, idx: int, left_limit: int,
                      right_limit: int) -> np.ndarray:
        """mask: (K, h, w, 1) hard ground-truth masks on the raw grid of
        frame idx. Returns (K+1, T, h, w) float32 probabilities, zero
        outside [left_limit, right_limit] (reference
        fusion_generator.py:82-101)."""
        m = pad_divide_by(torch.as_tensor(mask).to(self.device, torch.float32),
                          16)[0].movedim(-1, 1)                 # (K, 1, nh, nw)
        bg = (1.0 - m.sum(dim=0, keepdim=True)).clamp(0.0, 1.0)
        self.prob[idx] = torch.cat([bg, m], dim=0)
        self._do_pass(idx, right_limit, forward=True)
        self._do_pass(idx, left_limit, forward=False)
        out = np.zeros((self.k + 1, self.t, self.h, self.w), np.float32)
        touched = [ti for ti in range(self.t) if self.prob[ti] is not None]
        stacked = unpad(torch.stack([self.prob[ti][:, 0] for ti in touched], 1),
                        self.pad, hw_axes=(-2, -1))
        out[:, touched] = stacked.cpu().numpy()
        return out
