"""Plain PyTorch MiVOS inference session: interact -> propagate both ways
-> fuse (MiVOS `inference_core.py:122-217` and `:219-271`).

The session works out its own bank state from the frames and the
interactions: certain memory from each interaction's mask, and per pass
a bank that commits every `mem_freq`-th frame, with the frame before a
commit held in one transient slot (`do_pass`). The one departure from
the published loop is the deployment's bank cap (`BANK_CAP_FRAMES`, the
port's default deployment's): a pass whose commits would not fit is thinned to a longer interval, by
the rule `commit_interval` states; below the cap it is the published
schedule. Probabilities are float32 throughout; `aggregate_wbg` is
`model/aggregate.py`'s.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

BANK_CAP_FRAMES = 512
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def aggregate_wbg(prob: torch.Tensor, keep_bg: bool = False) -> torch.Tensor:
    """(K, ...) foreground probabilities -> (K+1, ...) soft aggregate."""
    new_prob = torch.cat([torch.prod(1 - prob, dim=0, keepdim=True), prob],
                         0).clamp(1e-7, 1 - 1e-7)
    logits = torch.log(new_prob / (1 - new_prob))
    out = F.softmax(logits, dim=0)
    return out if keep_bg else out[1:]


def pad16(h: int, w: int):
    """(left, right, top, bottom) padding to multiples of 16, the smaller
    half first (util/tensor_util.py's pad_divide_by)."""
    nh, nw = h + (16 - h % 16) % 16, w + (16 - w % 16) % 16
    return ((nw - w) // 2, (nw - w) - (nw - w) // 2,
            (nh - h) // 2, (nh - h) - (nh - h) // 2)


def commit_interval(mem_freq: int, cap: int, pass_len: int,
                    certain: int) -> int:
    """The commit interval of a pass of `pass_len` frames with `certain`
    interaction frames in memory under a bank of `cap` frames: mem_freq,
    or the least longer interval whose commits fit in the cap less the
    certain memory and two slots (the transient one and one kept free)."""
    avail = cap - certain - 2
    if avail < 1:
        raise ValueError(f"{certain} certain frames leave no room in a bank "
                         f"of {cap} frames")
    if pass_len > 0 and (pass_len - 1) // mem_freq + 1 > avail:
        return max(mem_freq, (pass_len - 1) // avail + 1)
    return mem_freq


def pass_plan(t: int, interacted, idx: int, forward: bool, mem_freq: int,
              cap: int, certain: int) -> Dict:
    """The frames of one pass from interaction `idx`, the frame it stops
    before, its commit interval and whether it fuses. `interacted`
    includes idx."""
    if forward:
        closest = min([ti for ti in interacted if ti > idx] + [t])
        frames = list(range(idx + 1, closest))
    else:
        closest = max([ti for ti in interacted if ti < idx] + [-1])
        frames = list(range(idx - 1, closest, -1))
    return {"frames": frames, "closest": closest,
            "interval": commit_interval(mem_freq, cap, len(frames), certain),
            "fuse": closest not in (t, -1)}


class Session:
    """One video: images (T, H, W, 3) uint8 RGB on the device, K objects.
    `interact(mask, idx)` takes the (K+1, H, W, 1) background-first
    probabilities of frame idx (the program's layout) and returns the
    per-frame (K+1, 1, nh, nw) probabilities on the padded grid as a
    list, None where untouched.

    cache_queries: keep each frame's query features for later rounds, as
    `inference_core.py`'s `get_query_kv_buffered` does (off for a video
    whose features would not fit)."""

    def __init__(self, prop, fuse, images: torch.Tensor, k: int,
                 mem_freq: int, cache_queries: bool,
                 quant: Callable = lambda x: x,
                 bank_cap_frames: int = BANK_CAP_FRAMES):
        dev = images.device
        self.prop, self.fuse, self.k, self.quant = prop, fuse, k, quant
        self.mem_freq, self.cap = mem_freq, bank_cap_frames
        mean = torch.tensor(MEAN, device=dev).view(1, 3, 1, 1)
        std = torch.tensor(STD, device=dev).view(1, 3, 1, 1)
        self.t, self.h, self.w = images.shape[:3]
        self.pad = pad16(self.h, self.w)
        self._raw = images
        self._norm = lambda x: (x.permute(0, 3, 1, 2).float() / 255 - mean) / std
        self.nh = self.h + self.pad[2] + self.pad[3]
        self.nw = self.w + self.pad[0] + self.pad[1]
        self.prob: List[Optional[torch.Tensor]] = [None] * self.t
        self.interacted = set()
        self.certain_k = self.certain_v = None
        self.cache_queries = cache_queries
        self._queries: Dict[int, tuple] = {}

    def image(self, ti: int) -> torch.Tensor:
        return F.pad(self._norm(self._raw[ti:ti + 1]), self.pad)

    def get_prob(self, ti: int) -> torch.Tensor:
        if self.prob[ti] is None:
            p = torch.zeros((self.k + 1, 1, self.nh, self.nw),
                            device=self._raw.device)
            p[0] = 1e-7
            return p
        return self.prob[ti]

    def query(self, ti: int):
        if ti in self._queries:
            return self._queries[ti]
        q = self.prop.get_query_values(self.image(ti))
        if self.cache_queries:
            self._queries[ti] = q
        return q

    def memorize(self, ti: int, masks: torch.Tensor):
        k, v = self.prop.memorize(self.image(ti), masks)
        return self.quant(k), self.quant(v)

    @torch.no_grad()
    def interact(self, mask: torch.Tensor, idx: int, chunk_cb=None):
        """chunk_cb is accepted for the program's signature and unused."""
        self.interacted.add(idx)
        mask = F.pad(mask[..., 0].to(torch.float32), self.pad).unsqueeze(1)
        diff = mask - self.get_prob(idx)
        pos, neg = diff.clamp(0, 1), (-diff).clamp(0, 1)
        self.prob[idx] = mask
        key_k, key_v = self.memorize(idx, mask[1:])
        if self.certain_k is None:
            self.certain_k, self.certain_v = key_k, key_v
        else:
            self.certain_k = torch.cat([self.certain_k, key_k], 2)
            self.certain_v = torch.cat([self.certain_v, key_v], 2)
        for forward in (True, False):
            self.do_pass(key_k, idx, forward, pos, neg)
        return list(self.prob)

    def do_pass(self, key_k, idx: int, forward: bool, pos, neg) -> None:
        n = key_k.shape[2]
        certain = self.certain_k.shape[2] // n
        plan = pass_plan(self.t, self.interacted, idx, forward, self.mem_freq,
                         self.cap, certain)
        frames = plan["frames"]
        if not frames:
            return
        freq = plan["interval"]
        total = (len(frames) - 1) // freq + 1 + certain   # + 1 transient slot
        kk, ck = self.certain_k.shape[:2]
        keys = self.certain_k.new_empty((kk, ck, (total + 1) * n))
        values = self.certain_v.new_empty((kk, self.certain_v.shape[1],
                                           (total + 1) * n))
        keys[:, :, :certain * n] = self.certain_k
        values[:, :, :certain * n] = self.certain_v
        front, last, prev_in = certain, idx, True
        for ti in frames:
            f8, f4, k16, v16 = self.query(ti)
            rows = (front + (0 if prev_in else 1)) * n
            out = aggregate_wbg(self.prop.segment(
                keys[:, :, :rows], values[:, :, :rows], f8, f4, k16, v16),
                keep_bg=True)
            if ti != frames[-1]:
                mk, mv = self.memorize(ti, out[1:])
                keys[:, :, front * n:(front + 1) * n] = mk
                values[:, :, front * n:(front + 1) * n] = mv
                if abs(ti - last) >= freq:
                    front, last, prev_in = front + 1, ti, True
                else:
                    prev_in = False
            if plan["fuse"] and self.fuse is not None:
                out = self.fuse_one_frame(plan["closest"], idx, ti,
                                          self.get_prob(ti), out, key_k, k16,
                                          pos, neg)
            self.prob[ti] = out

    def fuse_one_frame(self, tc: int, tr: int, ti: int, prev_mask, curr_mask,
                       mk16, qk16, pos, neg) -> torch.Tensor:
        prob = torch.zeros((self.k, 1, self.nh, self.nw), device=mk16.device)
        nc = abs(tc - ti) / abs(tc - tr)
        nr = abs(tr - ti) / abs(tc - tr)
        dist = torch.tensor([[nc, nr]], dtype=torch.float32,
                            device=mk16.device)
        im = self.image(ti)
        for k in range(1, self.k + 1):
            attn = self.prop.get_attention(mk16[k - 1:k], pos[k:k + 1],
                                           neg[k:k + 1], qk16)
            prob[k - 1] = torch.sigmoid(self.fuse(
                im, prev_mask[k:k + 1], curr_mask[k:k + 1], attn, dist))[0]
        return aggregate_wbg(prob, keep_bg=True)
