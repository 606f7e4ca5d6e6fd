"""The yardstick's arithmetic: peaks of the card, the memory read's work,
and the model's FLOPs per phase.

The read is counted as the work its inputs need, once, whatever
implements it: one affinity (2 K N M 128 FLOPs) and the top-k readout
(2 K N top_k 512), and the bytes of the keys, values and queries read
once and the float32 readout written once. Its least time is the larger
of those FLOPs at the bfloat16 tensor peak and those bytes at the HBM
peak, for both bank dtypes, so that no implementation of the same work
can read over 100% of it.

The towers are counted by `torch.utils.flop_counter.FlopCounterMode` (2
FLOPs a multiply-add of convolutions and matrix products; elementwise
work is not counted) on the reference networks on the meta device, at
the cell's padded frame size and object count, one call per phase:

  encode    the query tower and its key and value heads, once a frame
            (the session keeps query features, as MiVOS does)
  decode    the decoder over K objects with its skip towers, once a read
  memorize  the mask tower and its heads over K objects, once an
            interaction and once a propagated frame except a pass's last
  fuse      the attention read and FusionNet over K objects, once a
            fused frame

How often each phase runs, and the bank each read sees, is worked out
by `Schedule` from a session's interactions on MiVOS's loop, as the
reference session plans its passes, and not from what the program
calls: a program that skips, merges or batches calls does the same work
by this count.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from ivos_bench.reference.nets import FusionNet, PropagationNetwork
from ivos_bench.reference.session import BANK_CAP_FRAMES, pass_plan

# NVIDIA H100 SXM data sheet, dense, at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_HBM_BYTES = 3.35e12
READ_PEAK_FLOPS = PEAK_FLOPS["bfloat16"]
KEY_DIM, VAL_DIM = 128, 512


def read_flops(k: int, n: int, m: int, top_k: int) -> float:
    return 2.0 * k * n * m * KEY_DIM + 2.0 * k * n * min(top_k, m) * VAL_DIM


def read_bytes(k: int, n: int, m: int, itemsize: int) -> float:
    return (k * m * (KEY_DIM + VAL_DIM) * itemsize + n * KEY_DIM * itemsize
            + k * n * VAL_DIM * 4)


def read_least_s(k: int, n: int, m: int, itemsize: int, top_k: int) -> float:
    return max(read_flops(k, n, m, top_k) / READ_PEAK_FLOPS,
               read_bytes(k, n, m, itemsize) / PEAK_HBM_BYTES)


def _flops(fn) -> float:
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn()
    return float(counter.get_total_flops())


def phase_flops(nh: int, nw: int, k: int) -> Dict[str, float]:
    """FLOPs of one call of each phase at a padded nh x nw frame and K
    objects (module docstring)."""
    with torch.device("meta"):
        prop, fuse = PropagationNetwork(), FusionNet()
        frame = torch.zeros(1, 3, nh, nw)
        masks = torch.zeros(k, 1, nh, nw)
        f16, f8, f4 = prop.rgb_encoder(frame)
        k16, v16 = prop.kv_q_f16(f16)
        x = torch.zeros(k, 1024, nh // 16, nw // 16)
        keys = torch.zeros(1, KEY_DIM, (nh // 16) * (nw // 16))
        im = torch.zeros(1, 3, nh, nw)
        time = torch.zeros(1, 2)

        def fuse_frame():
            for _ in range(k):
                attn = prop.get_attention(keys, masks[:1], masks[:1], k16)
                fuse(im, masks[:1], masks[:1], attn, time)

        return {"encode": _flops(lambda: prop.get_query_values(frame)),
                "decode": _flops(lambda: prop.decoder(x, f8, f4)),
                "memorize": _flops(lambda: prop.memorize(frame, masks)),
                "fuse": _flops(fuse_frame)}


@dataclass
class Work:
    """Calls of each phase (module docstring), and each read's
    (K, N, M)."""
    encode: int = 0
    decode: int = 0
    memorize: int = 0
    fuse: int = 0
    reads: List[Tuple[int, int, int]] = field(default_factory=list)

    def flops(self, phase: Dict[str, float], top_k: int) -> float:
        return (sum(phase[p] * getattr(self, p)
                    for p in ("encode", "decode", "memorize", "fuse"))
                + sum(read_flops(k, n, m, top_k) for k, n, m in self.reads))


class Schedule:
    """One session's work per propagated frame on MiVOS's loop, from its
    interactions alone: an interaction memorizes its frame; each frame a
    pass propagates reads the bank the pass has built by then (the
    interactions' certain memory, a slot a commit every `mem_freq`-th
    frame, the transient slot of an uncommitted previous frame), decodes,
    and is memorized unless it is the pass's last; a pass that stops at
    an earlier interaction fuses its frames; a frame's query is encoded
    the first time the session propagates it."""

    def __init__(self, t: int, k: int, n: int, mem_freq: int, fusion: bool,
                 cap: int = BANK_CAP_FRAMES):
        self.t, self.k, self.n, self.mem_freq = t, k, n, mem_freq
        self.fusion, self.cap = fusion, cap
        self.interacted: set = set()
        self.interactions = 0
        self.seen: set = set()
        self.frames: Dict[int, dict] = {}

    def interact(self, idx: int, work: Optional[Work] = None) -> None:
        """Plan the round at idx; what each of its frames does is then
        in `frames`. The interaction's memorize is added to `work`."""
        if work is not None:
            work.memorize += 1
        self.interacted.add(idx)
        self.interactions += 1
        certain, self.frames = self.interactions, {}
        for forward in (True, False):
            plan = pass_plan(self.t, self.interacted, idx, forward,
                             self.mem_freq, self.cap, certain)
            front, last, prev_in = certain, idx, True
            for ti in plan["frames"]:
                end = ti == plan["frames"][-1]
                self.frames[ti] = {
                    "encode": int(ti not in self.seen),
                    "memorize": int(not end),
                    "fuse": int(plan["fuse"] and self.fusion),
                    "m": (front + (0 if prev_in else 1)) * self.n}
                self.seen.add(ti)
                if not end:
                    if abs(ti - last) >= plan["interval"]:
                        front, last, prev_in = front + 1, ti, True
                    else:
                        prev_in = False

    def count(self, work: Work, frames: Iterable[int]) -> None:
        """Add the work of the round's `frames` to `work`."""
        for ti in frames:
            f = self.frames[ti]
            work.encode += f["encode"]
            work.decode += 1
            work.memorize += f["memorize"]
            work.fuse += f["fuse"]
            work.reads.append((self.k, self.n, f["m"]))
