"""The comparison that decides `correct`.

The program's answers are each round's probabilities of the frames the
round is due to propagate (`due`), as the session holds them when
`interact` returns (background first, on the padded grid; compared on
the frame's own H x W), copied to host memory then (`host_copy`), so
that the check holds nothing on the card and a later write in place
does not change an earlier round's answer. The reference session is
given the same weights and frames, and each round the mask the
interaction's reference side replays from the record the program's side
kept (`interactions/`; for `mask` both sides hand over the frame's label
mask); it works out its own state and is compared round by round; a
frame the reference sets and the program left unset counts as all
zeros.

Three numbers, each held to its own limit from the cell's file
(`ivos_bench/cells/<workload>.json`):

  prob_mae        mean |p - p_ref| over every compared probability
  frame_mae_max   the largest per-frame mean |p - p_ref|: one answer
                  altered stands out here, where the mean would hide it
  frame_p50_max   the largest per-frame median |p - p_ref|: the same,
                  deaf to the few pixels of a frame where the program's
                  read keeps more memory entries than the exact top-k
  prob_p999       the 99.9th percentile of |p - p_ref|, from a
                  histogram of 4000 bins even in log10 over [1e-10, 1]
                  (each bin 0.58% wide; the bin's upper edge is read);
                  prob_p50, prob_p90 and prob_p99 likewise

An interaction that names `NUMBERS` adds those of the same statistics
over its masks against the reference's replay, each round's mask one
"frame", as `interaction_<number>`.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

BINS = 4000
LOG_LO = -10.0


class Gap:
    """Running statistics of |p - p_ref| over the compared frames."""

    def __init__(self, device):
        self.total = 0.0
        self.count = 0
        self.frame_max = 0.0
        self.frame_p50_max = 0.0
        self.hist = torch.zeros(BINS, dtype=torch.float64, device=device)

    def add(self, prog: torch.Tensor, ref: torch.Tensor, pad) -> None:
        lw, uw, lh, uh = pad
        h, w = prog.shape[-2:]
        d = (prog.float() - ref.float()).abs()[..., lh:h - uh, lw:w - uw]
        s = float(d.sum())
        self.total += s
        self.count += d.numel()
        self.frame_max = max(self.frame_max, s / d.numel())
        self.frame_p50_max = max(self.frame_p50_max, float(d.flatten().median()))
        pos = (torch.log10(d.flatten().double().clamp_min(10 ** LOG_LO)) - LOG_LO)
        bins = (pos * (BINS / -LOG_LO)).long().clamp(0, BINS - 1)
        self.hist += torch.bincount(bins, minlength=BINS).double()

    def numbers(self) -> Dict[str, float]:
        cdf = torch.cumsum(self.hist, 0) / max(float(self.hist.sum()), 1.0)
        qs = (0.5, 0.9, 0.99, 0.999)
        bins = torch.searchsorted(cdf, torch.tensor(qs, dtype=cdf.dtype,
                                                    device=cdf.device)).tolist()
        out = {"prob_mae": self.total / max(self.count, 1),
               "frame_mae_max": self.frame_max,
               "frame_p50_max": self.frame_p50_max}
        for q, b in zip(("p50", "p90", "p99", "p999"), bins):
            out[f"prob_{q}"] = min(10 ** (LOG_LO + (b + 1) * -LOG_LO / BINS), 1.0)
        return out


def due(t: int, earlier, idx: int) -> List[int]:
    """Frames a round at idx propagates on MiVOS's loop: both ways from
    idx up to the nearest frames of `earlier` interactions, or the clip's
    ends."""
    hi = min([ti for ti in earlier if ti > idx] + [t])
    lo = max([ti for ti in earlier if ti < idx] + [-1])
    return [ti for ti in range(lo + 1, hi) if ti != idx]


def host_copy(prob: List[Optional[torch.Tensor]],
              frames: List[int]) -> Dict[int, torch.Tensor]:
    """Copies in host memory of the session's probabilities of `frames`,
    those it has set."""
    return {ti: prob[ti].detach().to("cpu", copy=True)
            for ti in frames if prob[ti] is not None}


class Snap(NamedTuple):
    """A round of a run as the check keeps it, all in host memory."""
    frame: int                       # the interaction frame
    probs: Dict[int, torch.Tensor]   # `host_copy` of the frames it was due to propagate
    record: object = None            # the interaction's record
    mask: Optional[torch.Tensor] = None   # the interaction's mask, where kept


def snap(core, earlier: List[int], idx: int, record=None,
         mask: Optional[torch.Tensor] = None) -> Snap:
    """The round at idx of a session (`core.prob`, `core.t`) that
    followed the interactions `earlier`."""
    return Snap(idx, host_copy(core.prob, due(core.t, earlier, idx)), record,
                None if mask is None else mask.detach().to("cpu", copy=True))


def changed(before: List[Optional[torch.Tensor]],
            after: List[Optional[torch.Tensor]], idx: int) -> List[int]:
    """Frames a round set anew, other than its interaction frame idx."""
    return [ti for ti, p in enumerate(after)
            if p is not None and p is not before[ti] and ti != idx]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    return all(numbers[name] <= limit for name, limit in limits.items())


def gaps(sessions: List[Tuple[object, Dict[str, List[Snap]]]], sd, fsd, cell,
         clips, reference, dev) -> Dict[str, Dict[str, float]]:
    """Run the reference (float32, TF32 off) over each session plan and
    compare, round by round, every named run of it: {name: its rounds as
    `Snap`s}. Each round's mask is `reference.replay` of the record of
    the session's first run (the cell's interaction's reference side).
    Returns {name: numbers}; empty when there is no session. Each run's
    rounds are dropped once compared."""
    from ivos_bench.reference.nets import build
    from ivos_bench.reference.precision import tf32
    from ivos_bench.reference.session import Session

    if not sessions:
        return {}
    traffic = cell.traffic
    kept = cell.interaction_numbers
    ref_prop, ref_fuse = build(sd, dev, cell.config["top_k"], fsd)
    found = {name: Gap(dev) for _, runs in sessions for name in runs}
    masks = {name: Gap(dev) for name in found} if kept else {}
    with tf32(False), torch.no_grad():
        for plan, runs in sessions:
            frames_u8, labels = clips[plan.clip]
            lead = next(iter(runs.values()))
            ref = Session(ref_prop, ref_fuse, frames_u8, traffic.k,
                          traffic.mem_freq, cache_queries=len(plan.rounds) > 1)
            for r, idx in enumerate(plan.rounds):
                want = reference.replay(frames_u8[idx], labels[idx], traffic.k,
                                        lead[r].record)
                before = list(ref.prob)
                after = ref.interact(want, idx)
                for name, snaps in runs.items():
                    got = snaps[r]
                    for ti in changed(before, after, idx):
                        p = got.probs.get(ti)
                        p = torch.zeros_like(after[ti]) if p is None else p.to(dev)
                        found[name].add(p, after[ti], ref.pad)
                    if kept:
                        masks[name].add(got.mask.to(dev)[..., 0], want[..., 0],
                                        (0, 0, 0, 0))
                    snaps[r] = None
    out = {name: g.numbers() for name, g in found.items()}
    for name, g in masks.items():
        out[name].update({f"interaction_{n}": v for n, v in g.numbers().items()
                          if n in kept})
    return out
