"""The one traffic generator: a mix is a JSON file of parameters under
`ivos_bench/traffic/<name>.json`, read here.

A mix describes closed-loop annotation sessions, one annotator, each
round sent when the last returns:

  frames, height, width, objects   each clip's size (uint8 RGB frames)
  clips                            clips made in set-up, used in turn
  schedules                        each a session's interaction frames in
                                   order (round 0 first); sessions use
                                   them in turn
  mem_freq                         the session's commit interval (the
                                   rest of its MemoryConfig is the
                                   program's default)
  finish_last_round                let the round in flight at the window's
                                   end finish (its time joins the round
                                   tails), or cut it there
  warm                             the set-up session: its frames, rounds
                                   and cache_queries (defaults: the mix's
                                   frames, the first schedule, the
                                   program's default)
  check_among                      the correctness comparison takes one
                                   session, drawn from the seed among the
                                   first `check_among`
  trace                            the part of the window the `--trace 1`
                                   run profiles: [start_s, end_s] from the
                                   start of the session after the checked
                                   one
  interaction                      optional parameters of the cell's
                                   interaction (`interactions/`), such as
                                   {"clicks": 3}: handed to its module
                                   untouched as `Traffic.interaction`
                                   (default {})

The seed picks the clips' content and where in the lists of clips and
schedules the run starts; every seed runs the same schedules in turn,
so the work of a window does not depend on it.
"""
from __future__ import annotations

import json
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List

DEFAULTS = {"finish_last_round": True, "check_among": 1, "warm": {}, "interaction": {}}


@dataclass(frozen=True)
class SessionPlan:
    index: int
    clip: int
    rounds: List[int]


class Traffic:
    def __init__(self, params: Dict, name: str = ""):
        p = dict(DEFAULTS, **params)
        self.name = name
        self.t, self.h, self.w = p["frames"], p["height"], p["width"]
        self.k = p["objects"]
        self.clips = p["clips"]
        self.schedules = [list(s) for s in p["schedules"]]
        self.mem_freq = p["mem_freq"]
        self.finish_last_round = p["finish_last_round"]
        self.warm_frames = p["warm"].get("frames", self.t)
        self.warm_rounds = p["warm"].get(
            "rounds", [f for f in self.schedules[0] if f < self.warm_frames])
        self.warm_cache_queries = p["warm"].get("cache_queries")
        self.check_among = p["check_among"]
        self.trace_span = tuple(p.get("trace", (0.0, float("inf"))))
        self.interaction = p["interaction"]
        for s in self.schedules:
            if not s or len(set(s)) != len(s) or not all(0 <= f < self.t for f in s):
                raise ValueError(f"{name}: bad schedule {s} for {self.t} frames")

    @classmethod
    def load(cls, path: Path) -> "Traffic":
        return cls(json.loads(Path(path).read_text()), Path(path).stem)

    def sessions(self, seed: int):
        """Endless session plans for a run under `seed`."""
        rng = random.Random(seed)
        c0, s0 = rng.randrange(self.clips), rng.randrange(len(self.schedules))
        i = 0
        while True:
            yield SessionPlan(i, (c0 + i) % self.clips,
                              self.schedules[(s0 + i) % len(self.schedules)])
            i += 1

    def checked(self, seed: int) -> int:
        """Index of the session the correctness check compares."""
        return random.Random(seed ^ 0x5EED).sample(range(self.check_among), 1)[0]
