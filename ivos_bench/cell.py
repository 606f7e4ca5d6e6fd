"""A cell of BENCHMARK.json with its files, and the program under test
built for it.

`load_cell` finds, by the names in BENCHMARK.json, the configuration's
file, the traffic mix (`traffic/<mix>.json`) and the cell's limits
(`cells/<workload>.json`). `build_program` makes the port's networks on
the device and loads the harness's state dicts into them, as
`checkpoint/pth.py` loads a published `.pth`. `play` runs a session's
rounds through `InferenceCore.interact`.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ivos_bench.check import due, host_copy
from ivos_bench.clips import interaction_mask
from ivos_bench.traffic import Traffic


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Traffic
    limits: Dict[str, float]

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.config["dtype"])

    def set_tf32(self) -> None:
        """The configuration's TF32 setting, for the whole process (null:
        torch's defaults)."""
        if self.config.get("tf32") is not None:
            torch.backends.cudnn.allow_tf32 = self.config["tf32"]
            torch.backends.cuda.matmul.allow_tf32 = self.config["tf32"]


def load_cell(spec: Dict, workload: str, root: Path) -> Cell:
    """`root` is the harness's folder; configuration files are named
    relative to its parent, the checkout's root."""
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    return Cell(name=workload, chips=entry["chips"],
                config=json.loads((root.parent / cfg_entry["file"]).read_text()),
                traffic=Traffic.load(root / "traffic" / f"{entry['traffic']}.json"),
                limits=json.loads((root / "cells" / f"{workload}.json").read_text())["limits"])


def build_program(cell: Cell, sd, fsd, dev):
    """The port's PropagationNetwork and FusionNet (None without fusion)
    on `dev`, loaded strictly from the state dicts."""
    from mivos_tpu_torch.models.fusion import FusionNet
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    cfg = cell.config
    with torch.device(dev):
        prop = PropagationNetwork(top_k=cfg["top_k"], read_backend=cfg["read_backend"],
                                  read_refine=cfg["read_refine"], dtype=cell.dtype,
                                  dec_width=cfg["dec_width"])
        prop.load_state_dict(sd)
        fuse = None
        if cfg["fusion"]:
            fuse = FusionNet(dtype=cell.dtype)
            fuse.load_state_dict(fsd)
    return prop, fuse


def mem_config(cell: Cell, cache_queries: Optional[bool] = None):
    """The configuration's top_k and the mix's mem_freq; the rest is the
    program's default (`cache_queries` overrides it for a warm session)."""
    from mivos_tpu_torch.config import MemoryConfig

    extra = {} if cache_queries is None else {"cache_queries": cache_queries}
    return MemoryConfig(top_k=cell.config["top_k"], mem_freq=cell.traffic.mem_freq,
                        **extra)


def new_session(cell: Cell, prop, fuse, frames_u8, dev, cache_queries=None):
    from mivos_tpu_torch.core.inference import InferenceCore

    return InferenceCore(prop, fuse, frames_u8, cell.traffic.k,
                         mem=mem_config(cell, cache_queries), device=dev)


def play(core, rounds: List[int], labels: torch.Tensor, k: int,
         chunk_cb: Callable = lambda tis, labs: None,
         keep: bool = True) -> List[Tuple[int, Dict[int, torch.Tensor]]]:
    """Every round of a session; returns per round (interaction frame,
    host copies of the probabilities of the frames it was due to
    propagate, as `check.host_copy` keeps them), or nothing without
    `keep`."""
    snaps = []
    for r, idx in enumerate(rounds):
        core.interact(interaction_mask(labels[idx], k), idx, chunk_cb=chunk_cb)
        if keep:
            snaps.append((idx, host_copy(core.prob, due(core.t, rounds[:r], idx))))
    return snaps
