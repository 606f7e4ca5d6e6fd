"""A cell of BENCHMARK.json with its files, and the program under test
built for it.

`load_cell` finds, by the names in BENCHMARK.json, the configuration's
file, the traffic mix (`traffic/<mix>.json`), the cell's limits
(`cells/<workload>.json`) and the interaction the configuration names
(`interactions/<name>.py`). `build_program` makes the port's networks on
the device and loads the harness's state dicts into them, as
`checkpoint/pth.py` loads a published `.pth`. `play` runs a session's
rounds through `InferenceCore.interact`, each round's mask made by the
interaction.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

import torch

from ivos_bench import interactions
from ivos_bench.check import Snap, snap
from ivos_bench.traffic import Traffic


@dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Traffic
    limits: Dict[str, float]
    interaction: ModuleType       # interactions/<name>.py, loaded

    @property
    def interaction_numbers(self) -> Tuple[str, ...]:
        """The numbers the interaction names (`NUMBERS`), by which the check
        holds its masks to the reference's."""
        return tuple(getattr(self.interaction, "NUMBERS", ()))

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
    config = json.loads((root.parent / cfg_entry["file"]).read_text())
    return Cell(name=workload, chips=entry["chips"], config=config,
                traffic=Traffic.load(root / "traffic" / f"{entry['traffic']}.json"),
                limits=json.loads((root / "cells" / f"{workload}.json").read_text())["limits"],
                interaction=interactions.load(
                    config.get("interaction", interactions.DEFAULT), root))


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


def play(core, rounds: List[int], clip: Tuple[torch.Tensor, torch.Tensor], k: int,
         interaction, chunk_cb: Callable = lambda tis, labs: None,
         keep: bool = True, keep_masks: bool = False) -> List[Snap]:
    """Every round of a session on `clip` (frames, labels), each round's
    mask from `interaction.round`; returns each round as the check keeps
    it (`check.snap`; the mask too with `keep_masks`), or nothing without
    `keep`."""
    frames_u8, labels = clip
    snaps = []
    for r, idx in enumerate(rounds):
        mask, record = interaction.round(frames_u8[idx], labels[idx], k, core.prob[idx])
        core.interact(mask, idx, chunk_cb=chunk_cb)
        if keep:
            snaps.append(snap(core, rounds[:r], idx, record,
                              mask if keep_masks else None))
    return snaps
