"""Interactions: what makes each round's mask from the annotator's input.

A configuration names its interaction with `"interaction": "<name>"`
(absent: `mask`); the harness loads `interactions/<name>.py` by that
name (`load`), as it loads metric readers, so a configuration whose
rounds start from a click or a scribble comes as new files only. A
module holds:

  setup(cell, seed, dev)         the program's side, built in set-up
                                 (inside `setup_s`): makes the
                                 interaction's weights on `dev` from the
                                 seed, from a generator of its own (so
                                 that `weights.make_weights`' draws stay
                                 as they are), builds the port's module
                                 through the port's own entry point and
                                 warms it on the cell's shapes. Returns an
                                 object with
    .round(frame_u8, labels, k, prob) -> (mask, record)
                                 frame_u8: the (h, w, 3) uint8 frame;
                                 labels: its (h, w) uint8 label map (0
                                 background, 1..K objects); prob: the
                                 session's probabilities of the frame as
                                 it holds them, or None before the
                                 frame's first round. mask: the
                                 (K+1, h, w, 1) float32 probabilities,
                                 background first, that `interact` is
                                 given; record: the inputs exactly as the
                                 program used them (clicks, crops), or
                                 None where the frame and labels are all
  reference(cell, seed, dev)     the plain reference's side, built after
                                 the window (plain PyTorch under
                                 `ivos_bench/reference/`, nothing of the
                                 port), from the same seed. Returns an
                                 object with
    .replay(frame_u8, labels, k, record) -> mask
                                 the reference's mask of the same round
  NUMBERS                        optional: names of `check.Gap`'s numbers
                                 by which the program's masks are held to
                                 the reference's replay, reported as
                                 `interaction_<name>`; a cell's limits
                                 file may hold them

A traffic mix's `"interaction"` block (`traffic.py`) reaches the module
untouched as `cell.traffic.interaction`.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from types import ModuleType

DEFAULT = "mask"


def load(name: str, root: Path) -> ModuleType:
    """The module `<root>/interactions/<name>.py`, `root` the harness's
    folder."""
    mod_name = "ivos_interaction_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        mod_name, Path(root) / "interactions" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod
