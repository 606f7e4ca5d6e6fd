"""Frozen contract of the `davisinteractive` API surface the adapter
assumes (the port's own copy of mivos_tpu/eval/davis_contract.py;
eval/davis_interactive.py::run_davis_interactive — usage mirrors
reference eval_interactive_davis.py:74-108).

The official package is absent in most environments, so the adapter is
exercised against stand-ins (the test StubSession and the hermetic
eval/robot.LocalInteractiveSession). This module pins EXACTLY what the
adapter demands of any session implementation, so the stand-ins cannot
drift from what the real package will provide:

  * constructor kwargs: davis_root, report_save_dir,
    max_nb_interactions, max_time            (davis_interactive.py:78)
  * context-manager protocol                  (:78 `with ... as sess`)
  * next() -> bool                            (:82)
  * get_scribbles(only_last=...) ->
      (sequence: str, scribbles: dict, new_sequence: bool)   (:83)
  * submit_masks(pred_masks, next_frame_candidates)          (:103,
      two positionals — reference calls it the same way,
      eval_interactive_davis.py:103)
  * get_global_summary(save_file=...) -> dict with 'auc'     (:107)

and of the scribble payload (consumed by interactive/scribbles.py and
DAVISProcessor, matching davisinteractive.utils.scribbles):

  {'scribbles': [frame_0_lines, ...]} — one list per video frame; each
  line {'path': [[x, y], ...] normalized to [0,1]^2, 'object_id': int}.

Each checker returns a list of violation strings (empty = conforming),
so tests can assert `== []` and print every drift at once.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Optional

SESSION_CTOR_KWARGS = ("davis_root", "report_save_dir",
                       "max_nb_interactions", "max_time")
SESSION_METHODS = ("__enter__", "__exit__", "next", "get_scribbles",
                   "submit_masks", "get_global_summary")


def _accepts_kwarg(fn, name: str) -> bool:
    params = inspect.signature(fn).parameters
    return name in params or any(p.kind == p.VAR_KEYWORD
                                 for p in params.values())


def check_session_methods(cls) -> List[str]:
    """Method-surface contract every session implementation (official
    package, hermetic LocalInteractiveSession, test stubs) must meet."""
    errs = []
    for meth in SESSION_METHODS:
        if not callable(getattr(cls, meth, None)):
            errs.append(f"missing method {meth}")
    gs = getattr(cls, "get_scribbles", None)
    if callable(gs) and not _accepts_kwarg(gs, "only_last"):
        errs.append("get_scribbles must accept only_last=")
    sm = getattr(cls, "submit_masks", None)
    if callable(sm):
        params = [p for p in inspect.signature(sm).parameters.values()
                  if p.name != "self"]
        n_pos = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                    for p in params)
        if n_pos < 2 and not any(p.kind == p.VAR_POSITIONAL
                                 for p in params):
            errs.append("submit_masks must accept two positionals "
                        "(pred_masks, next_frame_candidates)")
    gg = getattr(cls, "get_global_summary", None)
    if callable(gg) and not _accepts_kwarg(gg, "save_file"):
        errs.append("get_global_summary must accept save_file=")
    return errs


def check_session_ctor(cls) -> List[str]:
    """Constructor contract for the EXTERNAL-package path only (the
    hermetic session is constructed differently by design)."""
    errs = []
    try:
        fn = cls.__init__
    except AttributeError:  # pragma: no cover
        return ["no __init__"]
    for k in SESSION_CTOR_KWARGS:
        if not _accepts_kwarg(fn, k):
            errs.append(f"__init__ must accept {k}=")
    return errs


def check_scribbles(scribbles: Dict,
                    num_frames: Optional[int] = None,
                    num_objects: Optional[int] = None) -> List[str]:
    """Scribble-payload schema shared by the official bot, the hermetic
    robot, and everything interactive/scribbles.py rasterizes."""
    errs = []
    if not isinstance(scribbles, dict):
        return [f"scribbles payload must be a dict, got "
                f"{type(scribbles).__name__}"]
    frames = scribbles.get("scribbles")
    if not isinstance(frames, list):
        return ["payload['scribbles'] must be a per-frame list"]
    if num_frames is not None and len(frames) != num_frames:
        errs.append(f"expected {num_frames} frame entries, got "
                    f"{len(frames)}")
    for ti, lines in enumerate(frames):
        if not isinstance(lines, list):
            errs.append(f"frame {ti}: lines must be a list")
            continue
        for li, line in enumerate(lines):
            where = f"frame {ti} line {li}"
            if not isinstance(line, dict):
                errs.append(f"{where}: line must be a dict")
                continue
            if "object_id" not in line:
                errs.append(f"{where}: missing object_id")
            elif num_objects is not None and not (
                    0 <= int(line["object_id"]) <= num_objects):
                errs.append(f"{where}: object_id "
                            f"{line['object_id']} out of range")
            path = line.get("path")
            if not isinstance(path, list):
                errs.append(f"{where}: missing path list")
                continue
            for pt in path:
                if len(pt) != 2:
                    errs.append(f"{where}: point {pt} is not (x, y)")
                    break
                x, y = float(pt[0]), float(pt[1])
                if not (0.0 <= x <= 1.0 and 0.0 <= y <= 1.0):
                    errs.append(f"{where}: point {pt} outside [0,1]^2")
                    break
    return errs


def check_get_scribbles_result(result) -> List[str]:
    """(sequence, scribbles, new_sequence) triple shape."""
    errs = []
    if not isinstance(result, tuple) or len(result) != 3:
        return ["get_scribbles must return a 3-tuple "
                "(sequence, scribbles, new_sequence)"]
    seq, scr, new = result
    if not isinstance(seq, str):
        errs.append("sequence must be a str")
    errs += check_scribbles(scr)
    if not isinstance(new, (bool,)) and new not in (0, 1):
        errs.append("new_sequence must be boolean")
    return errs


def check_summary(summary) -> List[str]:
    """The adapter returns this dict to callers who read 'auc'
    (reference summary.json schema, eval_interactive_davis.py:108)."""
    if not isinstance(summary, dict):
        return ["global summary must be a dict"]
    if "auc" not in summary:
        return ["global summary must contain 'auc'"]
    return []
