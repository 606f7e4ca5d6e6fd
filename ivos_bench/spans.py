"""Spans and counts around the program's layers, recorded from the
harness's side.

`Spans.install()` wraps entry points of the program's session and
network classes with `torch.profiler.record_function`, so that a
profiled window attributes each device kernel to the span whose host
range launched it. While `active` is set it also counts, at the same
boundaries, each span's calls and each read's (K, N, M) and bank
dtype (the model's work per phase is counted apart, by
`counts.Schedule`). Installed only in a `--trace 1` run; `uninstall()` restores
the classes.
"""
from __future__ import annotations

import functools
import importlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

PROP = "mivos_tpu_torch.models.propagation"
CORE = "mivos_tpu_torch.core.inference"

# span name -> (module, class, method)
ENTRY_POINTS: Dict[str, Tuple[str, str, str]] = {
    "query_encode": (PROP, "PropagationNetwork", "get_query_values"),
    "read": (PROP, "PropagationNetwork", "read_memory"),
    "decode": (PROP, "PropagationNetwork", "decode"),
    "memorize": (CORE, "InferenceCore", "_memorize"),
    "fuse": (CORE, "InferenceCore", "_fuse"),
    "precompute": (CORE, "InferenceCore", "_precompute_queries"),
    "pass": (CORE, "InferenceCore", "do_pass"),
}
MODEL_SPANS = ("query_encode", "decode", "memorize", "fuse", "precompute")


@dataclass
class Counts:
    calls: Dict[str, int] = field(default_factory=dict)
    reads: List[Tuple[int, int, int, int]] = field(default_factory=list)
    rounds: int = 0


def _read_shape(args) -> Tuple[int, int, int, int]:
    """(K, N, M, bank itemsize) of read_memory(mem_k, mem_v, valid, k16)."""
    mem_k, k16 = args[0], args[3]
    if not isinstance(mem_k, torch.Tensor):
        raise TypeError("a sharded bank's read is not counted here")
    return (mem_k.shape[0], k16.shape[-2] * k16.shape[-1], mem_k.shape[1],
            mem_k.element_size())


class Spans:
    def __init__(self):
        self.active = False
        self.counts = Counts()
        self._saved: List[Tuple[type, str, Callable]] = []

    def _count(self, span: str, args) -> None:
        c = self.counts
        c.calls[span] = c.calls.get(span, 0) + 1
        if span == "read":
            c.reads.append(_read_shape(args))

    def _wrap(self, span: str, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(obj, *args, **kwargs):
            if self.active:
                self._count(span, args)
            with torch.profiler.record_function(span):
                return fn(obj, *args, **kwargs)
        return wrapped

    def install(self) -> "Spans":
        for span, (mod, cls_name, meth) in ENTRY_POINTS.items():
            cls = getattr(importlib.import_module(mod), cls_name)
            fn = cls.__dict__[meth]
            self._saved.append((cls, meth, fn))
            setattr(cls, meth, self._wrap(span, fn))
        return self

    def uninstall(self) -> None:
        for cls, meth, fn in reversed(self._saved):
            setattr(cls, meth, fn)
        self._saved.clear()
