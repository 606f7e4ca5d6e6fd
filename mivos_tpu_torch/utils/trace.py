"""The port's spans and counters, off unless `enable()` is called.

`span(name, args)` opens a profiler range named `mivos.<name>` (`SPANS`
lists them all), a `user_annotation` in an exported `torch.profiler`
trace, so that the trace holds the program's layers on the same clock as
the card's kernels: each kernel goes to the innermost span whose host
range launched it, each idle stretch of the card to the innermost span
the host was in. Spans nest on one thread;
`args` (whole numbers) ride on the range as its inputs, which a
profiler that records shapes exports ("Concrete Inputs").

`count(name, n)` adds to one of `COUNTERS` under a lock, as sessions on
several threads (the server's handlers) count at once. `counters()`
reads them with the memory-read kernels' launches
(`ops/cuda/memory_read.launch_counts`, always counted) made between
`enable()` and `disable()`, under `launches.<kernel>`.

With tracing off, `span` reads one module-level bool and returns a
shared no-op context manager, and `count` returns at once.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple

import torch

from mivos_tpu_torch.ops.cuda import memory_read as cmr

PREFIX = "mivos."
SPANS: Tuple[str, ...] = tuple(PREFIX + s for s in (
    "interact", "pass", "precompute", "encode", "read", "decode", "aggregate",
    "memorize", "bank_write", "fuse", "chunk_issue", "chunk_wait", "hand_over",
    "render"))
COUNTERS: Tuple[str, ...] = ("rounds", "frames", "read_rows", "memorize",
                             "memorize_unread", "memorize_graph_replays",
                             "memorize_graph_captures")

_on = False
_OFF = contextlib.nullcontext()
_lock = threading.Lock()
_counts: Dict[str, int] = dict.fromkeys(COUNTERS, 0)
# The read kernels' launch counts at enable() and, once off, at disable().
_launches_from: Dict[str, int] = {}
_launches_to: Optional[Dict[str, int]] = None


class _Range:
    """A profiler range (what `torch.profiler.record_function` opens),
    with whole-number inputs: `record_function`'s string argument reaches
    no exported trace."""

    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: Tuple[int, ...]):
        self.name, self.args, self.handle = name, args, None

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name, *self.args)

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, args: Tuple[int, ...] = ()):
    """The range `mivos.<name>` while tracing is on, else a no-op."""
    if not _on:
        return _OFF
    return _Range(PREFIX + name, args)


def count(name: str, n: int = 1) -> None:
    if not _on:
        return
    with _lock:
        _counts[name] += n


def enable() -> None:
    """Zero the counters and turn tracing on."""
    global _on, _launches_from, _launches_to
    with _lock:
        for name in _counts:
            _counts[name] = 0
        _launches_from, _launches_to = cmr.launch_counts(), None
        _on = True


def disable() -> None:
    global _on, _launches_to
    with _lock:
        if _on:
            _launches_to = cmr.launch_counts()
        _on = False


def counters() -> Dict[str, int]:
    """The counters since the last `enable()`, with the read kernels'
    launches between it and `disable()` (or now, while on)."""
    with _lock:
        out = dict(_counts)
        start = _launches_from
        end = _launches_to if _launches_to is not None else cmr.launch_counts()
    for name, n in end.items():
        out["launches." + name] = n - start.get(name, 0)
    return out
