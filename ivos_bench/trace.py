"""Reading a `torch.profiler` trace of part of the window.

The profile is exported as a Chrome trace into the run's temporary
directory and read back here:

- device activity: kernels, copies and sets on the card, merged into
  busy intervals (`busy_s`);
- each kernel's span: the profiler's correlation id ties the kernel to
  the host call that launched it, and the innermost `record_function`
  range around that call on the same thread names it. A kernel without a
  launch record takes the span of the kernel before it on its stream,
  which launched before it;
- idle gaps: each stretch between busy intervals goes to the innermost
  span the host was in when the device ran dry.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST = "host"   # the name of time outside every span


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: int
    span_device_s: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


class _SpanIndex:
    """The user-annotation ranges of one host thread, which nest, for the
    innermost one around a time: the last range to start before it, or
    the nearest of that range's enclosing ranges that still holds it."""

    def __init__(self, ranges: List[Tuple[float, float, str]]):
        self.ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
        self.starts = [r[0] for r in self.ranges]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, e, _) in enumerate(self.ranges):
            while stack and self.ranges[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def at(self, ts: float) -> str:
        j = bisect.bisect_right(self.starts, ts) - 1
        while j >= 0 and self.ranges[j][1] < ts:
            j = self.parent[j]
        return self.ranges[j][2] if j >= 0 else HOST


def read_chrome_trace(path: Path, window_s: float,
                      spans: Tuple[str, ...]) -> TraceSummary:
    events = json.loads(Path(path).read_text())["traceEvents"]
    annot: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    launches: Dict[int, Tuple[int, float]] = {}
    device: List[dict] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev.get("name") in spans:
            annot[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["tid"], ev["ts"])
        elif cat in DEVICE_CATS:
            device.append(ev)
    index = {tid: _SpanIndex(r) for tid, r in annot.items()}
    main_tid = max(annot, key=lambda t: len(annot[t])) if annot else None

    span_s: Dict[str, float] = defaultdict(float)
    op_s: Dict[str, float] = defaultdict(float)
    last_span_on_stream: Dict[Tuple, str] = {}
    device.sort(key=lambda e: e["ts"])
    n_kernels = 0
    for ev in device:
        dur = ev["dur"] * 1e-6
        args = ev.get("args", {})
        stream = (args.get("device"), args.get("stream"))
        corr = args.get("correlation")
        if corr in launches and launches[corr][0] in index:
            tid, ts = launches[corr]
            span = index[tid].at(ts)
        else:
            span = last_span_on_stream.get(stream, HOST)
        last_span_on_stream[stream] = span
        span_s[span] += dur
        if ev.get("cat") == "kernel":
            n_kernels += 1
            op_s[ev["name"]] += dur

    # Busy intervals and the idle gaps between them.
    busy, gaps = 0.0, defaultdict(float)
    cur_s = cur_e = None
    host = index.get(main_tid)
    for ev in device:
        s, e = ev["ts"], ev["ts"] + ev["dur"]
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps[host.at(cur_e) if host else HOST] += (s - cur_e) * 1e-6
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = lambda d: sorted(((k, v) for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=window_s, busy_s=busy * 1e-6,
                        kernels=n_kernels, span_device_s=dict(span_s),
                        device_ops=top(op_s), idle_gaps=top(gaps))
