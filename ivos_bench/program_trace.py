"""The program's own spans and counters in the profiled part of the window.

The port names its layers itself (`mivos_tpu_torch/utils/trace.py`):
profiler ranges `mivos.<layer>` inside `InferenceCore` and counters of
the work at the same places, both on only between `trace.enable()` and
`trace.disable()`. `read_program_trace` reads the exported Chrome trace
a second time, beside `trace.read_chrome_trace`'s read with the
harness's span names, with the program's (`trace.SPANS`):

- host seconds under each span (its ranges' lengths, children included)
  and its ranges;
- kernels and device seconds by the innermost span whose host range
  launched them (the profiler's correlation id, as in `trace.py`);
- the card's idle seconds by the innermost span the host was in when
  the card ran dry;
- blocking CUDA runtime calls (`BLOCKING`) by the innermost span they
  were made in.

`metrics` turns that and the counters' snapshot into the per-layer
numbers, each None where the trace or the counters hold nothing to read.
A `--trace 1` run (`run.Tracer`) turns the program's tracing on with the
profiler and hands this read to the metric readers as `Run.program`.
"""
from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ivos_bench.trace import DEVICE_CATS, HOST, LAUNCH_CATS, _SpanIndex

BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")
ROUND = "mivos.interact"
MEMORIZE = "mivos.memorize"


@dataclass
class ProgramTrace:
    counters: Dict[str, int]
    host_s: Dict[str, float] = field(default_factory=dict)
    ranges: Dict[str, int] = field(default_factory=dict)
    kernels: Dict[str, int] = field(default_factory=dict)
    device_s: Dict[str, float] = field(default_factory=dict)
    idle_s: Dict[str, float] = field(default_factory=dict)
    syncs: Dict[str, int] = field(default_factory=dict)

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The largest idle totals by program span (`HOST`: outside
        every program span)."""
        return sorted(self.idle_s.items(), key=lambda kv: -kv[1])[:top]


def read_program_trace(path: Path, spans: Tuple[str, ...],
                       counters: Dict[str, int]) -> ProgramTrace:
    """The Chrome trace at `path` read for the program's `spans`, with the
    counters the program kept over the same part."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    pt = ProgramTrace(counters=dict(counters))
    host_s: Dict[str, float] = defaultdict(float)
    ranges: Dict[str, int] = defaultdict(int)
    annot: Dict[int, List[Tuple[float, float, str]]] = defaultdict(list)
    launches: Dict[int, Tuple[int, float]] = {}
    blocking: List[Tuple[int, float]] = []
    device: List[dict] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation" and ev.get("name") in spans:
            annot[ev["tid"]].append((ev["ts"], ev["ts"] + ev["dur"], ev["name"]))
            host_s[ev["name"]] += ev["dur"] * 1e-6
            ranges[ev["name"]] += 1
        elif cat in LAUNCH_CATS:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (ev["tid"], ev["ts"])
            if ev.get("name") in BLOCKING:
                blocking.append((ev["tid"], ev["ts"]))
        elif cat in DEVICE_CATS:
            device.append(ev)
    index = {tid: _SpanIndex(r) for tid, r in annot.items()}
    at = lambda tid, ts: index[tid].at(ts) if tid in index else HOST  # noqa: E731

    kernels: Dict[str, int] = defaultdict(int)
    device_s: Dict[str, float] = defaultdict(float)
    last_on_stream: Dict[Tuple, str] = {}
    device.sort(key=lambda e: e["ts"])
    for ev in device:
        args = ev.get("args", {})
        stream = (args.get("device"), args.get("stream"))
        corr = args.get("correlation")
        span = (at(*launches[corr]) if corr in launches
                else last_on_stream.get(stream, HOST))
        last_on_stream[stream] = span
        device_s[span] += ev["dur"] * 1e-6
        if ev.get("cat") == "kernel":
            kernels[span] += 1

    # The card's idle stretches, each to the main thread's innermost span
    # at the stretch's start.
    main = max(annot, key=lambda t: len(annot[t])) if annot else None
    idle: Dict[str, float] = defaultdict(float)
    cur_e = None
    for ev in device:
        s, e = ev["ts"], ev["ts"] + ev["dur"]
        if cur_e is not None and s > cur_e:
            idle[at(main, cur_e)] += (s - cur_e) * 1e-6
        cur_e = e if cur_e is None else max(cur_e, e)

    syncs: Dict[str, int] = defaultdict(int)
    for tid, ts in blocking:
        syncs[at(tid, ts)] += 1
    pt.host_s, pt.ranges, pt.kernels = dict(host_s), dict(ranges), dict(kernels)
    pt.device_s, pt.idle_s, pt.syncs = dict(device_s), dict(idle), dict(syncs)
    return pt


def metrics(pt: Optional[ProgramTrace]) -> Dict[str, float]:
    """The per-layer numbers the program's spans and counters give, by
    metric name; a number with nothing to read is left out.

    - `memorize_launches_per_call`, `memorize_host_ms_per_call`,
      `memorize_idle_ms_per_call`: kernels launched, host ms and card
      idle ms with the host innermost in `mivos.memorize`, per counted
      memorize call;
    - `memorize_unread_pct`: of those calls, the share that wrote a
      pass's last frame, which no read of the pass uses;
    - `host_syncs_per_frame`: blocking runtime calls inside the rounds
      per propagated frame (one read each); left out where the trace
      holds no blocking call at all, not even the harness's own at each
      round's end, as a trace without the runtime's calls would.
    """
    if pt is None:
        return {}
    c, out = pt.counters, {}
    calls, frames = c.get("memorize", 0), c.get("frames", 0)
    if calls:
        if pt.kernels:
            out["memorize_launches_per_call"] = pt.kernels.get(MEMORIZE, 0) / calls
        if MEMORIZE in pt.host_s:
            out["memorize_host_ms_per_call"] = pt.host_s[MEMORIZE] * 1e3 / calls
        if pt.idle_s:
            out["memorize_idle_ms_per_call"] = pt.idle_s.get(MEMORIZE, 0.0) * 1e3 / calls
        out["memorize_unread_pct"] = 100.0 * c.get("memorize_unread", 0) / calls
    if frames and pt.syncs:
        inside = sum(n for span, n in pt.syncs.items() if span != HOST)
        out["host_syncs_per_frame"] = inside / frames
    return out
