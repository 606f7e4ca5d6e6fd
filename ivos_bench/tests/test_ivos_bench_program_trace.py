"""The second read of a traced window, with the program's own spans
(`program_trace.py`): on a hand-made trace whose every number is known,
and on a CPU profile of a tiny session with the program's tracing on."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from ivos_bench.program_trace import metrics, read_program_trace
from ivos_bench.spans import ENTRY_POINTS
from ivos_bench.trace import HOST, read_chrome_trace
from mivos_tpu_torch.utils import trace

HARNESS_SPANS = tuple(ENTRY_POINTS) + ("round",)


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1, "args": args}


def _kernel(corr, ts, dur):
    return _x("kernel", f"k{corr}", ts, dur, tid=7, device=0, stream=7,
              correlation=corr)


def _launch(corr, ts):
    return _x("cuda_runtime", "cudaLaunchKernel", ts, 1, correlation=corr)


# Times in microseconds. The round [0, 1000] holds a pass [100, 900] with a
# memorize [200, 310] (inside the harness's own `memorize` range) and a
# decode [500, 600]. Kernels: two launched in memorize (run 210-230 and
# 300-320), one in decode (700-750), one in the pass outside both
# (880-890). Idle: 230-300 (memorize), 320-700 (the host is in the pass
# at 320), 750-880 (pass). Blocking: one in decode, one in memorize, one
# after the round (the harness's own).
EVENTS = [
    _x("user_annotation", "mivos.interact", 0, 1000),
    _x("user_annotation", "mivos.pass", 100, 800),
    _x("user_annotation", "memorize", 190, 130),
    _x("user_annotation", "mivos.memorize", 200, 110),
    _x("user_annotation", "mivos.decode", 500, 100),
    _launch(1, 205), _kernel(1, 210, 20),
    _launch(2, 250), _kernel(2, 300, 20),
    _launch(3, 550), _kernel(3, 700, 50),
    _launch(4, 850), _kernel(4, 880, 10),
    _x("cuda_runtime", "cudaStreamSynchronize", 560, 5),
    _x("cuda_runtime", "cudaEventSynchronize", 280, 5),
    _x("cuda_runtime", "cudaDeviceSynchronize", 1100, 5),
]
COUNTERS = {"rounds": 1, "frames": 2, "read_rows": 10, "memorize": 4,
            "memorize_unread": 1}


@pytest.fixture
def made_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return path


def test_second_read_of_a_made_trace(made_trace):
    pt = read_program_trace(made_trace, trace.SPANS, COUNTERS)
    assert pt.host_s == pytest.approx({"mivos.interact": 1e-3, "mivos.pass": 8e-4,
                                       "mivos.memorize": 1.1e-4, "mivos.decode": 1e-4})
    assert pt.kernels == {"mivos.memorize": 2, "mivos.decode": 1, "mivos.pass": 1}
    assert pt.device_s == pytest.approx({"mivos.memorize": 4e-5, "mivos.decode": 5e-5,
                                         "mivos.pass": 1e-5})
    assert pt.idle_s == pytest.approx({"mivos.memorize": 7e-5, "mivos.pass": 5.1e-4})
    assert pt.idle_gaps()[0][0] == "mivos.pass"
    assert pt.syncs == {"mivos.decode": 1, "mivos.memorize": 1, HOST: 1}
    assert metrics(pt) == pytest.approx({
        "memorize_launches_per_call": 0.5, "memorize_host_ms_per_call": 0.0275,
        "memorize_idle_ms_per_call": 0.0175, "memorize_unread_pct": 25.0,
        "host_syncs_per_frame": 1.0})


def test_harness_read_sees_no_program_span(made_trace):
    """The harness's own read of the same trace gives no device time,
    kernel or gap to a `mivos.*` name."""
    summary = read_chrome_trace(made_trace, 1e-3, HARNESS_SPANS)
    names = set(summary.span_device_s) | {n for n, _ in summary.idle_gaps}
    assert names and not {n for n in names if n.startswith(trace.PREFIX)}
    assert summary.kernels == 4


def test_no_runtime_calls_no_sync_number(made_trace):
    data = json.loads(made_trace.read_text())
    data["traceEvents"] = [e for e in data["traceEvents"]
                           if not e["name"].endswith("Synchronize")]
    made_trace.write_text(json.dumps(data))
    out = metrics(read_program_trace(made_trace, trace.SPANS, COUNTERS))
    assert "host_syncs_per_frame" not in out
    assert out["memorize_unread_pct"] == 25.0
    assert metrics(None) == {}


def test_cpu_session_read_twice(tmp_path):
    """A tiny session profiled on the CPU with the program's tracing on:
    every span the pass runs is read with its ranges, the memorize ranges
    are the counted calls, a pass's last frame is one call in each pass,
    and the harness's read of the same trace stays on its own names."""
    from mivos_tpu_torch.core.inference import InferenceCore
    from mivos_tpu_torch.config import MemoryConfig
    from mivos_tpu_torch.models.fusion import FusionNet
    from mivos_tpu_torch.models.initializer import init_params
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    gen = torch.Generator().manual_seed(1)
    prop = init_params(PropagationNetwork(top_k=10, read_backend="exact"), gen)
    fuse = init_params(FusionNet(), gen)
    rng = np.random.RandomState(1)
    t, k = 6, 2
    core = InferenceCore(prop, fuse, rng.rand(t, 32, 48, 3).astype(np.float32), k,
                         mem=MemoryConfig(top_k=10, mem_freq=2), device="cpu")
    mask = np.full((k + 1, 32, 48, 1), 1.0 / (k + 1), np.float32)
    path = tmp_path / "trace.json"
    trace.enable()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            for idx in (2, 5):   # passes 3-5, 1-0 and 4-3 (with fusion)
                core.interact(mask, idx, chunk_cb=lambda *a: None)
    finally:
        trace.disable()
    prof.export_chrome_trace(str(path))
    pt = read_program_trace(path, trace.SPANS, trace.counters())
    assert pt.ranges["mivos.interact"] == 2 and pt.ranges["mivos.pass"] == 4
    assert pt.ranges["mivos.memorize"] == pt.counters["memorize"] == 7 + 2
    for name in ("read", "decode", "aggregate", "bank_write", "fuse",
                 "chunk_issue", "hand_over", "precompute", "render"):
        assert pt.ranges["mivos." + name] > 0, name
    assert not pt.kernels and not pt.idle_s and not pt.syncs   # no card
    out = metrics(pt)
    assert out["memorize_unread_pct"] == pytest.approx(100.0 * 3 / 9)
    assert out["memorize_host_ms_per_call"] > 0
    assert "host_syncs_per_frame" not in out
    summary = read_chrome_trace(path, 1.0, HARNESS_SPANS)
    assert not [n for n in summary.span_device_s if n.startswith(trace.PREFIX)]
