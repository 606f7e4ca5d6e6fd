"""The port's spans and counters (`mivos_tpu_torch/utils/trace.py`) in
the session: off by default and then silent, nested as the round runs,
counted where the work happens, and free of any effect on the labels.

Sessions on the fixture of tests/test_torch_session.py (T=8, 45x62 raw
frames padded to 48x64, K=2, top_k=10, mem_freq=2) with FusionNet, on
the CPU: round 1 on frame 3 propagates both ways, round 2 on frame 7
back into round 1's frames with fusion (its forward pass is empty),
round 3 on frame 0 forward to frame 3 with fusion.
"""
import sys
import threading

import numpy as np
import pytest
import torch

from ivos_bench.spans import Spans
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.utils import trace
from mivos_tpu_torch.utils.measure import reads_of

T, RH, RW, K = 8, 45, 62, 2
ROUNDS = (3, 7, 0)
# The nearest enclosing mivos span of each span in a pass and in a round.
IN_PASS = {"mivos.precompute", "mivos.encode", "mivos.read", "mivos.decode",
           "mivos.aggregate", "mivos.memorize", "mivos.bank_write",
           "mivos.fuse", "mivos.chunk_issue", "mivos.hand_over"}
IN_ROUND = {"mivos.pass", "mivos.memorize", "mivos.render"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_serve.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def nets():
    gen = torch.Generator().manual_seed(0)
    prop = init_params(PropagationNetwork(top_k=10, read_backend="exact"), gen)
    fuse = init_params(FusionNet(), gen)
    rng = np.random.RandomState(0)
    images = rng.rand(T, RH, RW, 3).astype(np.float32)
    masks = []
    for _ in ROUNDS:
        labels = rng.randint(0, K + 1, (RH, RW))
        fg = (labels[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)
        masks.append(np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None])
    return prop, fuse, images, masks


def _core(nets, cache: bool) -> InferenceCore:
    prop, fuse, images, _ = nets
    return InferenceCore(prop, fuse, images, K, device="cpu",
                         mem=MemoryConfig(top_k=10, mem_freq=2, cache_queries=cache))


def _play(nets, core: InferenceCore, rounds=ROUNDS) -> dict:
    """The rounds with a chunk hook; the labels, the frames each round
    was due to read and the non-empty passes."""
    out = {"labels": [], "reads": [], "passes": 0}
    for idx, mask in zip(rounds, nets[3]):
        front = min([ti for ti in core.interacted if ti > idx] + [T])
        back = max([ti for ti in core.interacted if ti < idx] + [-1])
        out["passes"] += int(front - idx > 1) + int(idx - back > 1)
        out["reads"].append(reads_of(core, idx))
        out["labels"].append(core.interact(mask, idx, chunk_cb=lambda *a: None).copy())
    return out


def _profiled(fn, **kwargs):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                **kwargs) as prof:
        result = fn()
    return result, prof.events()


@pytest.fixture(scope="module", params=[True, False], ids=["cached", "uncached"])
def cache(request):
    return request.param


@pytest.fixture(scope="module")
def traced(cache, nets):
    """One session with tracing on, under the profiler (recording the
    ranges' inputs) and the harness's spans."""
    spans = Spans().install()
    spans.active = True
    trace.enable()
    try:
        core = _core(nets, cache)
        out, events = _profiled(lambda: _play(nets, core), record_shapes=True)
    finally:
        trace.disable()
        spans.uninstall()
    out.update(events=events, counters=trace.counters(), harness=spans.counts,
               cache=cache)
    return out


@pytest.fixture(scope="module")
def untraced(cache, nets):
    trace.disable()
    before = trace.counters()
    out, events = _profiled(lambda: _play(nets, _core(nets, cache)))
    out.update(events=events, before=before, after=trace.counters())
    return out


def _mivos_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(trace.PREFIX):
        p = p.cpu_parent
    return None if p is None else p.name


def test_off_emits_no_span_and_counts_nothing(untraced):
    names = {e.name for e in untraced["events"]}
    assert not [n for n in names if n.startswith(trace.PREFIX)]
    assert untraced["after"] == untraced["before"]


def test_spans_nest_under_the_round(traced):
    mine = [e for e in traced["events"] if e.name.startswith(trace.PREFIX)]
    assert {e.name for e in mine} <= set(trace.SPANS)
    for ev in mine:
        parent = _mivos_parent(ev)
        if ev.name == "mivos.interact":
            assert parent is None
        elif parent == "mivos.pass":
            assert ev.name in IN_PASS
        else:
            assert parent == "mivos.interact" and ev.name in IN_ROUND, (ev.name, parent)
    in_pass = {e.name for e in mine if _mivos_parent(e) == "mivos.pass"}
    assert {"mivos.read", "mivos.decode", "mivos.aggregate", "mivos.memorize",
            "mivos.bank_write", "mivos.fuse", "mivos.chunk_issue",
            "mivos.hand_over"} <= in_pass
    assert ("mivos.precompute" in in_pass) == traced["cache"]
    assert ("mivos.encode" in in_pass) != traced["cache"]


def test_round_span_carries_ordinal_and_frame(traced):
    rounds = [e for e in traced["events"] if e.name == "mivos.interact"]
    got = sorted((e.time_range.start, [int(x) for x in e.concrete_inputs])
                 for e in rounds)
    assert [args for _, args in got] == [[r, idx] for r, idx in enumerate(ROUNDS)]


def test_frames_are_the_reads_each_round_was_due(traced):
    c = traced["counters"]
    assert c["rounds"] == len(ROUNDS)
    assert c["frames"] == sum(traced["reads"]) > 0


def test_memorize_calls_and_unread_last_frames(traced):
    c = traced["counters"]
    assert c["memorize"] == c["frames"] + c["rounds"]
    assert c["memorize_unread"] == traced["passes"] == 4
    # The CPU memorizes eagerly: no graph is captured or replayed.
    assert c["memorize_graph_replays"] == c["memorize_graph_captures"] == 0


def test_read_rows_are_the_harness_reads_m(traced):
    reads = traced["harness"].reads
    assert len(reads) == traced["counters"]["frames"]
    assert traced["counters"]["read_rows"] == sum(m for _, _, m, _ in reads)


def test_counters_carry_read_launches(traced):
    """Every memory-read launch counter is in the snapshot; the CPU's
    reads run the plain version, which launches nothing."""
    from mivos_tpu_torch.ops.cuda import memory_read as cmr

    launches = {k: v for k, v in traced["counters"].items() if k.startswith("launches.")}
    assert set(launches) == {"launches." + n for n in cmr.launch_counts()}
    assert set(launches.values()) == {0}


def test_labels_bitwise_equal_on_and_off(traced, untraced):
    assert len(untraced["labels"]) == len(traced["labels"]) == len(ROUNDS)
    for a, b in zip(traced["labels"], untraced["labels"]):
        np.testing.assert_array_equal(a, b)


def test_two_threads_add_up_exactly(nets):
    """Two sessions on two threads at once count what they count one
    after the other, with the interpreter switching threads often."""
    rounds = ROUNDS[:1]
    trace.enable()
    try:
        _play(nets, _core(nets, True), rounds)
        alone = trace.counters()
        trace.enable()
        cores = [_core(nets, True) for _ in range(2)]
        errors = []

        def run(core):
            try:
                _play(nets, core, rounds)
            except Exception as e:  # noqa: BLE001 -- reported below
                errors.append(e)

        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=run, args=(c,)) for c in cores]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        both = trace.counters()
    finally:
        trace.disable()
    for name in trace.COUNTERS:
        assert both[name] == 2 * alone[name], name


def test_enable_zeroes_and_disable_freezes_launches(monkeypatch):
    from mivos_tpu_torch.ops.cuda import memory_read as cmr

    counts = dict.fromkeys(cmr.launch_counts(), 5)
    monkeypatch.setattr(cmr, "launch_counts", lambda: dict(counts))
    trace.enable()
    try:
        trace.count("frames", 3)
        counts["readout_bf16"] += 2
        trace.disable()
        counts["readout_bf16"] += 7
        trace.count("frames")   # off: not counted
        snap = trace.counters()
        assert snap["frames"] == 3 and snap["launches.readout_bf16"] == 2
        trace.enable()
        assert trace.counters()["frames"] == 0
    finally:
        trace.disable()
