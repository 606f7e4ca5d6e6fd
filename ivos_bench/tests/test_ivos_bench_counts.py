"""The yardstick's counts: the read's work whatever backend reads, the
model's work per phase on MiVOS's schedule whatever the program calls,
and the towers' FLOPs against `mfu_report`'s count."""
from __future__ import annotations

import pytest
import torch

from ivos_bench.counts import (Schedule, Work, phase_flops, read_bytes, read_flops,
                               read_least_s)
from ivos_bench.spans import Spans
from ivos_bench.weights import make_weights

K, H, W, T = 2, 64, 96, 8
ROUNDS = [0, 5]


def _session(backend: str, device: str, fusion: bool = False):
    """A two-round session on `backend` under the spans, its work also
    counted on MiVOS's schedule from the frames chunk_cb hands over:
    (spans' counts, schedule's work)."""
    from ivos_bench.clips import interaction_mask, make_clip
    from mivos_tpu_torch.config import MemoryConfig
    from mivos_tpu_torch.core.inference import InferenceCore
    from mivos_tpu_torch.models.fusion import FusionNet
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    sd, fsd = make_weights(4, torch.float32, device, fusion=fusion)
    prop = PropagationNetwork(top_k=50, read_backend=backend).to(device)
    prop.load_state_dict(sd)
    fuse = None
    if fusion:
        fuse = FusionNet().to(device)
        fuse.load_state_dict(fsd)
    frames, labels = make_clip(4, 0, T, H, W, K, device)
    schedule, work = Schedule(T, K, (H // 16) * (W // 16), 2, fusion), Work()
    spans = Spans().install()
    try:
        spans.active = True
        core = InferenceCore(prop, fuse, frames, K, mem=MemoryConfig(mem_freq=2),
                             device=device)
        for idx in ROUNDS:
            schedule.interact(idx, work)
            core.interact(interaction_mask(labels[idx], K), idx,
                          chunk_cb=lambda tis, labs: schedule.count(work, tis))
    finally:
        spans.uninstall()
    return spans.counts, work


def _counted_reads(backend: str, device: str):
    """(K, N, M, itemsize) of every read of the session, as the spans
    count them."""
    return _session(backend, device)[0]


def _work(counts):
    return (sum(read_flops(k, n, m, 50) for k, n, m, _ in counts.reads),
            sum(read_bytes(k, n, m, b) for k, n, m, b in counts.reads),
            sum(read_least_s(k, n, m, b, 50) for k, n, m, b in counts.reads))


def test_read_work_is_the_same_for_exact_and_plain():
    exact, plain = _counted_reads("exact", "cpu"), _counted_reads("plain", "cpu")
    assert exact.reads == plain.reads
    assert len(exact.reads) == (T - 1) + (T - 2)
    assert _work(exact) == _work(plain)


def _last_frame_memorize_skipped(monkeypatch) -> list:
    """The program skips the memorize of each pass's last frame, whose
    keys no read uses, and writes the frame before it's in their place.
    Returns the list of skipped frames."""
    from mivos_tpu_torch.core.inference import InferenceCore

    do_pass, memorize = InferenceCore.do_pass, InferenceCore._memorize
    skipped = []

    def do_pass_marked(self, key_k, idx, forward, *args, **kwargs):
        ends = [ti for ti in self.interacted if (ti > idx if forward else ti < idx)]
        self._last = (min(ends + [self.t]) - 1) if forward else (max(ends + [-1]) + 1)
        return do_pass(self, key_k, idx, forward, *args, **kwargs)

    def memorize_skipping(self, ti, masks):
        if ti == getattr(self, "_last", None) and hasattr(self, "_kept"):
            skipped.append(ti)
            return self._kept
        self._kept = memorize(self, ti, masks)
        return self._kept
    monkeypatch.setattr(InferenceCore, "do_pass", do_pass_marked)
    monkeypatch.setattr(InferenceCore, "_memorize", memorize_skipping)
    return skipped


@pytest.mark.parametrize("fusion", [False, True], ids=["prop", "fusion"])
def test_schedule_counts_the_model_not_the_calls(monkeypatch, fusion):
    """The schedule's work agrees with the program's calls (each read a
    decode, each fused frame a fusion; the program memorizes each pass's
    last frame besides MiVOS's), and stays the same when the program
    drops the memorize calls MiVOS does not make."""
    counts, work = _session("exact", "cpu", fusion)
    passes = 1 + 2          # passes with frames: round 0 forward; round 1 both ways
    assert work.decode == len(counts.reads) == (T - 1) + (T - 2)
    assert sorted(work.reads) == sorted((k, n, m) for k, n, m, _ in counts.reads)
    assert work.fuse == counts.calls.get("fuse", 0) == (4 if fusion else 0)   # 4..1 to frame 0
    assert work.memorize == counts.calls["memorize"] - passes
    assert work.encode == T - 1          # each propagated frame once a session
    skipped = _last_frame_memorize_skipped(monkeypatch)
    work_skipping = _session("exact", "cpu", fusion)[1]
    assert sorted(skipped) == [1, T - 1, T - 1]   # a pass's last frame each
    assert work_skipping == work


@pytest.mark.cuda
def test_read_work_is_the_same_for_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cuda, exact = _counted_reads("cuda", "cuda"), _counted_reads("exact", "cuda")
    assert cuda.reads == exact.reads
    assert _work(cuda) == _work(exact)


def test_read_count_formula():
    k, n, m = 3, 1620, 21060
    assert read_flops(k, n, m, 50) == 2 * k * n * m * 128 + 2 * k * n * 50 * 512
    assert read_bytes(k, n, m, 2) == k * m * 640 * 2 + n * 128 * 2 + k * n * 512 * 4
    # A bf16 bank at M = 21060 is bound by its bytes (0.0272 ms) just above
    # its FLOPs at the bf16 tensor peak (0.0267 ms).
    assert read_least_s(k, n, m, 2, 50) == pytest.approx(
        max(read_flops(k, n, m, 50) / 989e12, read_bytes(k, n, m, 2) / 3.35e12))
    assert read_least_s(k, n, m, 2, 50) == pytest.approx(2.7235e-5, rel=1e-4)


def test_tower_flops_match_mfu_report():
    from mivos_tpu_torch.mfu_report import make_net, phase_costs, read_cost

    ours = phase_flops(480, 864, 3)
    theirs = phase_costs(make_net("meta"), "meta")
    assert ours["encode"] == pytest.approx(theirs["query_encode"]["gflops"] * 1e9, rel=1e-9)
    assert ours["memorize"] == pytest.approx(theirs["memorize"]["gflops"] * 1e9, rel=1e-9)
    decode = theirs["read_decode"]["gflops"] - read_cost(3, 1620, 20480)["gflops"]
    assert ours["decode"] == pytest.approx(decode * 1e9, rel=1e-9)
    assert ours["fuse"] > 0
