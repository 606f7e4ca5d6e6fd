"""The measuring entry points' kernel paths on the card: the gate in
bench's protocol, refine_sweep's launch arithmetic and a bench session's
launches against its reads.

Needs an NVIDIA Hopper GPU and nvcc: marked `cuda`, skipped without a
card. Run on the card with
`python -m pytest tests/test_torch_measure_card.py --noconftest -q`.
Banks are tests/test_torch_kernels.py's peaked keys, K = 3, N = 1620.
The gate's bounds are the JAX script's (mean < 1e-3, max < 0.3 of the
readout scale) and gate_read's (against plain, mean <= 1e-4 of it).
"""
import numpy as np
import pytest
import torch
from test_torch_kernels import _peaky

from mivos_tpu_torch import bench, kernel_check, refine_sweep
from mivos_tpu_torch.utils.measure import LaunchTally, interaction_mask

pytestmark = pytest.mark.cuda
K, M, N = 3, 8192, 1620


@pytest.fixture(scope="module", autouse=True)
def _card_and_full_fp32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(scope="module")
def banks():
    return [torch.from_numpy(x).cuda() for x in _peaky(np.random.RandomState(7), K, M, N)]


def test_gate_runs_gate_read_on_the_card(banks):
    rep = kernel_check.gate(*banks, log=lambda *a: None)
    assert [(r["M"], r["dtype"]) for r in rep["reports"]] == [
        (M // 2, "float32"), (M // 2, "bfloat16"), (M, "bfloat16")]
    assert rep["worst_mean_err_frac"] < 1e-3
    errs = rep["per_kernel_max_abs_err"]
    assert sorted(errs) == ["bfloat16", "float32"]
    assert errs["float32"]["hilo_planes"] == 0.0


def test_refine_sweep_launches_refine_n_times_a_read(banks):
    mk, mv, q = banks
    valid = torch.arange(M, device="cuda") < M - kernel_check.TAIL
    rep = refine_sweep.sweep(mk, mv, q, valid, log=lambda *a: None)
    reads = 1 + refine_sweep.TIMING_ITERS + refine_sweep.TIMING_WARMUP
    for row, counts in zip(rep["rows"], rep["launches"]):
        r = row["n_refine"]
        assert counts["candidates_bf16"] == counts["readout_merge"] == reads
        assert counts["refine_bf16"] == counts["refine_merge"] == r * reads
        assert row["ms"] > 0 and row["mean_pct_of_scale"] < 0.1


def test_bench_sessions_launch_per_read():
    dev = torch.device("cuda")
    prop, fuse = bench.make_nets(dev)
    images = bench.video(dev, 8, 64, 96)
    masks = [interaction_mask(s, 64, 96, 2, dev) for s in range(3)]
    tally = LaunchTally(dev)
    fps = bench.sessions(prop, fuse, images, 2, masks[:2], masks[2], dev, tally)
    assert len(fps) == 2 and tally.reads == 2 * 7
    counts = tally.check("bench sessions on the card")
    assert counts["candidates_bf16"] == counts["readout_bf16"] == 14
