"""The control, on the card: the reference one precision step below
each configuration (fp8 for bf16, TF32 for fp32) fails the limits of
that configuration's DAVIS cell, and the program passes them, at a size
a test run holds (24 frames of 240x427, K = 3, three rounds), on three
seeds. The cell-sized readings are `python3 -m ivos_bench.calibrate
--workload <cell> --seeds ... --control` (PERF.md)."""
from __future__ import annotations

import pytest
import torch

from ivos_bench.tests.wiring import tiny_bench

SMALL = {"frames": 24, "height": 240, "width": 427, "objects": 3, "clips": 1,
         "schedules": [[0, 17, 8]], "mem_freq": 5}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["tiny-bf16", "tiny-fp32"])
def test_control_fails_and_program_passes(tmp_path, cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ivos_bench import calibrate

    root = tiny_bench(tmp_path, SMALL)
    lines = calibrate.main(["--workload", cell, "--seeds", "11,12,2147483659",
                            "--control"], bench_file=tmp_path / "BENCHMARK.json",
                           root=root)
    assert len(lines) == 3
    for line in lines:
        assert line["program_correct"] is True, line
        assert line["control_correct"] is False, line
