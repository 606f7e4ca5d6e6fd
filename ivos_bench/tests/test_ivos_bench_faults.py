"""`correct` comes out false when the timed path is broken underneath.

Each case drives a whole wiring run of a tiny cell (held to the limits
of the full-size cell of its shape: `wiring.py`) with one fault of
`faults.py` planted in the program for the run's duration, and sees
`correct` false. DAVIS-shaped cells: a step that leaves its state
unchanged, half of the frames of the batched query encode left out with
the mean of the rest in their place, and one answer altered where it is
produced. The long-shaped cell, one round from frame 0 (where every
frame's state starts unset, so the state a step could leave unchanged
is the bank's): the bank's commits after the first left undone. A sound
run of each cell comes out true. Half of the objects' readouts replaced
by the mean of the rest (`half_objects`) is caught by no cell: the
seeded weights carry little of an object's identity (PERF.md). The fp32 cells hold only the median gap, the one
number their TF32 control fails (PERF.md): one altered frame among a
session's hundreds does not move it, so that fault is held in the bf16
cells.
"""
from __future__ import annotations

import pytest

from ivos_bench.faults import plant
from ivos_bench.tests.wiring import run_tiny, tiny_bench


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny_bench(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("cell", ["tiny-bf16", "tiny-fp32", "tiny-long-bf16"])
def test_sound_run_is_correct(bench, cell):
    out = run_tiny(bench, cell, seed=3, seconds=15)
    assert out["correct"] is True, out["compared"]


@pytest.mark.parametrize("cell, fault", [
    ("tiny-bf16", "state_unchanged"), ("tiny-bf16", "half_batch"),
    ("tiny-bf16", "answer_altered"), ("tiny-fp32", "state_unchanged"),
    ("tiny-fp32", "half_batch"), ("tiny-long-bf16", "bank_commits_dropped")],
    ids=["bf16-state_unchanged", "bf16-half_batch", "bf16-answer_altered",
         "fp32-state_unchanged", "fp32-half_batch", "long-bank_commits_dropped"])
def test_fault_is_not_correct(bench, cell, fault):
    with plant(fault):
        out = run_tiny(bench, cell, seed=3, seconds=15)
    assert out["correct"] is False, out["compared"]
