"""The interaction seam (`interactions/`) and the program's spans in a
traced run, on the CPU at a tiny size (`wiring.py`).

- The `mask` interaction hands the program and the reference the same
  masks as the direct `interaction_mask` calls did, and the check reads
  the same numbers and frame counts from them.
- A configuration that names a new interaction runs from new files and
  new entries alone, and the check holds the interaction's masks to its
  reference by the numbers the module names.
- A traced run hands the program's spans and counters to the readers,
  and leaves the program's tracing off after the window, failed rounds
  or not.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from ivos_bench.tests.wiring import REPO, run_tiny, tiny_bench

ERODE = '''"""Test-only interaction: the label mask with each object eroded by the
mix's `radius` pixels."""
import importlib.util
from pathlib import Path

import torch
import torch.nn.functional as F

from ivos_bench.clips import interaction_mask

NUMBERS = ("prob_mae", "frame_mae_max")


class Erode:
    def __init__(self, radius):
        self.radius = radius

    def round(self, frame_u8, labels, k, prob):
        m = interaction_mask(labels, k)[..., 0]
        r = self.radius
        objs = -F.max_pool2d(-m[1:][None], 2 * r + 1, 1, r)[0]
        return torch.cat([1 - objs.sum(0, keepdim=True), objs])[..., None], {"radius": r}


def setup(cell, seed, dev):
    return Erode(cell.traffic.interaction["radius"])


def reference(cell, seed, dev):
    path = Path(__file__).resolve().parents[1] / "reference" / "erode.py"
    spec = importlib.util.spec_from_file_location("ivos_reference_erode", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Eroded()
'''
ERODE_REFERENCE = '''"""Plain erosion of each object's label mask by shifts."""
import torch


class Eroded:
    def replay(self, frame_u8, labels, k, record):
        r = record["radius"]
        h, w = labels.shape
        objs = []
        for obj in range(1, k + 1):
            m = torch.nn.functional.pad((labels == obj).float(), (r, r, r, r), value=1.0)
            out = torch.ones((h, w), device=labels.device)
            for dy in range(2 * r + 1):
                for dx in range(2 * r + 1):
                    out = torch.minimum(out, m[dy:dy + h, dx:dx + w])
            objs.append(out)
        objs = torch.stack(objs)
        return torch.cat([1 - objs.sum(0, keepdim=True), objs])[..., None]
'''


def _digest(root: Path) -> dict:
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_mask_interaction_matches_direct_calls(tmp_path):
    """Masks, the checked session's answers, per-round frame counts and
    the compared numbers equal those of the direct `interaction_mask`
    calls, with the reference replayed as the check did before the seam."""
    from ivos_bench.cell import build_program, load_cell, new_session, play
    from ivos_bench.check import Gap, changed, due, gaps, host_copy
    from ivos_bench.clips import interaction_mask, make_clip
    from ivos_bench.reference.nets import build
    from ivos_bench.reference.precision import tf32
    from ivos_bench.reference.session import Session
    from ivos_bench.weights import make_weights

    root = tiny_bench(tmp_path)
    cell = load_cell(json.loads((tmp_path / "BENCHMARK.json").read_text()),
                     "tiny-bf16", root)
    dev, seed, t = torch.device("cpu"), 2**31 + 11, cell.traffic
    plan = next(p for p in t.sessions(seed) if p.index == t.checked(seed))
    sd, fsd = make_weights(seed, cell.dtype, dev)
    clip = make_clip(seed, plan.clip, t.t, t.h, t.w, t.k, dev)
    frames_u8, labels = clip
    prop, fuse = build_program(cell, sd, fsd, dev)

    direct, direct_counts = [], []
    core = new_session(cell, prop, fuse, frames_u8, dev)
    for r, idx in enumerate(plan.rounds):
        direct_counts.append(0)
        core.interact(interaction_mask(labels[idx], t.k), idx,
                      chunk_cb=lambda tis, labs: direct_counts.__setitem__(
                          -1, direct_counts[-1] + len(tis)))
        direct.append((idx, host_copy(core.prob, due(core.t, plan.rounds[:r], idx))))

    inter = cell.interaction.setup(cell, seed, dev)
    for idx in plan.rounds:
        mask, record = inter.round(frames_u8[idx], labels[idx], t.k, None)
        assert record is None and torch.equal(mask, interaction_mask(labels[idx], t.k))

    class Counting:
        def round(self, *args):
            seam_counts.append(0)
            return inter.round(*args)

    seam_counts = []
    seam = play(new_session(cell, prop, fuse, frames_u8, dev), plan.rounds, clip, t.k,
                Counting(), chunk_cb=lambda tis, labs: seam_counts.__setitem__(
                    -1, seam_counts[-1] + len(tis)))
    assert seam_counts == direct_counts and sum(seam_counts) > 0
    for (idx, probs), s in zip(direct, seam):
        assert s.frame == idx and s.record is None and s.mask is None
        assert probs.keys() == s.probs.keys()
        assert all(torch.equal(probs[ti], s.probs[ti]) for ti in probs)

    found = Gap(dev)
    ref_prop, ref_fuse = build(sd, dev, cell.config["top_k"], fsd)
    with tf32(False), torch.no_grad():
        ref = Session(ref_prop, ref_fuse, frames_u8, t.k, t.mem_freq,
                      cache_queries=len(plan.rounds) > 1)
        for r, idx in enumerate(plan.rounds):
            before = list(ref.prob)
            after = ref.interact(interaction_mask(labels[idx], t.k), idx)
            for ti in changed(before, after, idx):
                p = direct[r][1].get(ti)
                found.add(torch.zeros_like(after[ti]) if p is None else p, after[ti],
                          ref.pad)
    numbers = gaps([(plan, {"program": seam})], sd, fsd, cell, {plan.clip: clip},
                   cell.interaction.reference(cell, seed, dev), dev)["program"]
    assert numbers == found.numbers()
    assert not any(name.startswith("interaction_") for name in numbers)


@pytest.mark.parametrize("fault", [None, "interaction_altered"])
def test_a_configuration_naming_a_new_interaction_runs(tmp_path, fault):
    """An interaction module, its reference, a configuration, a mix and a
    cell, each a new file, plus entries in BENCHMARK.json: the cell runs
    end to end and reports its `interaction_` numbers, which catch the
    interaction's answer altered where it is made; no file that was
    there changes."""
    from ivos_bench.faults import plant

    root = tiny_bench(tmp_path)
    before = _digest(tmp_path)
    (root / "interactions" / "erode.py").write_text(ERODE)
    (root / "reference" / "erode.py").write_text(ERODE_REFERENCE)
    cfg = json.loads((root / "configs" / "mivos-prop-fusion-fp32.json").read_text())
    cfg.update(name="erode-fp32", interaction="erode")
    (root / "configs" / "erode-fp32.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic" / "tiny.json").read_text())
    mix["interaction"] = {"radius": 2}
    (root / "traffic" / "tiny-erode.json").write_text(json.dumps(mix))
    (root / "cells" / "tiny-erode.json").write_text(json.dumps(
        {"limits": {"prob_p50": 1.6e-5, "interaction_prob_mae": 0.0}}))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "erode-fp32", "source": "test",
                            "file": "ivos_bench/configs/erode-fp32.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-erode", "config": "erode-fp32",
                              "traffic": "tiny-erode", "chips": 1, "why": "test"})
    next(m for m in spec["end_to_end"] if m["name"] == "prop_fps.card")[
        "workloads"].append("tiny-erode")
    before.pop(tmp_path / "BENCHMARK.json")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    if fault is None:
        out = run_tiny(root, "tiny-erode", seed=2**31 + 3, seconds=8)
    else:
        with plant(fault):
            out = run_tiny(root, "tiny-erode", seed=2**31 + 3, seconds=8)
    assert set(out["metrics"]) == {"setup_s", "prop_fps.card"}
    got = out["compared"]["interaction_prob_mae"]["value"]
    if fault is None:
        assert out["correct"] is True, out["compared"]
        assert got == 0.0
    else:
        assert out["correct"] is False and got > 0.0, out["compared"]
    after = _digest(tmp_path)
    assert {p: after[p] for p in before} == before


@pytest.mark.parametrize("failing", [False, True], ids=["sound", "failing_rounds"])
def test_traced_run_reads_the_programs_spans(tmp_path, failing):
    """`Run.program` holds the program's `mivos.interact` ranges and a
    non-zero `frames` counter, the harness's own read keeps to its span
    names, the new readers have nothing to read without the card's
    runtime calls, and the program's tracing is off after the window,
    also when the rounds under it fail."""
    from ivos_bench import run as run_mod
    from mivos_tpu_torch.core.inference import InferenceCore
    from mivos_tpu_torch.utils import trace

    root = tiny_bench(tmp_path)
    summary = run_mod.Tracer.summary
    seen = []

    def keep(self, spans):
        seen.append(summary(self, spans))
        return seen[-1]

    interact = InferenceCore.interact

    def fail_when_traced(self, *args, **kwargs):
        if trace._on:
            raise RuntimeError("planted")
        return interact(self, *args, **kwargs)

    with mock.patch.object(run_mod.Tracer, "summary", keep), \
            mock.patch.object(InferenceCore, "interact",
                              fail_when_traced if failing else interact):
        out = run_tiny(root, "tiny-bf16", seed=2**31 + 5, seconds=10, trace=1)
    assert trace._on is False
    harness, program = seen[0]
    assert not [n for n in harness.span_device_s if n.startswith(trace.PREFIX)]
    assert "host_syncs_per_frame" not in out["metrics"]   # no card, no runtime calls
    if failing:
        assert out["failed"] >= 1 and out["correct"] is False
        assert program.counters["frames"] == 0
    else:
        assert out["failed"] == 0 and out["correct"] is True
        assert program.ranges["mivos.interact"] > 0
        assert program.counters["frames"] > 0
        assert program.host_s["mivos.interact"] > 0


def test_host_sync_readers():
    from ivos_bench.program_trace import ProgramTrace
    from ivos_bench.run import Run, _load_reader
    from ivos_bench.trace import HOST

    metrics = REPO / "ivos_bench" / "metrics"
    run = Run(config={}, seconds=1.0)
    for name in ("host_syncs_per_frame", "host_syncs_per_frame.card"):
        read = _load_reader(metrics / f"{name}.py")
        run.program = None
        assert read(run) is None
        run.program = ProgramTrace(counters={"frames": 4},
                                   syncs={"mivos.chunk_wait": 3, "mivos.fuse": 2, HOST: 7})
        assert read(run) == 1.25
        run.program = ProgramTrace(counters={"frames": 4})
        assert read(run) is None


def test_an_interaction_that_loads_jax_gets_no_result(tmp_path):
    """An interaction module that puts a JAX module in sys.modules when it
    is loaded: the run exits with code 3 and prints no result."""
    root = tiny_bench(tmp_path)
    (root / "interactions" / "jaxy.py").write_text(
        "import sys\n\nfrom ivos_bench.interactions.mask import reference, setup  # noqa\n\n"
        "sys.modules['jax'] = object()\n")
    cfg = json.loads((root / "configs" / "mivos-prop-fusion-fp32.json").read_text())
    cfg.update(name="jaxy", interaction="jaxy")
    (root / "configs" / "jaxy.json").write_text(json.dumps(cfg))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "jaxy", "source": "test",
                            "file": "ivos_bench/configs/jaxy.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "tiny-jaxy", "config": "jaxy", "traffic": "tiny",
                              "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "cells" / "tiny-jaxy.json").write_text(json.dumps({"limits": {"prob_p50": 1.0}}))
    code = ("from pathlib import Path; from ivos_bench.tests.wiring import run_tiny;"
            f"run_tiny(Path({str(root)!r}), 'tiny-jaxy', seed=4, seconds=3)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert r.returncode == 3, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.strip() == ""
    assert "forbidden modules loaded: ['jax']" in r.stderr
