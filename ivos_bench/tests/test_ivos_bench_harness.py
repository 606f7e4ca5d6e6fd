"""The harness's wiring on the CPU at a tiny size: found by name,
driven by data, and free of JAX."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from ivos_bench.tests.wiring import REPO, run_tiny, tiny_bench


def test_a_cell_made_of_new_files_runs(tmp_path):
    """A new configuration, traffic mix and metric, each a new file plus
    entries in BENCHMARK.json, run without an edit to any file there."""
    root = tiny_bench(tmp_path)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "mivos-prop-fusion-fp32.json").read_text())
    cfg.update(name="dummy-prop-only", fusion=False)
    (root / "configs" / "dummy-prop-only.json").write_text(json.dumps(cfg))
    (root / "traffic" / "dummy.json").write_text(json.dumps(
        {"frames": 8, "height": 48, "width": 64, "objects": 1, "clips": 1,
         "schedules": [[2, 6]], "mem_freq": 3}))
    (root / "cells" / "dummy-cell.json").write_text(json.dumps(
        {"limits": {"prob_mae": 1e-3}}))
    (root / "metrics" / "dummy_rounds.py").write_text(
        "def read(run):\n    return float(len(run.rounds))\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy-prop-only", "source": "test",
                            "file": "ivos_bench/configs/dummy-prop-only.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy-prop-only",
                              "traffic": "dummy", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "dummy_rounds", "unit": "rounds",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock", "workloads": ["dummy-cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    out = run_tiny(root, "dummy-cell", seed=2**31 + 7, seconds=6)
    assert out["correct"] is True
    assert out["metrics"]["dummy_rounds"]["value"] >= 2
    assert set(out["metrics"]) == {"setup_s", "dummy_rounds"}
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"


def test_traced_wiring_run_reports_per_layer_metrics(tmp_path):
    root = tiny_bench(tmp_path)
    out = run_tiny(root, "tiny-fp32", seed=9, seconds=12, trace=1)
    assert out["correct"] is True
    assert {"round_p50_ms", "round_p90_ms.session", "first_masks_p90_ms.session",
            "mfu_pct"} <= set(out["metrics"])
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_session_readers_leave_out_profiled_rounds():
    """The session readers read the rounds outside the profiled part."""
    from ivos_bench.run import Round, Run, _load_reader

    run = Run(config={}, seconds=1.0, rounds=[Round(ms=float(i), first_ms=i / 2.0)
                                              for i in range(1, 11)])
    run.rounds += [Round(ms=1e6, first_ms=1e6, traced=True)] * 5
    metrics = REPO / "ivos_bench" / "metrics"
    assert _load_reader(metrics / "round_p50_ms.py")(run) == 5.0
    assert _load_reader(metrics / "round_p90_ms.session.py")(run) == 9.0
    assert _load_reader(metrics / "first_masks_p90_ms.session.py")(run) == 4.5


def _run_cli(cwd: Path, env_path: str, *extra) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=env_path)
    return subprocess.run([sys.executable, "-c", *extra], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_wiring_run_loads_no_jax(tmp_path):
    """A whole wiring run in a fresh process, then its modules: no
    top-level name jax, jaxlib, flax or mivos_tpu, compared whole."""
    root = tiny_bench(tmp_path)
    code = ("import sys; from pathlib import Path; from ivos_bench.tests.wiring import run_tiny;"
            f"out = run_tiny(Path({str(root)!r}), 'tiny-bf16', seed=4, seconds=8);"
            "tops = {m.split('.')[0] for m in sys.modules};"
            "assert 'mivos_tpu_torch' in tops;"
            "bad = sorted(tops & {'jax', 'jaxlib', 'flax', 'mivos_tpu'});"
            "print('BAD', bad); sys.exit(1 if bad or not out['correct'] else 0)")
    r = _run_cli(REPO, str(REPO), code)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "BAD []" in r.stdout


def test_a_reader_that_loads_jax_gets_no_result(tmp_path):
    """A metric reader, loaded after the window, that puts a JAX module in
    sys.modules: the run exits with code 3 and prints no result."""
    root = tiny_bench(tmp_path)
    (root / "metrics" / "dummy_jax.py").write_text(
        "import sys\nsys.modules['jax'] = object()\n\n\n"
        "def read(run):\n    return 1.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "dummy_jax", "unit": "x", "better": "higher",
                               "bound": 0.1, "source": "host_clock",
                               "workloads": ["tiny-fp32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("from pathlib import Path; from ivos_bench.tests.wiring import run_tiny;"
            f"run_tiny(Path({str(root)!r}), 'tiny-fp32', seed=4, seconds=3)")
    r = _run_cli(REPO, str(REPO), code)
    assert r.returncode == 3, r.stdout[-2000:] + r.stderr[-2000:]
    assert r.stdout.strip() == ""
    assert "forbidden modules loaded: ['jax']" in r.stderr


def test_no_card_no_result():
    """From the command line without a CUDA device: exit code 2, no JSON."""
    r = subprocess.run([sys.executable, "-m", "ivos_bench.run", "--workload",
                        "davis8-bf16-k3", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2
    assert r.stdout.strip() == ""


def test_harness_alone_gives_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the harness, a run
    fails before printing anything: the program is not there."""
    shutil.copytree(REPO / "ivos_bench", tmp_path / "ivos_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = ("from ivos_bench import run;"
            "run.main(['--workload', 'davis8-bf16-k3', '--seed', '1', '--seconds', '1',"
            " '--trace', '0'], device='cpu')")
    r = _run_cli(tmp_path, str(tmp_path), code)
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "mivos_tpu_torch" in r.stderr
