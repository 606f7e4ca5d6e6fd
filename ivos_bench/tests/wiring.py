"""A temporary copy of the harness with tiny cells, for CPU wiring runs.

`tiny_bench(tmp)` copies `ivos_bench/` and BENCHMARK.json into `tmp`,
adds two tiny traffic mixes, DAVIS-shaped (`tiny`: 10 frames of 64x90,
K = 2, three rounds) and long-shaped (`tiny-long`: 16 frames, K = 2, one
round at frame 0, a commit every frame), and on them a cell of each
configuration held to the limits of the full-size cell of that shape,
and returns the copy's root folder. The networks keep their published
widths; only the clips are small.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1]
REPO = HARNESS.parent
TINY = {"frames": 10, "height": 64, "width": 90, "objects": 2, "clips": 2,
        "schedules": [[0, 7, 3], [0, 4, 8]], "mem_freq": 2,
        "finish_last_round": True,
        "warm": {"frames": 6, "rounds": [0, 3]}, "trace": [0.0, 1.0]}
TINY_LONG = {"frames": 16, "height": 64, "width": 90, "objects": 2, "clips": 1,
             "schedules": [[0]], "mem_freq": 1, "finish_last_round": False,
             "warm": {"frames": 6, "cache_queries": False}, "trace": [0.0, 1.0]}
# tiny cell -> (configuration, traffic mix, the cell whose limits it takes)
CELLS = {"tiny-bf16": ("mivos-prop-fusion-bf16", "tiny", "davis8-bf16-k3"),
         "tiny-fp32": ("mivos-prop-fusion-fp32", "tiny", "davis8-fp32-k3"),
         "tiny-long-bf16": ("mivos-prop-fusion-bf16", "tiny-long", "long480-bf16-k2")}


def tiny_bench(tmp: Path, traffic: dict = TINY) -> Path:
    """`traffic` takes the place of the `tiny` mix."""
    root = Path(tmp) / "ivos_bench"
    shutil.copytree(HARNESS, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (root / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    (root / "traffic" / "tiny-long.json").write_text(json.dumps(TINY_LONG))
    for name, (config, mix, limits) in CELLS.items():
        spec["workloads"].append({"name": name, "config": config, "traffic": mix,
                                  "chips": 1, "why": "CPU wiring"})
        shutil.copy(HARNESS / "cells" / f"{limits}.json", root / "cells" / f"{name}.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(CELLS)
    (Path(tmp) / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run_tiny(root: Path, workload: str = "tiny-fp32", seed: int = 5,
             seconds: float = 3.0, trace: int = 0) -> dict:
    from ivos_bench import run

    return run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                     str(seconds), "--trace", str(trace)], device="cpu",
                    bench_file=root.parent / "BENCHMARK.json", root=root)
