"""Benchmark of the MiVOS port (`mivos_tpu_torch`) on one card.

    python3 -m ivos_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is found by name from `BENCHMARK.json` at
the checkout's root: the configuration's file (`configs/<config>.json`),
the interaction it names (`interactions/<name>.py`, default `mask`),
the traffic mix (`traffic/<mix>.json`, read by `traffic.py`), the
cell's correctness limits (`cells/<workload>.json`) and one reader per
metric (`metrics/<metric>.py`, a `read(run)` that returns a number or
None).

Set-up (`setup_s`): weights and clips made on the card from the seed,
the program's networks loaded from the state dict, the interaction's
program side (`setup`), one warm session on the cell's shapes (which
builds or loads the kernel library in the checkout's build cache). Then
the window: closed-loop annotation sessions for `--seconds`, each round
`interaction.round` on the frame, then, on the round's clock,
`InferenceCore.interact(mask, idx, chunk_cb=...)`. Frames count when
their chunk is handed over inside the window; a round in flight at its
end finishes or is cut, as the mix says. The checked session's answers
are copied to host memory after each of its rounds (`check.snap`); the
window's clock stops for those copies. With `--trace 1` the run installs
spans (`spans.py`), counts the model's work on MiVOS's schedule
(`counts.Schedule`) and profiles the part of the window the mix names,
counted from the start of the session after the checked one, with the
program's own spans and counters on over the same part
(`mivos_tpu_torch.utils.trace`); the exported trace is read twice, for
the harness's spans (`trace.py`, `Run.trace`) and for the program's
(`program_trace.py`, `Run.program`). After the window: the card's
peak memory and the comparison of the checked session with the plain
reference (`check.py`). A run in which a JAX module or the JAX package
has been loaded, checked when the window closes and again before the
result, exits with code 3 and prints no result. The last line of
standard output is one JSON object.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mivos_tpu")


class Cut(Exception):
    """Raised from the chunk hook to end a round at the window's end."""


@dataclass
class Round:
    ms: float = 0.0
    first_ms: Optional[float] = None
    traced: bool = False          # overlapped the profiled part of the window


@dataclass
class Run:
    """What the metric readers read."""
    config: Dict
    seconds: float
    traffic: object = None        # traffic.Traffic, the cell's mix
    setup_s: float = 0.0
    frames: int = 0
    rounds: List[Round] = field(default_factory=list)
    peak_bytes: int = 0
    trace: object = None          # trace.TraceSummary of the traced part
    counts: object = None         # spans.Counts of the traced part
    work: object = None           # counts.Work of the traced part
    program: object = None        # program_trace.ProgramTrace of the traced part
    phase_flops: Dict[str, float] = field(default_factory=dict)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a JAX one or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def refuse_forbidden() -> None:
    loaded = forbidden_modules()
    if loaded:
        sys.stderr.write(f"forbidden modules loaded: {loaded}\n")
        raise SystemExit(3)


def _load_reader(path: Path):
    name = "ivos_metric_" + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _profiler():
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _program_tracing():
    """The port's own spans and counters (`mivos_tpu_torch.utils.trace`),
    or None for a program without them."""
    try:
        from mivos_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def warm_profiler() -> None:
    """Start and stop a profiler once in set-up: the first start loads
    and initialises the tracing library, which takes seconds."""
    prof = _profiler()
    prof.start()
    prof.stop()


class Tracer:
    """torch.profiler over the part [start_s, end_s] of the window,
    counted from `arm(now)`: started at the first round or chunk boundary
    after start_s and stopped at the first after it has run
    end_s - start_s. The program's own tracing is on while the profiler
    runs."""

    def __init__(self, spans, span_s, sync):
        self.spans, self.sync, self.span_s = spans, sync, span_s
        self.length = span_s[1] - span_s[0]
        self.t_on = None
        self.prof = None
        self.program = _program_tracing()
        self.started = self.stopped = 0.0

    def arm(self, now: float) -> None:
        if self.t_on is None:
            self.t_on = now + self.span_s[0]

    def tick(self, now: float) -> None:
        if self.prof is None and self.t_on is not None and now >= self.t_on:
            self.prof = _profiler()
            self.sync()
            self.prof.start()
            if self.program is not None:
                self.program.enable()
            self.started = time.perf_counter()
            self.spans.active = True
        elif (self.prof is not None and not self.stopped
              and now >= self.started + self.length):
            self.stop()

    def overlaps(self, t0: float, t1: float) -> bool:
        """Whether [t0, t1] overlaps the profiled part."""
        return (self.prof is not None and self.started < t1
                and (not self.stopped or self.stopped > t0))

    def stop(self) -> None:
        if self.prof is not None and not self.stopped:
            self.sync()
            self.stopped = time.perf_counter()
            self.spans.active = False
            if self.program is not None:
                self.program.disable()
            self.prof.stop()

    def summary(self, spans: tuple):
        """(trace.TraceSummary for the harness's `spans`,
        program_trace.ProgramTrace or None), each None without a
        profile."""
        from ivos_bench.program_trace import read_program_trace
        from ivos_bench.trace import read_chrome_trace

        if self.prof is None:
            return None, None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="ivos_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            harness = read_chrome_trace(Path(path), self.stopped - self.started, spans)
            program = None if self.program is None else read_program_trace(
                Path(path), self.program.SPANS, self.program.counters())
            return harness, program
        finally:
            os.unlink(path)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: Optional[str] = None,
         bench_file: Optional[Path] = None, root: Path = HERE) -> Dict:
    """One run. `device`, `bench_file` and `root` are for the CPU wiring
    tests; a run from the command line uses the card and the checkout's
    BENCHMARK.json and files."""
    t0 = time.perf_counter()
    args = parse_args(argv)
    spec = json.loads(Path(bench_file or root.parent / "BENCHMARK.json").read_text())

    import torch

    from ivos_bench.cell import build_program, load_cell, new_session, play
    from ivos_bench.check import snap
    from ivos_bench.clips import make_clip
    from ivos_bench.weights import make_weights

    cell = load_cell(spec, args.workload, root)
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            sys.stderr.write(f"{cell.name} needs {cell.chips} CUDA device(s); "
                             f"found {have}\n")
            raise SystemExit(2)
        device = "cuda"
    dev = torch.device(device)
    cfg, traffic = cell.config, cell.traffic
    cell.set_tf32()
    is_cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if is_cuda else (lambda: None)

    # ----- set-up -----
    stages = {"start": time.perf_counter() - t0}

    def stage(name: str) -> None:
        sync()
        stages[name] = time.perf_counter() - t0

    sd, fsd = make_weights(args.seed, cell.dtype, dev, fusion=cfg["fusion"])
    stage("weights")
    clips = [make_clip(args.seed, i, traffic.t, traffic.h, traffic.w, traffic.k, dev)
             for i in range(traffic.clips)]
    stage("clips")
    prop, fuse = build_program(cell, sd, fsd, dev)
    stage("program")
    inter = cell.interaction.setup(cell, args.seed, dev)
    keep_masks = bool(cell.interaction_numbers)
    stage("interaction")
    warm = new_session(cell, prop, fuse, clips[0][0][:traffic.warm_frames], dev,
                       traffic.warm_cache_queries)
    play(warm, traffic.warm_rounds, clips[0], traffic.k, inter, keep=False)
    del warm
    stage("warm")
    if args.trace:
        warm_profiler()
        stage("profiler")
    run = Run(config=cfg, seconds=args.seconds, traffic=traffic)
    run.setup_s = time.perf_counter() - t0
    sys.stderr.write(f"set-up stages (s from start): {stages}\n")

    # ----- the window -----
    spans = tracer = schedule = None
    nh, nw = traffic.h + (-traffic.h) % 16, traffic.w + (-traffic.w) % 16
    if args.trace:
        from ivos_bench.counts import Schedule, Work
        from ivos_bench.spans import Spans

        spans = Spans().install()
        run.work = Work()
    if is_cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    checked = traffic.checked(args.seed)
    compared = None   # (plan, its rounds as check.Snap) of the checked session
    attempted = failed = 0
    copy_s = 0.0   # the clock stops for the checked session's copies
    start = time.perf_counter()
    deadline = start + args.seconds
    if spans is not None:
        tracer = Tracer(spans, traffic.trace_span, sync)
    cut = False
    try:
        for plan in traffic.sessions(args.seed):
            if time.perf_counter() >= deadline:
                break
            frames_u8, labels = clips[plan.clip]
            core = new_session(cell, prop, fuse, frames_u8, dev)
            snaps = [] if plan.index == checked else None
            if tracer is not None:
                if plan.index > checked:
                    tracer.arm(time.perf_counter())
                schedule = Schedule(traffic.t, traffic.k, (nh // 16) * (nw // 16),
                                    traffic.mem_freq, fuse is not None)
            for r, idx in enumerate(plan.rounds):
                now = time.perf_counter()
                if now >= deadline:
                    break
                if tracer is not None:
                    tracer.tick(now)
                    spans.counts.rounds += int(spans.active)
                    schedule.interact(idx, run.work if spans.active else None)
                mask, record = inter.round(frames_u8[idx], labels[idx], traffic.k,
                                           core.prob[idx])
                rec = Round()
                t_call = time.perf_counter()

                def chunk(tis, labs, rec=rec, t_call=t_call):
                    now = time.perf_counter()
                    if rec.first_ms is None:
                        rec.first_ms = (now - t_call) * 1e3
                    if now <= deadline:
                        run.frames += len(tis)
                    elif not traffic.finish_last_round:
                        raise Cut
                    if tracer is not None:
                        if spans.active:
                            schedule.count(run.work, tis)
                        tracer.tick(now)

                attempted += 1
                try:
                    with torch.profiler.record_function("round"):
                        core.interact(mask, idx, chunk_cb=chunk)
                    sync()
                except Cut:
                    sync()
                    cut = True
                    break
                except Exception as e:  # a failed round counts; the run goes on
                    sys.stderr.write(f"round at frame {idx} failed: {e!r}\n")
                    failed += 1
                    break
                t_end = time.perf_counter()
                rec.ms = (t_end - t_call) * 1e3
                rec.traced = tracer is not None and tracer.overlaps(t_call, t_end)
                run.rounds.append(rec)
                if snaps is not None:
                    t_copy = time.perf_counter()
                    snaps.append(snap(core, plan.rounds[:r], idx, record,
                                      mask if keep_masks else None))
                    copy_s += time.perf_counter() - t_copy
                    deadline = start + args.seconds + copy_s
            if snaps is not None and len(snaps) == len(plan.rounds):
                compared = (plan, snaps)
            del core
            if cut:
                break
    finally:   # the profiler and the program's tracing stop on every way out
        if tracer is not None:
            tracer.stop()
    sync()
    run.peak_bytes = torch.cuda.max_memory_allocated(dev) if is_cuda else 0
    sys.stderr.write(f"window {time.perf_counter() - start:.3f} s, of which the "
                     f"checked session's copies {copy_s:.3f} s\n")
    refuse_forbidden()
    if spans is not None:
        spans.uninstall()
        from ivos_bench.counts import phase_flops
        from ivos_bench.spans import ENTRY_POINTS

        run.trace, run.program = tracer.summary(tuple(ENTRY_POINTS) + ("round",))
        run.counts = spans.counts
        run.phase_flops = phase_flops(nh, nw, traffic.k)
    del prop, fuse, inter
    if is_cuda:
        torch.cuda.empty_cache()

    # ----- correctness -----
    from ivos_bench.check import gaps, judge

    numbers = gaps([(compared[0], {"program": compared[1]})] if compared else [],
                   sd, fsd, cell, clips,
                   cell.interaction.reference(cell, args.seed, dev), dev).get("program")
    del sd, fsd, compared, clips

    correct = numbers is not None and judge(numbers, cell.limits) and failed == 0
    limits = {name: {"value": (numbers or {}).get(name), "limit": limit}
              for name, limit in cell.limits.items()}

    # ----- metrics -----
    kind = "end_to_end" if not args.trace else "per_layer"
    metrics = {}
    for m in spec[kind]:
        if cell.name not in m.get("workloads", [cell.name]):
            continue
        value = _load_reader(root / "metrics" / f"{m['name']}.py")(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_block = {"platform": "gpu" if is_cuda else dev.type,
                    "kind": torch.cuda.get_device_name(dev) if is_cuda else dev.type,
                    "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_block}
    if run.trace is not None:
        device_block.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        out["breakdown"] = {"device_ops": [list(x) for x in run.trace.device_ops],
                            "idle_gaps": [list(x) for x in run.trace.idle_gaps]}
    out["compared"] = limits
    refuse_forbidden()   # the reference and the readers have loaded by now
    for name, c in limits.items():
        sys.stderr.write(f"compared {name} {c['value']} limit {c['limit']}\n")
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
