"""Readings that a cell's correctness limits are set from.

    python3 -m ivos_bench.calibrate --workload <cell> --seeds 1,2,3 [--control]
        [--fault NAME ...] [--out PATH]

For each seed, one process makes the weights and clips a run of that
seed makes, plays the session a run of that seed checks through the
program (the same `InferenceCore.interact` path as the window, each
round's mask from the cell's interaction), and compares it with the
plain reference (`check.gaps`): the lower readings. With `--control`,
the control is compared too: the reference in the precision one step
below the configuration's (`reference/precision.py`, `CONTROL`), on the
same inputs, each round's mask the interaction's reference side replays
from the program's record, in the same arithmetic (its `nets`, where it
has them, rounded as the propagation's): the upper readings. Each `--fault` (a
name of `faults.FAULTS`) plays the session once more through the program
with that fault planted, compared as `fault:<name>`. Prints one JSON
line a seed, and writes them all to --out when given. Runs on the card.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


class Replayed:
    """The control's interaction: round by round, the reference side's
    replay of the program's records."""

    def __init__(self, reference, records):
        self.reference, self.records = reference, iter(records)

    def round(self, frame_u8, labels, k, prob):
        record = next(self.records)
        return self.reference.replay(frame_u8, labels, k, record), record


def main(argv=None, device=None, bench_file=None, root: Path = HERE):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = json.loads(Path(bench_file or root.parent / "BENCHMARK.json").read_text())

    import torch

    from ivos_bench.cell import build_program, load_cell, new_session, play
    from ivos_bench.check import gaps, judge
    from ivos_bench.clips import make_clip
    from ivos_bench.faults import plant
    from ivos_bench.reference.nets import build
    from ivos_bench.reference.precision import CONTROL, arithmetic
    from ivos_bench.reference.session import Session
    from ivos_bench.weights import make_weights

    cell = load_cell(spec, args.workload, root)
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("calibration runs on the card")
        device = "cuda"
    dev = torch.device(device)
    cell.set_tf32()
    t = cell.traffic
    keep_masks = bool(cell.interaction_numbers)
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        plans = [p for p, _ in zip(t.sessions(seed), range(t.check_among))
                 if p.index == t.checked(seed)]
        sd, fsd = make_weights(seed, cell.dtype, dev, fusion=cell.config["fusion"])
        clips = {p.clip: make_clip(seed, p.clip, t.t, t.h, t.w, t.k, dev) for p in plans}
        prop, fuse = build_program(cell, sd, fsd, dev)
        inter = cell.interaction.setup(cell, seed, dev)
        sessions, t0 = [(p, {}) for p in plans], time.perf_counter()
        for run_name in ["program"] + [f"fault:{f}" for f in args.fault]:
            with plant(run_name[6:]) if run_name != "program" else contextlib.nullcontext():
                for p, runs in sessions:
                    core = new_session(cell, prop, fuse, clips[p.clip][0], dev)
                    runs[run_name] = play(core, p.rounds, clips[p.clip], t.k, inter,
                                          keep_masks=keep_masks)
                    del core
        torch.cuda.synchronize(dev) if dev.type == "cuda" else None
        program_s = time.perf_counter() - t0
        del prop, fuse, inter
        control_s = None
        if args.control:
            name = CONTROL[cell.config["dtype"]]
            c_prop, c_fuse = build(sd, dev, cell.config["top_k"], fsd)
            c_inter = cell.interaction.reference(cell, seed, dev)
            context, quant = arithmetic(
                name, (c_prop, c_fuse, *getattr(c_inter, "nets", ())))
            t0 = time.perf_counter()
            with context, torch.no_grad():
                for p, runs in sessions:
                    ses = Session(c_prop, c_fuse, clips[p.clip][0], t.k, t.mem_freq,
                                  len(p.rounds) > 1, quant)
                    replayed = Replayed(c_inter, [s.record for s in runs["program"]])
                    runs["control"] = play(ses, p.rounds, clips[p.clip], t.k, replayed,
                                           keep_masks=keep_masks)
            control_s = time.perf_counter() - t0
            del c_prop, c_fuse, c_inter
        t0 = time.perf_counter()
        numbers = gaps(sessions, sd, fsd, cell, clips,
                       cell.interaction.reference(cell, seed, dev), dev)
        line = {"workload": cell.name, "seed": seed, "readings": numbers,
                "program_correct": judge(numbers["program"], cell.limits),
                "seconds": {"program": program_s, "control": control_s,
                            "reference": time.perf_counter() - t0}}
        for name in numbers:
            if name != "program":
                line[f"{name}_correct"] = judge(numbers[name], cell.limits)
        print(json.dumps(line), flush=True)
        lines.append(line)
        del sd, fsd, clips, sessions
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines) + "\n")
    return lines


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
