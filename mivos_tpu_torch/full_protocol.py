"""The full interactive protocol, fast path against exact path (counterpart
of scripts/full_protocol_tpu.py).

The in-repo robot, S2M, propagation and (optionally) fusion for
`--rounds` rounds over `--sequences` synthetic sequences
(`synthetic_sequence`, seeds 100, 101, ...) through
`run_local_interactive`, twice:

  fast   bf16 S2M, bf16 propagation with the kernel read (`auto`), bf16
         FusionNet
  exact  fp32 S2M and propagation with TF32 off and the `exact` read,
         fp32 FusionNet

from one fp32 weight set: `<weights>/prop_synthetic.pth` and
`<weights>/s2m_synthetic.pth` (`pretrain_synthetic`'s). --fusion: `auto`
(`<weights>/fusion_synthetic.pth` when it exists), `off`, or a FusionNet
.pth; with fusion, each round whose pass runs between two interacted
frames fuses.

Reports each path's summary (AUC, J&F at 60 s, the per-sequence (time,
J&F) records), per-round seconds, the AUC difference and the largest
per-round |dJ&F| between the paths; writes the report to --out before
the gates. Gates, as JAX's: max per-round |dJ&F| < 0.01, and every path
and sequence with a round inside the 240 s budget (with --warmup, all
rounds).

Usage: python -m mivos_tpu_torch.full_protocol [--frames 40] [--rounds 8]
    [--sequences 2] [--hw 480 854] [--objects 2] [--weights DIR]
    [--fusion auto|off|PATH] [--out report.json] [--warmup] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from mivos_tpu_torch.accuracy_envelope import tf32_off
from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork

JF_DELTA_MAX = 0.01      # scripts/full_protocol_tpu.py:175-191
BUDGET_S = 240.0         # reference eval_interactive_davis.py:74


def build_sequences(n_seq: int, t: int, h: int, w: int, k: int, seed0: int = 100):
    from mivos_tpu_torch.data.transforms import im_normalize
    from mivos_tpu_torch.generation.synthetic import synthetic_sequence

    seqs = {}
    for i in range(n_seq):
        images, labels = synthetic_sequence(seed0 + i, t, h, w, k)
        seqs[f"synth{i}"] = (im_normalize(images).astype(np.float32),
                             labels.astype(np.int32), k)
    return seqs


def run_config(tag, prop, s2m, fuse, seqs, rounds, mem, device,
               warmup_seqs=None, log=print):
    from mivos_tpu_torch.eval.davis_interactive import run_local_interactive

    def run(s):
        return run_local_interactive(prop, fuse, s2m, s, max_nb_interactions=rounds,
                                     max_time_per_interaction=int(BUDGET_S),
                                     mem=mem, device=device)

    if warmup_seqs:   # unscored: new shapes' first calls stay out of the rounds
        t0 = time.perf_counter()
        run(warmup_seqs)
        log(f"[{tag}] warmup: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    summary = run(seqs)
    wall = time.perf_counter() - t0
    log(f"[{tag}] total wall {wall:.1f} s  auc={summary['auc']:.4f}  "
        f"j&f@60s={summary['metric_at_60s']:.4f}")
    return {"summary": summary, "wall_s": wall}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--sequences", type=int, default=2)
    ap.add_argument("--hw", type=int, nargs=2, default=(480, 854))
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--weights", default="weights",
                    help="directory of prop_synthetic.pth and s2m_synthetic.pth")
    ap.add_argument("--fusion", default="auto",
                    help="'auto' (<weights>/fusion_synthetic.pth when present), "
                    "'off', or a FusionNet .pth")
    ap.add_argument("--out", default=None,
                    help="report path (default: full_protocol.json in the "
                    "temporary directory)")
    ap.add_argument("--warmup", action="store_true",
                    help="one unscored warm-up sequence per path first")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def protocol(args, log=print):
    """Both paths; the report with the largest per-round |dJ&F|, written
    to the report path (ungated)."""
    dev = torch.device(args.device)
    h, w = args.hw
    out = args.out or os.path.join(tempfile.gettempdir(), "full_protocol.json")
    prop_exact = load_reference_pth(PropagationNetwork(top_k=50, read_backend="exact"),
                                    os.path.join(args.weights, "prop_synthetic.pth"))
    s2m_exact = load_reference_pth(S2MNetwork(),
                                   os.path.join(args.weights, "s2m_synthetic.pth"))
    fuse_path = (os.path.join(args.weights, "fusion_synthetic.pth")
                 if args.fusion == "auto" else args.fusion)
    fuse_exact = None
    if args.fusion != "off" and os.path.exists(fuse_path):
        fuse_exact = load_reference_pth(FusionNet(), fuse_path)
        log(f"fusion: {fuse_path}")
    else:
        log("fusion: OFF")
    prop_fast = PropagationNetwork(top_k=50, dtype=torch.bfloat16)
    prop_fast.load_state_dict(prop_exact.state_dict())
    s2m_fast = S2MNetwork(dtype=torch.bfloat16)
    s2m_fast.load_state_dict(s2m_exact.state_dict())
    fuse_fast = None
    if fuse_exact is not None:
        fuse_fast = FusionNet(dtype=torch.bfloat16)
        fuse_fast.load_state_dict(fuse_exact.state_dict())

    seqs = build_sequences(args.sequences, args.frames, h, w, args.objects)
    warm = (build_sequences(1, args.frames, h, w, args.objects, seed0=999)
            if args.warmup else None)
    mem = MemoryConfig(top_k=50, mem_freq=5)
    report = {"frames": args.frames, "rounds": args.rounds,
              "sequences": args.sequences, "hw": [h, w], "objects": args.objects,
              "budget_s_per_seq": BUDGET_S, "warmup": bool(args.warmup),
              "fusion": fuse_path if fuse_exact is not None else "off"}
    report["fast"] = run_config("fast", prop_fast, s2m_fast, fuse_fast, seqs,
                                args.rounds, mem, dev, warm, log)
    with tf32_off():
        report["exact"] = run_config("exact", prop_exact, s2m_exact, fuse_exact,
                                     seqs, args.rounds, mem, dev, warm, log)
    report["auc_delta_fast_minus_exact"] = (report["fast"]["summary"]["auc"]
                                            - report["exact"]["summary"]["auc"])
    for tag in ("fast", "exact"):
        per_round = {}
        for name, traj in report[tag]["summary"]["records"].items():
            times = [t for t, _ in traj]
            per_round[name] = [b - a for a, b in zip([0.0] + times[:-1], times)]
        report[tag]["per_round_s"] = per_round
        report[tag]["summary"].pop("curve", None)   # keep the JSON small
    djf = jf_deltas(report["fast"]["summary"]["records"],
                    report["exact"]["summary"]["records"])
    report["per_round_jf_delta"] = djf
    report["max_round_jf_delta"] = max(djf)
    report["out"] = out
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    return report


def jf_deltas(fast_records, exact_records):
    """Round-indexed |dJ&F|: each round's J&F against the same round of
    the other path, sequence by sequence (the time-weighted AUC
    difference is reported, not gated)."""
    djf = []
    for name in fast_records:
        djf += [abs(a[1] - b[1]) for a, b in zip(fast_records[name], exact_records[name])]
    return djf


def check_gates(report) -> None:
    djf = report["max_round_jf_delta"]
    assert djf < JF_DELTA_MAX, report["per_round_jf_delta"]
    check_timing(report)


def check_timing(report) -> None:
    """The JAX timing gate alone: each path and sequence has a round
    inside the 240 s budget (with warmup, every round)."""
    for tag in ("fast", "exact"):
        for name, rounds_s in report[tag]["per_round_s"].items():
            worst = max(rounds_s) if report["warmup"] else min(rounds_s)
            assert worst < BUDGET_S, (tag, name, rounds_s)


def main(argv=None) -> None:
    args = parse_args(argv)
    report = protocol(args, log=lambda *a: print(*a, flush=True))
    print(json.dumps(report, indent=1), flush=True)
    print(f"max per-round |dJ&F| fast-vs-exact: "
          f"{report['max_round_jf_delta']:.4f}", flush=True)
    check_gates(report)
    print("FULL-PROTOCOL-OK", flush=True)


if __name__ == "__main__":
    main()
