"""Root-cause the accuracy envelope's decided-pixel flips (counterpart
of scripts/envelope_diagnose.py, numpy only): locate every margin>0.01
pixel whose label differs between the fast and exact sessions in an `accuracy_envelope` dump, characterize
them (frame, position, exact margin, probability error, which class
pair flipped), and — given additional dumps from attribution re-runs
(`--fast-fusion-fp32` / `--fast-towers-fp32` / `--fast-read-refine N`)
— report which fast-path approximation, when removed, recovers them.

Host-side analysis of envelope_arrays<tag>.npz; it never touches the
card, so it can re-slice a chip run for free.

Usage:
  python -m mivos_tpu_torch.envelope_diagnose envelope_arrays.npz \
      [--ablation fusion_fp32=envelope_arrays_ff32.npz ...] \
      [--margin 0.01] [--out envelope_diagnosis.json]
"""
import argparse
import json
import os
import tempfile

import numpy as np


def load(path):
    d = np.load(path)
    return (np.asarray(d["out_f"]), np.asarray(d["out_e"]),
            np.asarray(d["prob_f"]), np.asarray(d["prob_e"]))


def flips(out_f, out_e, prob_e, margin):
    """Indices (t, y, x) of decided-cohort disagreements."""
    srt = np.sort(prob_e[..., 0], axis=1)
    m = srt[:, -1] - srt[:, -2]
    return np.argwhere((out_f != out_e) & (m > margin)), m


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", help="baseline envelope arrays npz")
    ap.add_argument("--ablation", action="append", default=[],
                    help="name=path of an attribution re-run dump")
    ap.add_argument("--margin", type=float, default=0.01)
    ap.add_argument("--out", default=None,
                    help="report path (default: envelope_diagnosis.json in "
                    "the temporary directory)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(tempfile.gettempdir(),
                                   "envelope_diagnosis.json")

    out_f, out_e, prob_f, prob_e = load(args.dump)
    idx, m = flips(out_f, out_e, prob_e, args.margin)
    T = out_f.shape[0]
    total_decided = int((m > args.margin).sum())

    per_flip = []
    for t, y, x in idx:
        pe, pf = prob_e[t, :, y, x, 0], prob_f[t, :, y, x, 0]
        per_flip.append({
            "frame": int(t), "y": int(y), "x": int(x),
            "exact_label": int(out_e[t, y, x]),
            "fast_label": int(out_f[t, y, x]),
            "exact_margin": round(float(m[t, y, x]), 5),
            "prob_err_max_here": round(float(np.abs(pe - pf).max()), 5),
            "exact_top2": [round(float(v), 4)
                           for v in np.sort(pe)[-2:][::-1]],
            "fast_top2": [round(float(v), 4)
                          for v in np.sort(pf)[-2:][::-1]],
        })

    report = {
        "dump": args.dump,
        "margin": args.margin,
        "decided_pixels": total_decided,
        "flips": len(per_flip),
        "flip_rate": len(per_flip) / max(total_decided, 1),
        "frames_with_flips": sorted({f["frame"] for f in per_flip}),
        "flip_margin_max": max((f["exact_margin"] for f in per_flip),
                               default=0.0),
        "per_frame_flip_counts": {
            str(t): int(sum(f["frame"] == t for f in per_flip))
            for t in range(T)
            if any(f["frame"] == t for f in per_flip)},
        "per_flip": per_flip[:200],
    }

    # Attribution: does removing ONE approximation in the fast path
    # recover the baseline's flipped pixels?
    for spec in args.ablation:
        name, path = spec.split("=", 1)
        a_out_f, a_out_e, _a_pf, a_pe = load(path)
        a_idx, _ = flips(a_out_f, a_out_e, a_pe, args.margin)
        recovered = sum(
            1 for t, y, x in idx if a_out_f[t, y, x] == a_out_e[t, y, x])
        report[f"ablation_{name}"] = {
            "own_flips": int(len(a_idx)),
            "baseline_flips_recovered": int(recovered),
            "baseline_flips_total": len(per_flip),
        }

    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items()
                      if k != "per_flip"}, indent=1))
    print("ENVELOPE-DIAGNOSE-OK")
    return report


if __name__ == "__main__":
    main()
