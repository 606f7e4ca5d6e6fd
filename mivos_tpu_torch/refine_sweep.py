"""The read kernel's n_refine knob on encoder banks (counterpart of
scripts/refine_sweep.py): error against the exact read and CUDA-event
time at each setting, to place the default at the speed/tightness knee
(each refine pass shrinks the threshold bracket about 7x).

The banks are kernel_check's encoder banks over 13 synthetic 480p frames
(M = 21060, K = 3, N = 1620, the last 800 slots invalid), read as bf16;
the reference is the exact read of the fp32 banks, the scale its largest
magnitude. For n_refine = 0, 1, 2 and 3 one row: ms, mean and max
absolute error, and both as a percentage of the scale. Each row's reads
must launch the refine kernel and its merge n_refine times a read
(`launches_per_read`). The rows go to `--out` (the JAX script's
/tmp/refine_sweep.json) and one JSON line with the device.

Usage: python -m mivos_tpu_torch.refine_sweep [--weights prop.pth]
    [--out PATH] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Dict

import torch

from mivos_tpu_torch import kernel_check as kc
from mivos_tpu_torch.ops.memory_read import memory_read
from mivos_tpu_torch.utils.measure import LaunchTally, cuda_ms, device_info, require_device

N_REFINE = (0, 1, 2, 3)
TIMING_ITERS, TIMING_WARMUP = 50, 3


def sweep(mk, mv, q, valid, log=print) -> Dict:
    """The rows on fp32 banks `mk`, `mv` (read as bf16). Returns
    {"M", "scale", "rows", "launches", "reads"}: each row's launch counts
    held to its reads."""
    dev = q.device
    mkb, mvb = mk.to(torch.bfloat16), mv.to(torch.bfloat16)
    ref = memory_read(mk, mv, q, top_k=kc.TOP_K, valid=valid, backend="exact")
    scale = ref.abs().max().item()
    rows, launches, reads = [], [], 0
    for r in N_REFINE:
        tally = LaunchTally(dev)
        with tally.window(1, torch.bfloat16, r):
            out = memory_read(mkb, mvb, q, top_k=kc.TOP_K, valid=valid, n_refine=r)
        err = (out - ref).abs()
        ms = None
        if dev.type == "cuda":
            with tally.window(TIMING_ITERS + TIMING_WARMUP, torch.bfloat16, r):
                ms = cuda_ms(lambda: memory_read(mkb, mvb, q, top_k=kc.TOP_K,
                                                 valid=valid, n_refine=r),
                             TIMING_ITERS, TIMING_WARMUP)
        launches.append(tally.check(f"refine_sweep n_refine={r}"))
        reads += tally.reads
        rows.append({"n_refine": r, "ms": ms,
                     "mean_abs_err": err.mean().item(),
                     "max_abs_err": err.max().item(),
                     "mean_pct_of_scale": err.mean().item() / scale * 100,
                     "max_pct_of_scale": err.max().item() / scale * 100})
        log(json.dumps(rows[-1]))
    return {"M": int(mk.shape[1]), "scale": scale, "rows": rows,
            "launches": launches, "reads": reads}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=None,
                    help="propagation .pth (default: random init, seed 0)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "refine_sweep.json"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    device = device_info(dev)
    mk, mv, q = kc.encoder_banks(kc.prop_net(args.weights), kc.FULL_FRAMES, dev)
    m = mk.shape[1]
    valid = torch.arange(m, device=dev) < m - kc.TAIL
    rep = sweep(mk, mv, q, valid, log=lambda *a: print(*a, flush=True))
    out = {"M": rep["M"], "scale": rep["scale"], "rows": rep["rows"], "device": device}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print("REFINE-SWEEP-DONE", flush=True)
    return rep | {"device": device}


if __name__ == "__main__":
    main()
