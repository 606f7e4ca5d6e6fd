"""Headline benchmark: 480p multi-object mask propagation frames/s on one
card (counterpart of bench.py).

Protocol (the reference's interactive hot path, inference_core.py:122-200):
one interaction on frame 0 of a 60-frame 480x854 video with 3 objects,
then a full forward pass: each frame runs the query encoder, the top-k=50
memory read over the growing bank (mem_freq=5), the decoder, soft
aggregation and the memory encoder. bf16 PropagationNetwork(top_k=50) and
FusionNet, random init from seeds 0 and 1; the frames (RandomState(0))
and the 8 interaction masks are on the card before anything is timed.
One warm session, then 7 fresh sessions of `interact(mask, 0)`, each
timed on the host clock with the card synchronised; the value is the
median, with the spread.

Before anything is timed, the kernel gate (`kernel_check.gate_only`) runs
in this process; if it fails, no headline is printed and the exit code is
not 0. Baseline: MiVOS propagation runs about 10 frames/s at 480p on an
RTX 2080Ti (BASELINE.md); vs_baseline = fps / 10.

Prints one JSON line: bench.py's keys and `device`. On the card the
memory-read kernels' launches over the 7 sessions must equal their reads
times the launches per read.

Usage: python -m mivos_tpu_torch.bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import numpy as np
import torch

from mivos_tpu_torch import kernel_check
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.utils.measure import (LaunchTally, device_info, interaction_mask,
                                           median, reads_of, require_device, wall)

BASELINE_FPS = 10.0
T, RH, RW, K = 60, 480, 854, 3
SESSIONS = 7


def compute_dtype(dev) -> torch.dtype:
    """bf16 on the card (the production setting); fp32 for a CPU wiring
    run, whose bf16 convolutions would only be slow."""
    return torch.bfloat16 if torch.device(dev).type == "cuda" else torch.float32


def make_nets(dev, dtype=None, dec_width: float = 1.0, fusion: bool = True):
    dtype = dtype or compute_dtype(dev)
    prop = init_params(PropagationNetwork(top_k=50, dtype=dtype, dec_width=dec_width),
                       torch.Generator().manual_seed(0)).to(dev)
    fuse = (init_params(FusionNet(dtype=dtype), torch.Generator().manual_seed(1)).to(dev)
            if fusion else None)
    return prop, fuse


def video(dev, t: int = T, h: int = RH, w: int = RW) -> torch.Tensor:
    """(t, h, w, 3) frames from RandomState(0), on the device."""
    rng = np.random.RandomState(0)
    return torch.from_numpy(rng.rand(t, h, w, 3).astype(np.float32)).to(dev)


def sessions(prop, fuse, images, k: int, masks, warm_mask, dev, tally: LaunchTally):
    """One warm session on `warm_mask`, then a fresh session of
    interact(mask, 0) for each of `masks`; returns each session's
    frames/s. The measured sessions' reads and kernel launches go to
    `tally`."""
    mem = MemoryConfig(top_k=50, mem_freq=5)
    warm = InferenceCore(prop, fuse, images, k, mem=mem, device=dev)
    warm.interact(warm_mask, 0)
    del warm
    fps = []
    for mask in masks:
        core = InferenceCore(prop, fuse, images, k, mem=mem, device=dev)
        with tally.window(reads_of(core, 0), core.bank.dtype, prop.read_refine):
            _, dt = wall(lambda: core.interact(mask, 0), dev)
        fps.append((images.shape[0] - 1) / dt)
    return fps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    try:
        gate = kernel_check.gate_only(dev)
    except kernel_check.GateError as e:
        sys.stderr.write(f"KERNEL GATE FAILED\n{e}\n")
        sys.exit(1)
    gate_block = {"ok": True, "worst_mean_err_frac": round(gate["worst_mean_err_frac"], 6)}
    prop, fuse = make_nets(dev)
    images = video(dev, T, RH, RW)
    masks = [interaction_mask(s, RH, RW, K, dev) for s in range(8)]
    tally = LaunchTally(dev)
    fps = sorted(sessions(prop, fuse, images, K, masks[:SESSIONS], masks[7], dev, tally))
    launches = tally.check("bench sessions")
    med = median(fps)
    rep = {"metric": "propagation_fps_480p_3obj",
           "value": round(med, 2),
           "unit": "frames/s",
           "vs_baseline": round(med / BASELINE_FPS, 2),
           "spread": [round(fps[0], 2), round(fps[-1], 2)],
           "best": round(fps[-1], 2),
           "sessions": len(fps),
           "kernel_gate": gate_block,
           "device": device_info(dev)}
    print(json.dumps(rep), flush=True)
    return dict(rep, fps=fps, launches=launches, reads=tally.reads,
                gate_per_kernel_max_abs_err=gate["per_kernel_max_abs_err"])


if __name__ == "__main__":
    main()
