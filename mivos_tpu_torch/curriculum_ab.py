"""Curriculum A/B: does chain-step pretraining reduce the decay of a
propagation pass over distance from the interaction (counterpart of
scripts/curriculum_ab.py)?

The accuracy envelope measures fast-vs-exact agreement and has no
ground-truth axis; this scores masks. For each held-out seed
(888000 + 13 s, disjoint from every pretraining seed) one synthetic
video in the pretraining distribution (`synthetic_sequence`, --hw,
--objects, --frames), one ground-truth interaction on frame 0 and a full
forward pass; the per-frame IoU against the generator's labels, averaged
over objects and seeds, for two propagation weight files in one process:
the chain-trained one (`--chain-weights`, `pretrain_synthetic --chain 1
3`'s) and the single-step snapshot (`--s1-weights`). The exposure-bias
signature is the slope: every frame past the first reads a bank of the
net's own predictions, so an overconfident net decays faster.

bf16 nets, top_k 50, mem_freq 5, no fusion. The frames are
ImageNet-normalized, as the pretrainers see them: the JAX script handed
the session the generator's [0, 1] frames, which a float video's session
takes as normalized already. Prints one JSON line: per-frame IoU, mean,
first and second half and last frame for each file, the second half's
gain of chain over s1, and `device`. On the card every pass's kernel
launches must equal its reads times the launches per read.

--smoke: 1 seed, 6 frames of 64x96, random inits (seeds 11 and 13).

Usage: python -m mivos_tpu_torch.curriculum_ab --chain-weights A.pth
    --s1-weights B.pth [--seeds 5] [--frames 24] [--hw 256 448]
    [--objects 2] [--out PATH] [--smoke] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from mivos_tpu_torch import bench
from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.data.transforms import im_normalize
from mivos_tpu_torch.generation.synthetic import synthetic_sequence
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.utils.measure import LaunchTally, device_info, reads_of, require_device
from mivos_tpu_torch.utils.tensor import labels_to_probs


def iou_per_frame(out: np.ndarray, gt: np.ndarray, k: int) -> np.ndarray:
    """(T,) IoU of each frame's labels against the ground truth, the mean
    over objects (1.0 where an object is in neither)."""
    ious = np.zeros((out.shape[0], k))
    for t in range(out.shape[0]):
        for i in range(1, k + 1):
            p, g = out[t] == i, gt[t] == i
            union = (p | g).sum()
            ious[t, i - 1] = (p & g).sum() / union if union else 1.0
    return ious.mean(1)


def load_net(path, seed, dev) -> PropagationNetwork:
    """A propagation net in the session's dtype: `path`'s weights, or a
    random init from `seed` (path None)."""
    net = PropagationNetwork(top_k=50, dtype=bench.compute_dtype(dev))
    if path is None:
        return init_params(net, torch.Generator().manual_seed(seed))
    return load_reference_pth(net, path)


def ab(nets: Dict[str, PropagationNetwork], seeds, t: int, hw, k: int, dev,
       log=print) -> Dict:
    """The per-seed IoU curves of each net and the report."""
    mem = MemoryConfig(top_k=50, mem_freq=5)
    tally = LaunchTally(dev)
    curves = {name: [] for name in nets}
    for seed in seeds:
        images, labels = synthetic_sequence(seed, t, *hw, k)
        frames = im_normalize(images).astype(np.float32)
        m0 = labels_to_probs(labels[0], k)
        for name, net in nets.items():
            core = InferenceCore(net, None, frames, k, mem=mem, device=dev)
            t0 = time.time()
            with tally.window(reads_of(core, 0), core.bank.dtype, net.read_refine):
                out = core.interact(m0, 0)
            curve = iou_per_frame(out, labels, k)
            curves[name].append(curve)
            log(f"seed {seed} {name:5s}: mean {curve.mean():.4f} last {curve[-1]:.4f} "
                f"({time.time() - t0:.1f}s)")
    report = {"frames": t, "hw": list(hw), "objects": k, "seeds": list(seeds)}
    for name in nets:
        arr = np.stack(curves[name])          # (seeds, T)
        mean_curve = arr.mean(0)
        report[name] = {"iou_per_frame": [float(x) for x in mean_curve],
                        "iou_mean": float(arr.mean()),
                        "iou_first_half": float(mean_curve[1:t // 2].mean()),
                        "iou_second_half": float(mean_curve[t // 2:].mean()),
                        "iou_last": float(mean_curve[-1])}
    report["gain_second_half"] = (report["chain"]["iou_second_half"]
                                  - report["s1"]["iou_second_half"])
    report["launches"] = tally.check("curriculum A/B passes")
    report["reads"] = tally.reads
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--hw", type=int, nargs=2, default=[256, 448])
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--chain-weights", default=os.path.join("weights", "torch",
                                                            "prop_synthetic.pth"))
    ap.add_argument("--s1-weights", default=os.path.join("weights", "torch",
                                                         "prop_synthetic_s1.pth"))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "curriculum_ab.json"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    if args.smoke:
        args.seeds, args.frames, args.hw = 1, 6, [64, 96]
    paths = {"chain": None if args.smoke else args.chain_weights,
             "s1": None if args.smoke else args.s1_weights}
    nets = {name: load_net(path, {"chain": 11, "s1": 13}[name], dev)
            for name, path in paths.items()}
    seeds = [888000 + 13 * s for s in range(args.seeds)]
    report = ab(nets, seeds, args.frames, tuple(args.hw), args.objects, dev,
                log=lambda *a: print(*a, flush=True))
    report["device"] = device_info(dev)
    shown = {k: v for k, v in report.items() if k not in ("seeds", "launches", "reads")}
    with open(args.out, "w") as f:
        json.dump(shown, f, indent=1)
    print(json.dumps(shown), flush=True)
    print("CURRICULUM-AB-OK", flush=True)
    return report


if __name__ == "__main__":
    main()
