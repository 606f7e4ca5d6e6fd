"""NoC through the whole f-BRS predictor stack on held-out synthetic
scenes (counterpart of scripts/noc_synthetic.py): Clicker -> ZoomIn ->
the cached head input -> L-BFGS f-BRS-B -> flip averaging -> NoC@80/85/90.

The click model is FBRSDeepLabModel("resnet50", ch=128), trained here by
FBRSPretrainer for --train-steps steps at --hw (step seeds 2000+i, lr
2e-4) and saved to --weights, or loaded from --weights (a .pth, e.g.
`python -m mivos_tpu_torch.pretrain_synthetic --net fbrs`'s) when it
exists. The evaluation set is --eval-n single-object synthetic scenes
from seeds 777000+i (radius 0.12-0.30 of the frame), disjoint from every
training seed; the predictor is the production stack (ZoomIn target
--hw, expansion 1.4, net_clicks_limit 8, L-BFGS maxiter 20), up to
--max-clicks clicks a scene, stopping at IoU 0.95. Deterministic clicker
and frozen weights: an exactly replayable IoU trajectory.

Writes the JAX script's report to --out (NoC at 0.80, 0.85 and 0.90, the
scenes that never reached each, the mean IoU of the first and the last
click, the evaluation's seconds, every trajectory) with `device`, prints
it without the trajectories, and asserts (not with --smoke) that the
IoU climbs with the clicks and ends at a mean of at least 0.80.

--smoke: 2 training steps, 2 scenes of 64x64, 3 clicks, maxiter 3.

Usage: python -m mivos_tpu_torch.noc_synthetic [--train-steps 600]
    [--eval-n 20] [--hw 192] [--weights PATH] [--out PATH] [--smoke]
    [--device cuda|cpu]
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

from mivos_tpu_torch.checkpoint.manager import save_params
from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.data.transforms import im_normalize
from mivos_tpu_torch.eval.noc import compute_noc_metric, evaluate_dataset
from mivos_tpu_torch.generation.synthetic import synthetic_sequence
from mivos_tpu_torch.interactive.fbrs_predictor import get_predictor
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.train.pretrain import FBRSPretrainer
from mivos_tpu_torch.utils.measure import device_info, require_device

THRESHOLDS = (0.80, 0.85, 0.90)


def make_net() -> torch.nn.Module:
    # ResNet-50: the bottleneck tower trains through frozen BN; the
    # basic-block ResNet-34 diverges (FBRSPretrainer's docstring).
    return FBRSDeepLabModel(arch="resnet50", ch=128)


def train(net, hw, steps: int, lr: float, dev, log=print) -> torch.nn.Module:
    """`steps` FBRSPretrainer steps on seeds 2000+i from a random init."""
    trainer = FBRSPretrainer(net=net, hw=hw, lr=lr, device=dev)
    t0 = time.time()
    first = last = None
    for i in range(steps):
        loss, iou = trainer.step(2000 + i)
        first = loss if first is None else first
        last = (loss, iou)
        if i % 25 == 0 or i == steps - 1:
            log(f"[fbrs] step {i:5d} loss {loss:.4f} iou {iou:.3f} ({time.time() - t0:.0f}s)")
    log(f"[fbrs] trained {steps} steps: loss {first:.4f} -> {last[0]:.4f}, iou {last[1]:.3f}")
    return trainer.net


class EvalSet:
    """Held-out single-object scenes: (normalized image, 0/1 mask)."""

    def __init__(self, n: int, hw):
        self.n, self.hw = n, tuple(hw)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int):
        imgs, labels = synthetic_sequence(777000 + i, 1, *self.hw, num_objects=1,
                                          min_radius=0.12, max_radius=0.30)
        return im_normalize(imgs[0]), (labels[0] == 1).astype(np.int32)


def evaluate(net, hw, eval_n: int, brs_mode: str, max_clicks: int, maxiter: int,
             dev) -> Dict:
    """The trajectories over EvalSet and the JAX script's report."""
    predictor = get_predictor(
        net, brs_mode, zoom_in_params={"target_size": max(hw), "expansion_ratio": 1.4},
        predictor_params={"net_clicks_limit": 8, "maxiter": maxiter}, device=dev)
    all_ious, wall = evaluate_dataset(EvalSet(eval_n, hw), predictor, max_iou_thr=0.95,
                                      max_clicks=max_clicks)
    noc, over = compute_noc_metric(all_ious, THRESHOLDS, max_clicks=max_clicks)
    return {"samples": eval_n, "hw": list(hw), "brs_mode": brs_mode,
            "max_clicks": max_clicks,
            "noc": {f"@{t:.2f}": v for t, v in zip(THRESHOLDS, noc)},
            "over_max": {f"@{t:.2f}": o for t, o in zip(THRESHOLDS, over)},
            "iou_click1_mean": float(np.mean([a[0] for a in all_ious])),
            "iou_final_mean": float(np.mean([a[-1] for a in all_ious])),
            "eval_wall_s": wall,
            "trajectories": [[float(x) for x in a] for a in all_ious]}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-steps", type=int, default=600)
    ap.add_argument("--eval-n", type=int, default=20)
    ap.add_argument("--hw", type=int, default=192)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--weights", default=os.path.join("weights", "torch",
                                                      "fbrs_synthetic.pth"))
    ap.add_argument("--brs-mode", default="f-BRS-B")
    ap.add_argument("--max-clicks", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "noc_synthetic.json"))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    if args.smoke:
        args.train_steps, args.eval_n, args.hw, args.max_clicks = 2, 2, 64, 3
    hw = (args.hw, args.hw)
    net = make_net()
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    if os.path.exists(args.weights):
        log(f"[fbrs] loading {args.weights}")
        net = load_reference_pth(net, args.weights)
    else:
        net = train(net, hw, args.train_steps, args.lr, dev, log)
        save_params(args.weights, net)
        log(f"[fbrs] saved {args.weights}")
    report = evaluate(net, hw, args.eval_n, args.brs_mode, args.max_clicks,
                      args.max_clicks if args.smoke else 20, dev)
    report["device"] = device_info(dev)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "trajectories"}), flush=True)
    if not args.smoke:
        # The trained model must climb with the clicks.
        if not report["iou_final_mean"] > report["iou_click1_mean"] - 1e-6:
            raise RuntimeError(f"IoU fell with the clicks: {report['iou_click1_mean']} "
                               f"-> {report['iou_final_mean']}")
        if not report["iou_final_mean"] >= 0.80:
            raise RuntimeError(f"final mean IoU {report['iou_final_mean']} < 0.80")
    print("NOC-SYNTHETIC-OK", flush=True)
    return report


if __name__ == "__main__":
    main()
