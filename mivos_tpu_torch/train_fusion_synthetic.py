"""Train FusionNet on synthetic propagation outputs and export it
(counterpart of scripts/train_fusion_synthetic.py), through the port's
own entry points, in process:

  1. synthetic 2-object videos in the DAVIS layout
     (generation/synthetic.py::write_dataset);
  2. `generate_fusion` with --model <prop_synthetic.pth> --dtype float32:
     propagated probability maps from the pretrained propagation net;
  3. `train` (stage 1) with --load_prop <prop_synthetic.pth>: the frozen
     attention reader shares the pretrained towers;
  4. the last checkpoint's FusionNet state_dict -> <out>
     (fusion_synthetic.pth, reference names, for load_reference_pth), and
     <root>/fusion_train_log.json with the reported losses.
The reported loss must descend. The bootstrapped CE averages the hardest
share p of the pixels, annealed from 1 to 0.15 between 20% and 50% of
the iterations, so only reports at the final p compare: the last of them
must be below the first (below the first report of all, as in the JAX
script, when only one report has the final p).

  python -m mivos_tpu_torch.train_fusion_synthetic \\
      --weights weights/torch/prop_synthetic.pth [--root weights/torch/fusion_syn] \\
      [--iterations 2000] [--batch 12] [--videos 24] [--device cuda|cpu]

The training set has one sample per video an epoch, so --videos must be
at least --batch. --device cuda (the default) fails without a CUDA
device.
"""
import argparse
import contextlib
import io
import json
import os
import re
import shutil
import sys
import time
from os import path

import torch

from mivos_tpu_torch import generate_fusion
from mivos_tpu_torch.checkpoint.manager import CheckpointManager, save_params
from mivos_tpu_torch.generation.synthetic import write_dataset
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.train.__main__ import main as train_main

RUN_ID = "fusion_syn"
_LOSS = re.compile(r"\[total_loss\s*\]:\s*([0-9.eE+-]+)")
_P = re.compile(r"\[p\s*\]:\s*([0-9.eE+-]+)")


class _Tee(io.TextIOBase):
    """stdout that also keeps every line written through it."""

    def __init__(self, stream):
        self.stream, self.lines, self._buf = stream, [], ""

    def write(self, text):
        self.stream.write(text)
        self._buf += text
        *done, self._buf = self._buf.split("\n")
        self.lines.extend(done)
        return len(text)

    def flush(self):
        self.stream.flush()


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=path.join("weights", "torch", "fusion_syn"))
    ap.add_argument("--iterations", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=12)
    ap.add_argument("--videos", type=int, default=24)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--hw", type=int, default=384, help="square frame size")
    ap.add_argument("--separation", type=int, default=4)
    ap.add_argument("--weights", default=path.join("weights", "torch",
                                                   "prop_synthetic.pth"))
    ap.add_argument("--out", default=path.join("weights", "torch",
                                               "fusion_synthetic.pth"))
    ap.add_argument("--skip-gen", action="store_true",
                    help="reuse an existing --root dataset and fusion maps")
    ap.add_argument("--num-workers", type=int, default=2)
    ap.add_argument("--report-every", type=int, default=50)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, cpu)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Runs the pipeline; returns {generate_s, train_s, losses, p, it}."""
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    if args.videos < args.batch:
        raise SystemExit(f"--videos {args.videos} is fewer than one batch "
                         f"of {args.batch}")
    fd_root = path.join(args.root, "fusion")
    gen_s = 0.0
    if args.skip_gen and path.isdir(fd_root):
        print("[fusion-syn] reusing dataset and fusion maps", flush=True)
    else:
        os.makedirs(args.root, exist_ok=True)
        write_dataset(args.root, n_videos=args.videos, t=args.frames, hw=args.hw)
        print(f"[data] wrote {args.videos} videos x {args.frames} frames at "
              f"{args.hw}^2", flush=True)
        t0 = time.time()
        generate_fusion.main([
            "--dataset", "DAVIS", "--davis_root", args.root,
            "--model", args.weights, "--output", path.join(fd_root, "davis"),
            "--separation", str(args.separation), "--dtype", "float32",
            "--device", args.device])
        gen_s = time.time() - t0
        print(f"[generate_fusion] {gen_s:.1f}s", flush=True)

    save_dir = path.join(args.root, "saves")
    shutil.rmtree(path.join(save_dir, RUN_ID), ignore_errors=True)
    im = path.join(args.root, "trainval", "JPEGImages", "480p")
    gt = path.join(args.root, "trainval", "Annotations", "480p")
    tee = _Tee(sys.stdout)
    t0 = time.time()
    with contextlib.redirect_stdout(tee):
        train_main([
            "--id", RUN_ID, "--stage", "1", "--im_root", im, "--gt_root", gt,
            "--fd_root", fd_root, "--batch_size", str(args.batch),
            "--iterations", str(args.iterations),
            "--save_every", str(args.iterations),
            "--report_every", str(args.report_every), "--lr", str(args.lr),
            "--save_dir", save_dir,
            "--load_prop", args.weights, "--num_workers", str(args.num_workers),
            "--device", args.device])
    train_s = time.time() - t0
    log = [ln for ln in tee.lines if _LOSS.search(ln) or _P.search(ln)]
    losses = [float(m.group(1)) for m in map(_LOSS.search, log) if m]
    shares = [float(m.group(1)) for m in map(_P.search, log) if m]
    if not losses or len(shares) != len(losses):
        raise RuntimeError(f"train reported {len(losses)} losses and "
                           f"{len(shares)} shares")
    final = [l for l, p in zip(losses, shares) if p == shares[-1]]
    first = final[0] if len(final) > 1 else losses[0]
    print(f"[train] {train_s:.1f}s, loss first={losses[0]:.4f} "
          f"first at p={shares[-1]:g}: {first:.4f} last={losses[-1]:.4f}",
          flush=True)
    if not losses[-1] < first:
        raise RuntimeError(f"the fusion loss did not descend: {losses} "
                           f"at p {shares}")

    state = CheckpointManager(path.join(save_dir, RUN_ID)).restore()
    if state["it"] != args.iterations:
        raise RuntimeError(f"last checkpoint at iteration {state['it']}")
    net = FusionNet()
    net.load_state_dict(state["network"], strict=True)
    save_params(args.out, net)
    print(f"[export] it={state['it']} -> {args.out}", flush=True)
    with open(path.join(args.root, "fusion_train_log.json"), "w") as f:
        json.dump({"iterations": args.iterations, "batch": args.batch,
                   "generate_s": gen_s, "wall_s": train_s, "losses": losses,
                   "p": shares, "log": log}, f, indent=1)
    print("FUSION-TRAIN-OK", flush=True)
    return {"generate_s": gen_s, "train_s": train_s, "losses": losses,
            "p": shares, "it": state["it"]}


if __name__ == "__main__":
    main()
