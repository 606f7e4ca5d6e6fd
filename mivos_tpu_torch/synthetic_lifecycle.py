"""The fusion-training lifecycle on synthetic data, with a real kill and
resume (counterpart of scripts/synthetic_lifecycle.py): synthetic videos
-> generate_fusion -> FusionDataset -> train, SIGKILLed after its
midpoint report and resumed from its latest checkpoint.

Phases:
  1. 12 synthetic 2-object videos of 10 frames at 384x384 in the DAVIS
     layout under --root (`generation/synthetic.py::write_dataset`).
  2. `mivos_tpu_torch.generate_fusion`'s main in this process
     (--separation 8, fp32, the propagation .pth of --weights), so that
     its memory reads' kernel launches are counted here: on the card they
     must equal the reads (a pass over the other 9 frames from each
     reference frame with a usable object) times the fp32 launches per
     read.
  3. `python -m mivos_tpu_torch.train` in a subprocess (its own process
     group) for --iterations at --batch, a checkpoint every --save-every,
     a report every --report-every, 2 loader processes; SIGKILL to the
     group once it reports the iteration half-way.
  4. The same command with `--load_model <save_dir>/lifecycle` must say
     "resumed at iteration" and exit 0.

The loss lines of both runs and the resume line go to --out (Markdown;
the JAX script wrote docs/). As in the JAX script, the last reported
total loss must be below the first (the first at p = 1, the last at the
bootstrapped CE's final share p = 0.15 of the hardest pixels). Prints one
JSON line with `device`.

Usage: python -m mivos_tpu_torch.synthetic_lifecycle --weights prop.pth
    [--root DIR] [--iterations 400] [--batch 8] [--save-every 100]
    [--report-every 25] [--out PATH] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from mivos_tpu_torch import generate_fusion
from mivos_tpu_torch.train_fusion_synthetic import _LOSS, _P
from mivos_tpu_torch.data.video_datasets import DAVISTestDataset
from mivos_tpu_torch.generation.synthetic import write_dataset
from mivos_tpu_torch.utils.measure import LaunchTally, device_info, require_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIDEOS, FRAMES, HW, SEPARATION = 12, 10, 384, 8
ITERATION = re.compile(r"It\s+(\d+)")


def generation_reads(root: str) -> int:
    """The reads generate_fusion makes on the DAVIS tree under root: a
    pass over every other frame from each reference frame (every
    SEPARATION-th) that has a usable object."""
    dataset = DAVISTestDataset(os.path.join(root, "trainval"), imset="2017/train.txt")
    reads = 0
    for i in range(len(dataset)):
        gt = dataset[i]["gt"]
        t = gt.shape[1]
        for f in range(0, t, SEPARATION):
            if any((gt[k, f] > 0.5).sum() > generate_fusion.MIN_PIXELS
                   for k in range(gt.shape[0])):
                reads += t - 1
    return reads


def reported(lines: List[str]) -> Tuple[List[float], List[float]]:
    """(total losses, shares p) of the reports that printed both, in
    order (the kill may cut a report short)."""
    reports: Dict[Tuple[int, int], Dict[str, float]] = {}
    run = 0
    for line in lines:
        run += line.startswith("--- SIGKILL")
        it = ITERATION.search(line)
        for key, pattern in (("loss", _LOSS), ("p", _P)):
            m = pattern.search(line)
            if it and m:
                reports.setdefault((run, int(it.group(1))), {})[key] = float(m.group(1))
    both = [r for r in reports.values() if len(r) == 2]
    return [r["loss"] for r in both], [r["p"] for r in both]


def run_train(argv: List[str], kill_at: Optional[int], log_lines: List[str],
              log=print) -> Tuple[int, bool, bool]:
    """`python -m mivos_tpu_torch.train argv` in its own process group;
    SIGKILL to the group once it reports iteration kill_at. Returns
    (exit code, said "resumed at iteration", killed)."""
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "mivos_tpu_torch.train", *argv],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, start_new_session=True)
    resumed = killed = False
    try:
        for line in proc.stdout:
            line = line.rstrip()
            log("  |", line)
            if _LOSS.search(line) or _P.search(line) or "resumed" in line:
                log_lines.append(line)
            resumed |= "resumed at iteration" in line
            m = ITERATION.search(line)
            if kill_at is not None and m and int(m.group(1)) >= kill_at and not killed:
                log(f"[lifecycle] SIGKILL at iteration {m.group(1)}")
                os.killpg(proc.pid, signal.SIGKILL)
                killed = True
    finally:
        if proc.poll() is None and not killed:
            os.killpg(proc.pid, signal.SIGKILL)
        proc.wait(timeout=120)
    return proc.returncode, resumed, killed


def lifecycle(root: str, weights: str, iterations: int, batch: int, save_every: int,
              report_every: int, dev, log=print) -> Dict:
    write_dataset(root, VIDEOS, FRAMES, HW)
    log(f"[data] wrote {VIDEOS} videos x {FRAMES} frames at {HW}^2")
    fd_root = os.path.join(root, "fusion")
    reads = generation_reads(root)
    tally = LaunchTally(dev)
    t0 = time.perf_counter()
    with tally.window(reads, torch.float32):
        generate_fusion.main(["--dataset", "DAVIS", "--davis_root", root,
                              "--model", weights, "--output", os.path.join(fd_root, "davis"),
                              "--separation", str(SEPARATION), "--dtype", "float32",
                              "--device", str(dev)])
    generate_s = time.perf_counter() - t0
    launches = tally.check("generate_fusion reads")
    save_dir = os.path.join(root, "saves")
    train_argv = [
        "--id", "lifecycle", "--stage", "1",
        "--im_root", os.path.join(root, "trainval", "JPEGImages", "480p"),
        "--gt_root", os.path.join(root, "trainval", "Annotations", "480p"),
        "--fd_root", fd_root, "--batch_size", str(batch),
        "--iterations", str(iterations), "--save_every", str(save_every),
        "--report_every", str(report_every), "--save_dir", save_dir,
        "--num_workers", "2", "--load_prop", weights, "--device", str(dev)]
    lines: List[str] = []
    kill_at = iterations // 2
    t0 = time.perf_counter()
    rc_killed, _, killed = run_train(train_argv, kill_at, lines, log)
    if not killed:
        raise RuntimeError(f"train never reported iteration {kill_at} (exit {rc_killed})")
    lines.append(f"--- SIGKILL at about iteration {kill_at}; train exited {rc_killed} ---")
    rc, resumed, _ = run_train(
        train_argv + ["--load_model", os.path.join(save_dir, "lifecycle")], None, lines, log)
    train_s = time.perf_counter() - t0
    if rc != 0 or not resumed:
        raise RuntimeError(f"the resumed run exited {rc}, resumed={resumed}")
    losses, shares = reported(lines)
    if not losses or not losses[-1] < losses[0]:
        raise RuntimeError(f"the total loss did not descend: {losses} at p {shares}")
    return {"videos": VIDEOS, "frames": FRAMES, "hw": HW, "iterations": iterations,
            "batch": batch, "save_every": save_every, "kill_at": kill_at,
            "killed_exit": rc_killed, "resumed": resumed, "losses": losses, "p": shares,
            "generate_s": generate_s, "train_s": train_s, "reads": reads,
            "launches": launches, "log": lines}


def write_report(path: str, rep: Dict) -> None:
    with open(path, "w") as f:
        f.write(
            "# Synthetic fusion-training run (lifecycle)\n\n"
            "`python -m mivos_tpu_torch.synthetic_lifecycle`: synthetic "
            f"{rep['hw']}^2 videos -> generate_fusion -> FusionDataset -> train, "
            "SIGKILLed mid-run and resumed from its latest checkpoint.\n\n"
            f"- device: {rep['device']}\n"
            f"- iterations {rep['iterations']}, batch {rep['batch']}, save_every "
            f"{rep['save_every']}\n"
            f"- SIGKILL at about iteration {rep['kill_at']}; resumed; completed.\n"
            f"- total_loss: first {rep['losses'][0]:.4f}, min {min(rep['losses']):.4f}, "
            f"last {rep['losses'][-1]:.4f}\n\n"
            "## Console log (loss lines and the resume)\n\n```\n"
            + "\n".join(rep["log"]) + "\n```\n")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=None, help="default: a temporary directory")
    ap.add_argument("--iterations", type=int, default=400)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--save-every", type=int, default=100)
    ap.add_argument("--report-every", type=int, default=25)
    ap.add_argument("--weights", default=os.path.join("weights", "torch",
                                                      "prop_synthetic.pth"))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "synthetic_training_run.md"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    log = lambda *a: print(*a, flush=True)  # noqa: E731
    weights = os.path.abspath(args.weights)
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.abspath(args.root or tmp)
        os.makedirs(root, exist_ok=True)
        rep = lifecycle(root, weights, args.iterations, args.batch, args.save_every,
                        args.report_every, dev, log)
    rep["device"] = device_info(dev)
    write_report(args.out, rep)
    log(f"[lifecycle] wrote {args.out}")
    print(json.dumps({k: v for k, v in rep.items() if k not in ("log", "launches")}),
          flush=True)
    print("LIFECYCLE-OK", flush=True)
    return rep


if __name__ == "__main__":
    main()
