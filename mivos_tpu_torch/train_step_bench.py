"""FusionTrainer throughput on one card (counterpart of
scripts/train_step_bench.py).

The reference trains the fusion module on 384x384 crops at batch 12
(reference README.md:164-172, hyper_para.py:23). This runs the whole
train step (the frozen attention read, FusionNet's two heads, the
bootstrapped cross-entropy, Adam) in fp32 with TF32 off, on the JAX
script's batches (`make_batch`, one seed a step): FusionNet and the
attention read random-init (TrainConfig's seed). Two warm steps, then 6
steps on batches built on the host each step (the upload rides in the
step), then 6 steps on distinct batches placed on the card beforehand;
every step reads its loss back (a host synchronisation).

Prints one JSON line: the JAX script's keys and `device`.

Usage: python -m mivos_tpu_torch.train_step_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import numpy as np
import torch

from mivos_tpu_torch.config import TrainConfig
from mivos_tpu_torch.train.trainer import FusionTrainer
from mivos_tpu_torch.utils.measure import device_info, require_device, sync

B, H, W = 12, 384, 384
WARM, STEPS = 2, 6


def make_batch(seed: int, b: int = None, h: int = None, w: int = None) -> Dict[str, np.ndarray]:
    """The JAX script's batch (NHWC numpy) from RandomState(seed)."""
    b, h, w = b or B, h or H, w or W
    rng = np.random.RandomState(seed)
    m = lambda: rng.rand(b, h, w, 1).astype(np.float32)  # noqa: E731
    return {
        "rgb": rng.randn(b, h, w, 3).astype(np.float32),
        "cls_gt": rng.randint(0, 3, (b, h, w)).astype(np.int32),
        "gt": (m() > 0.5).astype(np.float32),
        "seg1": m(), "seg2": m(),
        "src2_ref": m(), "src2_ref_gt": (m() > 0.5).astype(np.float32),
        "gt2": (m() > 0.5).astype(np.float32),
        "seg12": m(), "seg22": m(),
        "src2_ref2": m(), "src2_ref_gt2": (m() > 0.5).astype(np.float32),
        "src2_ref_im": rng.randn(b, h, w, 3).astype(np.float32),
        "dist": rng.rand(b, 2).astype(np.float32),
        "selector": np.ones((b, 2), np.float32),
    }


def make_trainer(dev) -> FusionTrainer:
    return FusionTrainer(TrainConfig(iterations=1000, steps=(800,), batch_size=B),
                         device=dev)


def run(trainer: FusionTrainer, dev) -> Dict:
    warm_losses = []
    for s in range(WARM):
        warm_losses.append(float(trainer.train_step(make_batch(1 + s))["total_loss"]))
        print(f"warmup {s}: loss {warm_losses[-1]:.4f}", flush=True)
    sync(dev)
    t0 = time.perf_counter()
    for s in range(STEPS):
        loss = float(trainer.train_step(make_batch(100 + s))["total_loss"])
    hostfed = STEPS / (time.perf_counter() - t0)
    staged = [{k: torch.from_numpy(v).to(dev) for k, v in make_batch(200 + s).items()}
              for s in range(STEPS)]
    trainer.train_step(staged[0])
    sync(dev)
    t0 = time.perf_counter()
    for s in range(STEPS):
        loss = float(trainer.train_step(staged[s])["total_loss"])
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    return {"train_steps_per_s_device": STEPS / dt,
            "samples_per_s_device": STEPS * B / dt,
            "train_steps_per_s_hostfed": hostfed,
            "batch": B, "crop": [H, W], "last_loss": loss,
            "warm_losses": warm_losses}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rep = run(make_trainer(dev), dev)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    rep["device"] = device_info(dev)
    print(json.dumps({k: v for k, v in rep.items() if k != "warm_losses"}), flush=True)
    return rep


if __name__ == "__main__":
    main()
