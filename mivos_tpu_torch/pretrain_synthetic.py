"""Pretrain the propagation, S2M or f-BRS net on synthetic moving-blob
video (counterpart of scripts/pretrain_synthetic.py): trained-like
weights without external data.

  python -m mivos_tpu_torch.pretrain_synthetic --net prop --steps 500 \\
      --hw 192 --lr 2e-4 --chain 1 --seed 1000 [--out weights/torch] \\
      [--resume] [--device cuda|cuda:N|cpu]

Artifacts: <out>/<net>_synthetic.pth, a state_dict under the reference's
names (`checkpoint/pth.py::load_reference_pth` loads the prop and S2M
files strictly into PropagationNetwork and S2MNetwork, and
`models.build_fbrs_from_state_dict` builds the click model from the fbrs
file), and <out>/pretrain_log.json, the loss and IoU curves per net with
each run's schedule appended. --resume continues from
<out>/<net>_synthetic.pth with a fresh Adam. `--net both` is prop then
s2m. Batches are built by 4 worker processes ahead of the training
loop (the JAX script builds each in the loop; a batch depends on its
seed alone, so the steps are the same). --device cuda (the default)
fails without a CUDA device.
"""
import argparse
import json
import os
import time
from typing import Dict, List, Sequence

import torch

from mivos_tpu_torch.checkpoint.manager import save_params
from mivos_tpu_torch.checkpoint.pth import read_state_dict
from mivos_tpu_torch.train.pretrain import (FBRSPretrainer, PropPretrainer,
                                            S2MPretrainer, batches)

TRAINERS = {"prop": PropPretrainer, "s2m": S2MPretrainer,
            "fbrs": FBRSPretrainer}


def checkpoint_path(out: str, kind: str) -> str:
    return os.path.join(out, f"{kind}_synthetic.pth")


def run(kind: str, steps: int, hw: Sequence[int], lr: float, k: int,
        out: str, log_every: int, seed0: int, resume: bool = False,
        chain: Sequence[int] = (1,), device="cuda") -> Dict[str, List]:
    """Train one net for `steps` steps on seeds seed0, seed0 + 1, ...
    (batches built ahead of the loop, train/pretrain.py::batches), save
    it to <out>/<kind>_synthetic.pth and return its curves ({loss, iou,
    step}, every `log_every` steps and the last)."""
    ckpt = checkpoint_path(out, kind)
    init = None
    if resume and os.path.exists(ckpt):
        init = read_state_dict(ckpt)
        print(f"[{kind}] resuming from {ckpt}", flush=True)
    kw = {}
    if kind == "prop":
        kw = ({"chain_steps": chain[0]} if len(chain) == 1
              else {"chain_mix": tuple(chain)})
    trainer = TRAINERS[kind](params=init, lr=lr, hw=tuple(hw), num_objects=k,
                             device=device, **kw)
    hist = {"loss": [], "iou": [], "step": []}
    t0 = time.time()
    for i, (seed, batch) in enumerate(batches(trainer, range(seed0, seed0 + steps))):
        loss, iou = trainer.step(seed, batch)
        if i % log_every == 0 or i == steps - 1:
            hist["loss"].append(loss)
            hist["iou"].append(iou)
            hist["step"].append(i)
            print(f"[{kind}] step {i:5d} loss {loss:.4f} iou {iou:.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
    save_params(ckpt, trainer.net)
    print(f"[{kind}] saved {ckpt}", flush=True)
    return hist


def merge_log(old: Dict, kind: str, hist: Dict[str, List], meta: Dict,
              resume: bool) -> None:
    """Merge one run's curves into the log in place. A resumed run
    appends its curves, its steps continuing from the last logged one,
    and its schedule; any other run replaces the net's entry. Other
    nets' entries are kept."""
    prev = old.get(kind) if resume else None
    if prev is None:
        old[kind] = dict(hist, schedule=[meta])
        return
    logged = prev.get("step", [])
    base = logged[-1] + 1 if logged else 0   # an empty prior run logged nothing
    merged = {"loss": prev.get("loss", []) + hist["loss"],
              "iou": prev.get("iou", []) + hist["iou"],
              "step": logged + [s + base for s in hist["step"]]}
    merged["schedule"] = prev.get("schedule", []) + [meta]
    old[kind] = merged


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--net", choices=("prop", "s2m", "fbrs", "both"),
                    default="both")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--hw", type=int, nargs="+", default=[192],
                    help="square size, or H W")
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--objects", type=int, default=2)
    ap.add_argument("--out", default=os.path.join("weights", "torch"))
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=1000)
    ap.add_argument("--resume", action="store_true",
                    help="continue from <out>/<net>_synthetic.pth")
    ap.add_argument("--chain", type=int, nargs="+", default=[1],
                    help="prop only: chained propagation steps per sample "
                    "(memorize own predictions; >= 2 trains against "
                    "exposure bias); several values (e.g. --chain 1 3) "
                    "interleave lengths round-robin")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, cuda:N, cpu)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    os.makedirs(args.out, exist_ok=True)
    hw = args.hw * 2 if len(args.hw) == 1 else args.hw
    kinds = ("prop", "s2m") if args.net == "both" else (args.net,)
    logs = {kind: run(kind, args.steps, hw, args.lr, args.objects, args.out,
                      args.log_every, args.seed, resume=args.resume,
                      chain=args.chain, device=args.device)
            for kind in kinds}
    # Merged per net, so training one net never clobbers another's curves.
    log_path = os.path.join(args.out, "pretrain_log.json")
    old = {}
    if os.path.exists(log_path):
        with open(log_path) as f:
            old = json.load(f)
    for kind, hist in logs.items():
        meta = {"steps": args.steps, "hw": hw, "lr": args.lr,
                "seed": args.seed, "resume": args.resume}
        if kind == "prop":
            meta["chain"] = args.chain
        merge_log(old, kind, hist, meta, args.resume)
    with open(log_path, "w") as f:
        json.dump(old, f, indent=1)
    print("PRETRAIN-OK", flush=True)


if __name__ == "__main__":
    main()
