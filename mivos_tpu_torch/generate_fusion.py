"""Propagated probability maps for fusion training (counterpart of the
repository's generate_fusion.py; reference generate_fusion.py).

  python -m mivos_tpu_torch.generate_fusion --dataset DAVIS \
      --davis_root ../DAVIS/2017 --output ../fusion_data/davis \
      --separation 5 [--model saves/propagation_model.pth | --model_npz w.npz] \
      [--device cuda|cuda:N|cpu]

For every `--separation`-th frame of every video, the ground truth of
each object with more than 100 pixels there (at most 5) propagates over
the whole video (DAVIS, `trainval` with ImageSets/2017/train.txt) or
`--range` frames each way (BL30K), and writes
<output>/<video>/<frame>/<object>/<frame>.png (probability * 255).

Resume contract: a video renders into <video>.__tmp__ and is renamed
into place when complete, so a video directory exists only when the
video is finished; stale staging directories are removed at start; a
video with no usable object completes as an empty directory; a re-run
without --skip_done overwrites. --device cuda (the default) fails
without a CUDA device.
"""
import argparse
import os
import shutil
from os import path

import numpy as np
import torch

from mivos_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from mivos_tpu_torch.checkpoint.npz import load_params_npz
from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.core.fusion_generator import FusionGenerator
from mivos_tpu_torch.data.video_datasets import BLTestDataset, DAVISTestDataset
from mivos_tpu_torch.models.propagation import PropagationNetwork

MIN_PIXELS, MAX_OBJECTS = 10 * 10, 5   # reference generate_fusion.py:78-86


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", default="saves/propagation_model.pth")
    p.add_argument("--model_npz", default=None,
                   help="flax .npz weights of the JAX package "
                        "(checkpoint/npz.py) instead of a .pth")
    p.add_argument("--dataset", choices=["DAVIS", "BL"], required=True)
    p.add_argument("--davis_root", default="../DAVIS/2017")
    p.add_argument("--bl_root", default="../BL30K")
    p.add_argument("--output", required=True)
    p.add_argument("--separation", type=int, default=5)
    p.add_argument("--range", type=int, default=10,
                   help="propagation range for BL (reference :30)")
    p.add_argument("--mem_freq", type=int, default=5)
    p.add_argument("--start", type=int, default=None)
    p.add_argument("--end", type=int, default=None)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="conv-tower and memory-bank compute dtype")
    p.add_argument("--skip_done", action="store_true",
                   help="skip videos whose output directory exists (a "
                        "finished video: see the resume contract)")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, cpu)")
    return p.parse_args(argv)


def _save_png(p: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(arr).save(p)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    if args.dataset == "DAVIS":
        dataset = DAVISTestDataset(path.join(args.davis_root, "trainval"),
                                   imset="2017/train.txt")
    else:
        dataset = BLTestDataset(args.bl_root, start=args.start, end=args.end)
    prop_net = PropagationNetwork(dtype=getattr(torch, args.dtype))
    if args.model_npz:
        prop_net.load_state_dict(
            state_dict_from_flax(load_params_npz(args.model_npz)), strict=True)
    else:
        load_reference_pth(prop_net, args.model)

    os.makedirs(args.output, exist_ok=True)
    for d in os.listdir(args.output):
        if d.endswith(".__tmp__"):
            shutil.rmtree(path.join(args.output, d))

    for index in range(len(dataset)):
        name = dataset.videos[index]
        final = path.join(args.output, name)
        if args.skip_done and path.isdir(final):
            print(name, "(skipped)", flush=True)
            continue
        data = dataset[index]
        rgb, msk = data["rgb"], data["gt"]
        total_t = rgb.shape[0]
        gen = FusionGenerator(prop_net, rgb, mem_freq=args.mem_freq,
                              device=device)
        staging = final + ".__tmp__"
        os.makedirs(staging)
        for frame in range(0, total_t, args.separation):
            usable = [k for k in range(msk.shape[0])
                      if (msk[k, frame] > 0.5).sum() > MIN_PIXELS][:MAX_OBJECTS]
            if not usable:
                continue
            gen.reset(len(usable))
            if args.dataset == "DAVIS":
                left, right = 0, total_t - 1
            else:
                left = max(0, frame - args.range)
                right = min(total_t - 1, frame + args.range)
            probs = gen.interact_mask(msk[usable, frame], frame, left, right)
            for ki, obj_id in enumerate(usable):
                obj_out = path.join(staging, f"{frame:05d}", f"{obj_id + 1:05d}")
                os.makedirs(obj_out)
                arr = (probs[ki + 1] * 255).astype(np.uint8)
                for f in range(left, right + 1):
                    _save_png(path.join(obj_out, f"{f:05d}.png"), arr[f])
        if path.isdir(final):
            shutil.rmtree(final)
        os.rename(staging, final)
        print(name, flush=True)
    print("ALL-DONE", flush=True)


if __name__ == "__main__":
    main()
