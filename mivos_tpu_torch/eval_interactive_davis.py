"""DAVIS 2017 interactive evaluation on one device (counterpart of the
repository's eval_interactive_davis.py; reference eval_interactive_davis.py).

  python -m mivos_tpu_torch.eval_interactive_davis --davis ../DAVIS/2017 \
      --output out --prop_model saves/propagation_model.pth \
      --fusion_model saves/fusion.pth --s2m_model saves/s2m.pth

Without the `davisinteractive` package, or with --local_robot, the
in-repo robot (eval/robot.py) plays the user. Reading DAVIS from disk
needs PIL. --device cuda (the default) needs a CUDA device and fails
without one; it never moves to the CPU by itself.
"""
import argparse

import torch

from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.eval.davis_interactive import (run_davis_interactive,
                                                    run_local_interactive_davis)
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prop_model", default="saves/propagation_model.pth")
    p.add_argument("--fusion_model", default="saves/fusion.pth")
    p.add_argument("--s2m_model", default="saves/s2m.pth")
    p.add_argument("--davis", default="../DAVIS/2017")
    p.add_argument("--output", required=True)
    p.add_argument("--save_mask", action="store_true")
    p.add_argument("--mem_freq", type=int, default=5)
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"),
                   help="conv-tower and memory-bank compute dtype")
    p.add_argument("--read_backend", default="auto",
                   help="memory-read backend: auto|cuda|plain|exact "
                        "(see ops/memory_read.py)")
    p.add_argument("--local_robot", action="store_true",
                   help="use the in-repo scribble robot and session "
                        "(eval/robot.py) instead of the davisinteractive "
                        "package; chosen when the package is missing. "
                        "Scores are not comparable to official AUC-J&F.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the whole session (cuda, cuda:N, cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    dtype = getattr(torch, args.dtype)
    # top_k flows through MemoryConfig only; InferenceCore applies it.
    prop_net = load_reference_pth(PropagationNetwork(
        dtype=dtype, read_backend=args.read_backend), args.prop_model)
    fuse_net = load_reference_pth(FusionNet(dtype=dtype), args.fusion_model)
    s2m_net = load_reference_pth(S2MNetwork(dtype=dtype), args.s2m_model)
    mem = MemoryConfig(top_k=args.top_k, mem_freq=args.mem_freq)

    use_local = args.local_robot
    if not use_local:
        try:
            import davisinteractive  # noqa: F401
        except ImportError:
            print("davisinteractive not installed; falling back to the "
                  "in-repo robot (--local_robot).")
            use_local = True
    if use_local:
        summary = run_local_interactive_davis(
            prop_net, fuse_net, s2m_net, davis_root=args.davis, mem=mem,
            out_path=args.output, save_mask=args.save_mask, device=device)
    else:
        summary = run_davis_interactive(
            prop_net, fuse_net, s2m_net, davis_root=args.davis,
            out_path=args.output, save_mask=args.save_mask, mem=mem,
            device=device)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
