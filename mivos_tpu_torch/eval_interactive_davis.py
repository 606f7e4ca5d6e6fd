"""DAVIS 2017 interactive evaluation (counterpart of the repository's
eval_interactive_davis.py; reference eval_interactive_davis.py).

  python -m mivos_tpu_torch.eval_interactive_davis --davis ../DAVIS/2017 \
      --output out --prop_model saves/propagation_model.pth \
      --fusion_model saves/fusion.pth --s2m_model saves/s2m.pth \
      [--bank_sharded] [--object_shards N] [--fleet]

Without the `davisinteractive` package, or with --local_robot, the
in-repo robot (eval/robot.py) plays the user. Reading DAVIS from disk
needs PIL. --device cuda (the default) needs a CUDA device and fails
without one; it never moves to the CPU by itself.

Sharded sessions span the CUDA devices of the host, one mesh position
per card: --bank_sharded splits each session's bank over all of them,
--object_shards N the objects over N of them (a sequence whose object
count N does not divide runs object-unsharded), both together a 2D
mesh of N object x (cards / N) position shards. The mesh never repeats
a card: with fewer cards than positions the run stops. --fleet instead
runs one whole session per sequence per card, and excludes both.
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
from mivos_tpu_torch.parallel.mesh import make_mesh, make_mesh_nd


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
    p.add_argument("--bank_sharded", action="store_true",
                   help="shard each session's memory bank position axis "
                        "over every CUDA device (long videos; MemoryConfig."
                        "bank_sharded)")
    p.add_argument("--object_shards", type=int, default=0,
                   help="shard the object axis over this many CUDA devices "
                        "(per-frame latency; sequences whose object count "
                        "is not divisible run unsharded). Composes with "
                        "--bank_sharded on a 2D mesh.")
    p.add_argument("--fleet", action="store_true",
                   help="fan sequences across every CUDA device, one whole "
                        "session per sequence per device (implies "
                        "--local_robot; exclusive with the sharded session "
                        "flags)")
    p.add_argument("--local_robot", action="store_true",
                   help="use the in-repo scribble robot and session "
                        "(eval/robot.py) instead of the davisinteractive "
                        "package; chosen when the package is missing. "
                        "Scores are not comparable to official AUC-J&F.")
    p.add_argument("--device", default="cuda",
                   help="torch device of the whole session (cuda, cuda:N, cpu)")
    return p.parse_args(argv)


def session_mesh(args):
    """The mesh the sharding flags ask for, over the host's CUDA devices
    (make_mesh raises when there are too few), or None."""
    if args.object_shards > 0 and args.bank_sharded:
        nd = torch.cuda.device_count()
        if nd % args.object_shards or nd < args.object_shards:
            raise SystemExit(
                f"--object_shards {args.object_shards} must divide the "
                f"device count ({nd}) when combined with --bank_sharded")
        return make_mesh_nd(object=args.object_shards,
                            data=nd // args.object_shards)
    if args.object_shards > 0:
        return make_mesh(args.object_shards, axis="object")
    if args.bank_sharded:
        return make_mesh()
    return None


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")

    if args.fleet and (args.bank_sharded or args.object_shards > 0):
        raise SystemExit("--fleet is exclusive with --bank_sharded/"
                         "--object_shards (one session per device)")
    mem = MemoryConfig(top_k=args.top_k, mem_freq=args.mem_freq,
                       bank_sharded=args.bank_sharded,
                       object_sharded=args.object_shards > 0)
    mesh = session_mesh(args)

    dtype = getattr(torch, args.dtype)
    # top_k flows through MemoryConfig only; InferenceCore applies it.
    prop_net = load_reference_pth(PropagationNetwork(
        dtype=dtype, read_backend=args.read_backend), args.prop_model)
    fuse_net = load_reference_pth(FusionNet(dtype=dtype), args.fusion_model)
    s2m_net = load_reference_pth(S2MNetwork(dtype=dtype), args.s2m_model)

    use_local = args.local_robot or args.fleet
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
            out_path=args.output, save_mask=args.save_mask, device=device,
            mesh=mesh, fleet=args.fleet)
    else:
        summary = run_davis_interactive(
            prop_net, fuse_net, s2m_net, davis_root=args.davis,
            out_path=args.output, save_mask=args.save_mask, mem=mem,
            device=device, mesh=mesh)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
