"""Time the port's interactive session on two checkouts, in alternation,
to hold a change to the session loop to its parent's speed. From the
repository root:

    python scripts/torch_session_ab.py OLD_TREE NEW_TREE [--rounds 4]

The settings are chip_smoke.py's `session` phase: 60 frames at 480x854,
3 objects, top_k 50, mem_freq 5, random nets from seed 0, TF32 off and
cuDNN autotune on. Each side runs in a process of its own with its tree
first on sys.path, in the order OLD, NEW, NEW, OLD. A side builds the
read kernels of its tree, runs one warm round, then --rounds first rounds
(interaction on frame 0, a new session each) and one fusion round
(interaction on frame 59), with bf16 nets and then fp32 nets. Prints one
JSON line per side and dtype: the tree, the round seconds and the first
rounds' frames/s. Needs a CUDA card.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

T, RH, RW, K, TOP_K, MEM_FREQ = 60, 480, 854, 3, 50, 5


def interaction_mask(seed):
    """(K+1, RH, RW, 1) hard probabilities of a random label map."""
    import numpy as np

    lab = np.random.RandomState(seed).randint(0, K + 1, (RH, RW))
    fg = (lab[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)
    return np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None]


def side(tree, rounds):
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch

    from mivos_tpu_torch.config import MemoryConfig
    from mivos_tpu_torch.core.inference import InferenceCore
    from mivos_tpu_torch.models.fusion import FusionNet
    from mivos_tpu_torch.models.initializer import init_params
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.rand(T, RH, RW, 3).astype(np.float32)).to(dev)
    masks = [torch.from_numpy(interaction_mask(s)).to(dev) for s in range(rounds + 2)]
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)

    def timed(core, mask, idx):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        core.interact(mask, idx)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator().manual_seed(0)
        prop = init_params(PropagationNetwork(top_k=TOP_K, dtype=dtype), gen)
        fuse = init_params(FusionNet(dtype=dtype), gen)
        new = lambda: InferenceCore(prop, fuse, images, K, mem=mem, device=dev)  # noqa: E731
        timed(new(), masks[-1], 0)   # warm: kernel build, cuDNN plans
        first = []
        for s in range(rounds):
            core = new()
            first.append(timed(core, masks[s], 0))
        fusion = timed(core, masks[rounds], T - 1)
        print(json.dumps({"tree": tree, "dtype": str(dtype)[6:], "first_round_s": first,
                          "first_round_frames_s": [(T - 1) / s for s in first],
                          "fusion_round_s": fusion}), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new", nargs="?")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--side", action="store_true",
                    help="run one side in this process (OLD is its tree)")
    args = ap.parse_args()
    if args.side:
        side(args.old, args.rounds)
        return
    for tree in (args.old, args.new, args.new, args.old):
        subprocess.run([sys.executable, __file__, tree, "--side",
                        "--rounds", str(args.rounds)], check=True)


if __name__ == "__main__":
    main()
