"""The 8-round protocol's fast-vs-exact |dJ&F| over several pretraining
runs, on one card (the PyTorch port; no JAX).

Each sample pretrains as chip_smoke.py's pretrain phase does (prop 500
steps at 192x192, chain-3 steps at 256x448 for --chain3-box seconds, s2m
500), then runs `full_protocol`'s rounds (2 sequences of 40 frames,
K = 2, 8 rounds, fusion off) at each --sizes entry through each variant
and prints one JSON line per (size, variant): its largest per-round
|dJ&F| against the `exact` variant and its J&F per round.

Variants (propagation towers, S2M, read):
  fast              bf16, bf16, the kernels
  fast_s2m_fp32     bf16, fp32, the kernels
  fast_towers_fp32  fp32, bf16, the kernels
  read_only         fp32, fp32, the kernels (the paths differ in the read)
  exact             fp32, fp32, the exact read
fp32 parts run with TF32 off, every variant under deterministic cuDNN
plans.

Usage, from the repository root:
  PYTHONPATH=. python scripts/torch_protocol_samples.py --samples 4 \\
      [--chain3-box 15] [--sizes 480x854 256x448] [--variants fast read_only exact]
"""
import argparse
import contextlib
import json
import os
import tempfile

import torch

import chip_smoke as cs
from mivos_tpu_torch import full_protocol
from mivos_tpu_torch.accuracy_envelope import tf32_off
from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork

B, F = torch.bfloat16, torch.float32
# The pretrain phase's depth when these samples were recorded (PR 14):
# its steps, and the default seconds of chain-3 steps.
PRE_STEPS, CHAIN3_BOX_S = {"prop": 500, "s2m": 500}, 30.0
VARIANTS = {"fast": (B, B, "auto"), "fast_s2m_fp32": (B, F, "auto"),
            "fast_towers_fp32": (F, B, "auto"), "read_only": (F, F, "auto"),
            "exact": (F, F, "exact")}


def pretrain(out, dev):
    common = ["--out", out, "--lr", str(cs.PRE_LR), "--hw", str(cs.PRE_HW),
              "--seed", str(cs.PRE_SEED)]
    with cs.cudnn_mode(benchmark=True):
        for kind in ("prop", "s2m"):
            cs.pretrain_stage(kind, common + ["--steps", str(PRE_STEPS[kind])], dev)
            if kind == "prop":
                rep = cs.pretrain_chain3(out, dev)
                cs.log(json.dumps({"chain3_box": cs.CHAIN3_BOX_S, "steps": rep["steps"]}))


def jf_records(out, dev, hw, names):
    seqs = full_protocol.build_sequences(2, 40, hw[0], hw[1], 2)
    mem = MemoryConfig(top_k=50, mem_freq=5)
    jf = {}
    with cs.cudnn_mode(False, deterministic=True):
        for name in names:
            pd, sd, backend = VARIANTS[name]
            prop = load_reference_pth(PropagationNetwork(top_k=50, dtype=pd, read_backend=backend),
                                      os.path.join(out, "prop_synthetic.pth"))
            s2m = load_reference_pth(S2MNetwork(dtype=sd), os.path.join(out, "s2m_synthetic.pth"))
            with tf32_off() if F in (pd, sd) else contextlib.nullcontext():
                rep = full_protocol.run_config(name, prop, s2m, None, seqs, 8, mem, dev,
                                               log=lambda *a: None)
            jf[name] = rep["summary"]["records"]
    return jf


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=4)
    ap.add_argument("--chain3-box", type=float, default=CHAIN3_BOX_S)
    ap.add_argument("--sizes", nargs="+", default=["480x854"])
    ap.add_argument("--variants", nargs="+", default=["fast", "read_only", "exact"],
                    choices=list(VARIANTS))
    args = ap.parse_args()
    names = list(dict.fromkeys(args.variants + ["exact"]))
    card = cs.phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.CHAIN3_BOX_S = args.chain3_box
    for _ in range(args.samples):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "weights")
            pretrain(out, dev)
            for size in args.sizes:
                hw = tuple(int(x) for x in size.split("x"))
                jf = jf_records(out, dev, hw, names)
                for name in names:
                    cs.log(json.dumps({
                        "chain3_box": args.chain3_box, "hw": hw, "variant": name,
                        "max_djf_vs_exact": max(full_protocol.jf_deltas(jf[name], jf["exact"])),
                        "jf": {k: [x for _, x in v] for k, v in jf[name].items()}}))
    cs.log(card)


if __name__ == "__main__":
    main()
