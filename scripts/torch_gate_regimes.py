"""The kernel read against the exact read on two random-init bank regimes
at small banks, on one card (the PyTorch port; no JAX).

Both regimes are kernel_check.encoder_banks of the random-init (seed 0)
fp32 encoder over 26 frames of 480x854, K = 3: `synthetic_video`
(chip_smoke.py's drifting ellipses, seed 7; the banks of chip_smoke's
gate, DAVIS, fusion_gen and multichip gates) and `synthetic_sequence`
(the JAX kernel check's frames, seed 7). For each regime, K = 2 and 3,
M = 1620 x f (f = 1, 2, 3, 4, 6, 8, 13, 26; no invalid slots, as a
session's live bank) and fp32 and bf16 banks, one JSON line: the kernel
read's mean and max error against the exact torch.topk read and its
mean error against its plain version, each over the readout scale (mean
|exact|), and whether the gate's bounds hold (mean < 1e-3, max < 0.3;
against plain, mean <= 1e-4). Reported, not gated.

Usage, from the repository root:
  PYTHONPATH=. python scripts/torch_gate_regimes.py
"""
import json

import torch

import chip_smoke as cs
from mivos_tpu_torch import kernel_check as kc
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.ops.memory_read import memory_read

FRAMES = (1, 2, 3, 4, 6, 8, 13, 26)


def main():
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"device": cs.phase_card()}), flush=True)
    regimes = {"synthetic_video": cs.synthetic_video(7, kc.GATE_FRAMES + 1, kc.H, kc.W, kc.K),
               "synthetic_sequence": None}
    n16 = (-(-kc.H // 16)) * (-(-kc.W // 16))
    for regime, video in regimes.items():
        mk_all, mv_all, q = kc.encoder_banks(kc.prop_net(None), kc.GATE_FRAMES, dev, video)
        for k in (2, 3):
            for f in FRAMES:
                for dtype in (torch.float32, torch.bfloat16):
                    mk = cs.bank_prefix(mk_all, k, f * n16, dtype)
                    mv = cs.bank_prefix(mv_all, k, f * n16, dtype)
                    exact = memory_read(mk, mv, q, top_k=kc.TOP_K, backend="exact")
                    out = cmr.memory_read_threshold_cuda(mk, mv, q, kc.TOP_K)
                    plain = cmr.memory_read_threshold_plain(mk, mv, q, kc.TOP_K)
                    scale = exact.abs().mean().item()
                    rep = {"regime": regime, "K": k, "M": f * n16, "dtype": str(dtype)[6:],
                           "vs_exact_mean": (out - exact).abs().mean().item() / scale,
                           "vs_exact_max": (out - exact).abs().max().item() / scale,
                           "vs_plain_mean": (out - plain).abs().mean().item() / scale}
                    rep["within_gate"] = (rep["vs_exact_mean"] < 1e-3
                                          and rep["vs_exact_max"] < 0.3
                                          and rep["vs_plain_mean"] <= 1e-4)
                    print(json.dumps(rep), flush=True)
        del mk_all, mv_all
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
