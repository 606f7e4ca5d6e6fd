"""FLOPs and bytes of one propagated frame, and the MFU share at a
measured frame rate (counterpart of scripts/mfu_report.py).

Phases of one frame at the production shape (480x864 padded, K = 3, a
bank of M = 20480 positions, bf16 conv weights): query encode
(`get_query_values`), read + decode, memorize, aggregate, and the read
alone. The towers, the decoder and the aggregate are counted by
`torch.utils.flop_counter.FlopCounterMode` (2 FLOPs a multiply-add of
convolutions and matrix products; elementwise work is not counted) and,
for bytes, by a dispatch mode that sums each operator's tensor inputs
and outputs (views excluded; unfused, so more than a fused compiler's
count). The memory read is counted by `kernel_check.work`, the read
kernels' tensor-core passes (`bound_ms`'s formula): phase A and phase B
at n_refine 0 on bf16 banks. The JAX script counted its read as the
`xla_approx` read's XLA cost (a dense bf16 affinity, approx_max_k, a
dense weighted sum: one pass each), so its read figure is about half of
this one's affinity FLOPs and its bytes include the dense (K, N, M)
affinity the kernels never write.

--measure N: CUDA-event ms a call of each phase, over N calls on N
distinct inputs after one warm-up call (the read alone on the cuda and
the plain backends), their sum per frame and the device-only frames/s.
--fps F: `mfu_at_fps` = F x FLOPs a frame / 989 TFLOP/s, the H100 SXM's
dense bf16 peak at 700 W.

Usage: python -m mivos_tpu_torch.mfu_report [--fps F] [--measure N]
    [--out PATH] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from typing import Callable, Dict

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from mivos_tpu_torch import kernel_check
from mivos_tpu_torch.core.inference import prepare_net
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.aggregate import aggregate_wbg
from mivos_tpu_torch.ops.memory_read import memory_read
from mivos_tpu_torch.utils.measure import cuda_ms, device_info, require_device

H, W, K, M_BANK = 480, 864, 3, 20480   # padded 480p, 3 objects, ~13 frames
PEAK_BF16 = kernel_check.PEAK_BF16_FLOPS


class ByteCounter(TorchDispatchMode):
    """Bytes of every operator's tensor inputs and outputs (views and
    metadata operators excluded)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            leaves = tree_flatten((args, kwargs or {}))[0] + tree_flatten(out)[0]
            self.bytes += sum(x.numel() * x.element_size() for x in leaves
                              if isinstance(x, torch.Tensor))
        return out


def cost(fn: Callable) -> Dict[str, float]:
    """GFLOPs and GB of one call of fn() (module docstring)."""
    flops = FlopCounterMode(display=False)
    nbytes = ByteCounter()
    with torch.no_grad(), flops, nbytes:
        fn()
    return {"gflops": flops.get_total_flops() / 1e9, "gbytes": nbytes.bytes / 1e9}


def read_cost(k: int, n: int, m: int) -> Dict[str, float]:
    """The read kernels' work at n_refine 0 on bf16 banks."""
    flops, nbytes = map(sum, zip(*(kernel_check.work(name, k, n, m, torch.bfloat16)
                                   for name in ("candidates", "readout"))))
    return {"gflops": flops / 1e9, "gbytes": nbytes / 1e9}


def add(a: Dict[str, float], b: Dict[str, float]) -> Dict[str, float]:
    return {key: a[key] + b[key] for key in a}


def make_net(dev) -> PropagationNetwork:
    net = init_params(PropagationNetwork(top_k=50, dtype=torch.bfloat16),
                      torch.Generator().manual_seed(0))
    return prepare_net(net, dev)


def phase_costs(net: PropagationNetwork, dev, hw=None, k: int = None,
                m_bank: int = None) -> Dict[str, Dict[str, float]]:
    """Each phase's {"gflops", "gbytes"} at (hw, k, m_bank)."""
    h, w = hw or (H, W)
    k, m_bank = k or K, m_bank or M_BANK
    rng = np.random.RandomState(0)
    image = torch.from_numpy(rng.rand(h, w, 3).astype(np.float32)).to(dev)
    masks = torch.from_numpy(rng.rand(k, h, w, 1).astype(np.float32)).to(dev)
    n16 = (h // 16) * (w // 16)
    with torch.no_grad():
        _, f8, f4, _, v16 = net.get_query_values(image)
    readout = torch.zeros((k, n16, 512), device=dev)
    phases = {"query_encode": cost(lambda: net.get_query_values(image)),
              "read_decode": add(read_cost(k, n16, m_bank), cost(
                  lambda: torch.sigmoid(net.decode(readout, f8, f4, v16)))),
              "memorize": cost(lambda: net.memorize(image, masks)),
              "aggregate": cost(lambda: aggregate_wbg(masks, keep_bg=True)),
              "memory_read_only": read_cost(k, n16, m_bank)}
    return phases


def measure(net: PropagationNetwork, dev, n: int) -> Dict[str, float]:
    """CUDA-event ms a call of each phase over n distinct inputs."""
    rng = np.random.RandomState(1)
    h16, w16 = H // 16, W // 16
    n16 = h16 * w16
    ims = torch.from_numpy(rng.rand(n, H, W, 3).astype(np.float32)).to(dev)
    msk = torch.from_numpy(rng.rand(n, K, H, W, 1).astype(np.float32)).to(dev)
    qs = torch.from_numpy(rng.rand(n, n16, 128).astype(np.float32)).to(dev, torch.bfloat16)
    bk = torch.from_numpy(rng.randn(K, M_BANK, 128).astype(np.float32)).to(dev, torch.bfloat16)
    bv = torch.from_numpy(rng.randn(K, M_BANK, 512).astype(np.float32)).to(dev, torch.bfloat16)
    valid = torch.ones(M_BANK, dtype=torch.bool, device=dev)
    with torch.no_grad():
        _, f8, f4, _, v16 = net.get_query_values(ims[0])

    def over_inputs(fn):
        it = iter(range(10 ** 9))
        return cuda_ms(lambda: fn(next(it) % n), iters=n, warmup=1)

    timed = {}
    with torch.no_grad():
        timed["query_encode"] = over_inputs(lambda i: net.get_query_values(ims[i]))
        timed["read_decode"] = over_inputs(lambda i: torch.sigmoid(net.decode(
            memory_read(bk, bv, qs[i], top_k=50, valid=valid), f8, f4, v16)))
        timed["memorize"] = over_inputs(lambda i: net.memorize(ims[0], msk[i]))
        for backend in ("cuda", "plain"):
            timed[f"memory_read_only_{backend}"] = over_inputs(lambda i, b=backend: memory_read(
                bk, bv, qs[i], top_k=50, valid=valid, backend=b))
    step = timed["query_encode"] + timed["read_decode"] + timed["memorize"]
    timed["frame_total"] = step
    timed["device_only_fps"] = 1e3 / step
    return timed


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fps", type=float, default=None,
                    help="measured session frames/s (bench); enables MFU")
    ap.add_argument("--measure", type=int, default=0, metavar="N",
                    help="also time each phase on the card over N inputs")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "mfu_report.json"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    net = make_net(dev)
    phases = phase_costs(net, dev)
    total = sum(p["gflops"] for name, p in phases.items() if name != "memory_read_only")
    report = {"per_frame_gflops": total, "phases": phases,
              "shape": {"hw": [H, W], "objects": K, "bank_m": M_BANK},
              "device": device_info(dev)}
    if args.measure:
        if dev.type != "cuda":
            raise SystemExit("--measure times the card: run it with --device cuda")
        report["measured_ms"] = measure(net, dev, args.measure)
    if args.fps:
        report["fps"] = args.fps
        report["mfu_at_fps"] = args.fps * total * 1e9 / PEAK_BF16
    print(json.dumps(report, indent=1), flush=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("MFU-OK", flush=True)
    return report


if __name__ == "__main__":
    main()
