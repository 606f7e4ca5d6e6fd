"""What the measuring entry points share: the device they measure on,
CUDA-event timing, and the memory-read kernels' launch counts held to the
reads a run made.

A measuring entry point takes `--device` (default `cuda`) and refuses to
run on a machine without a card unless the caller asks for the CPU
(`--device cpu`, the tests' tiny wiring runs): a measurement never falls
back to the CPU. Every report names the device it ran on
(`device_info`).
"""
from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mivos_tpu_torch.ops.cuda import memory_read as cmr


def require_device(name: str) -> torch.device:
    """The device a measurement runs on; a CUDA device must exist."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"no CUDA device for --device {name}: this measurement "
                         "runs on the card (--device cpu for a wiring run)")
    return dev


def device_info(dev: torch.device) -> Dict:
    """{"name", "power_limit", "count"}: torch's device name and
    `nvidia-smi`'s power limit on the card; {"name": "cpu", ...None} on
    the CPU."""
    dev = torch.device(dev)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None, "count": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    index = dev.index or 0
    limit = (lines[index].split(",")[-1].strip() if smi.returncode == 0
             and len(lines) > index else None)
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit,
            "count": torch.cuda.device_count()}


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def wall(fn: Callable, dev):
    """(result, seconds) of fn() on the host clock, the device
    synchronised before and after."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def cuda_ms(fn: Callable, iters: int = 10, warmup: int = 2) -> float:
    """Mean CUDA-event ms of fn() over `iters` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median(xs):
    return sorted(xs)[len(xs) // 2]


def reads_of(core, idx: int) -> int:
    """Frames the next `core.interact(mask, idx)` propagates to: one
    memory read each."""
    front = min([ti for ti in core.interacted if ti > idx] + [core.t])
    back = max([ti for ti in core.interacted if ti < idx] + [-1])
    return (front - idx - 1) + (idx - back - 1)


def peak_gib(dev) -> Optional[float]:
    if torch.device(dev).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 30


class LaunchTally:
    """The memory-read kernels' launches inside `window`s, beside the
    launches the reads made there must give: each counter's
    `launches_per_read` times the reads (none on the CPU, whose reads run
    the plain version). `check` raises where they differ."""

    def __init__(self, dev):
        self.cuda = torch.device(dev).type == "cuda"
        self.got = {name: 0 for name in cmr.launch_counts()}
        self.want = dict(self.got)
        self.reads = 0

    def add(self, reads: int, bank_dtype: torch.dtype, n_refine: int = 0) -> None:
        self.reads += reads
        if self.cuda:
            for name, n in cmr.launches_per_read(bank_dtype, n_refine).items():
                self.want[name] += n * reads

    @contextlib.contextmanager
    def window(self, reads: int = 0, bank_dtype: torch.dtype = torch.bfloat16,
               n_refine: int = 0):
        """Count the launches of the block, which makes `reads` reads of
        a `bank_dtype` bank (more may be added inside with `add`)."""
        before = cmr.launch_counts()
        yield self
        after = cmr.launch_counts()
        for name in self.got:
            self.got[name] += after[name] - before[name]
        self.add(reads, bank_dtype, n_refine)

    def check(self, what: str) -> Dict[str, int]:
        if self.got != self.want:
            raise RuntimeError(f"{what}: kernel launches {self.got} where "
                               f"{self.reads} reads give {self.want}")
        return dict(self.got)


def interaction_mask(seed: int, h: int, w: int, k: int, dev) -> torch.Tensor:
    """bench.py's `mk_mask`: (k+1, h, w, 1) hard probabilities of a
    uniform random label map from RandomState(seed), on `dev`."""
    labels = np.random.RandomState(seed).randint(0, k + 1, (h, w))
    fg = (labels[None] == np.arange(1, k + 1)[:, None, None]).astype(np.float32)
    mask = np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None]
    return torch.from_numpy(mask).to(dev)
