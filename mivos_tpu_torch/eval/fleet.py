"""Fleet-parallel inference: many videos across many GPUs (counterpart of
mivos_tpu/eval/fleet.py).

The reference runs inference on one GPU (inference_core.py:36
`device='cuda:0'`) and walks sequences serially. Interactive VOS
evaluation is parallel across videos, so a host with several cards runs
one session per video per card: each worker thread owns one device,
made current with `torch.cuda.device`, and runs whole sessions on it
with its own prepared copy of the networks.

Threads, not processes: a session spends its host time launching
kernels and waiting on the card, so a thread per device keeps every card
busy without a second copy of the weights in host memory.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore, prepared_copies
from mivos_tpu_torch.parallel.mesh import device_scope
from mivos_tpu_torch.serve.server import session_devices


def fleet_map(fn: Callable, items: Sequence,
              devices: Optional[List] = None) -> List:
    """Run fn(item, device) for every item, fanning items over devices
    (by default every CUDA device; raises without one). Each worker
    thread OWNS one device and pulls items from a shared queue (work
    stealing), so a slow video never queues two sessions onto one card
    while others idle. fn runs with its worker's device current."""
    devices = session_devices(devices)
    results = [None] * len(items)
    errors: List = []
    next_item = iter(range(len(items)))
    lock = threading.Lock()

    def worker(dev: torch.device) -> None:
        while True:
            with lock:
                i = next(next_item, None)
            if i is None:
                return
            try:
                with device_scope(dev):
                    results[i] = fn(items[i], dev)
            except Exception as e:  # surface after the pool drains
                errors.append((i, e))

    if len(items) <= 1 or len(devices) <= 1:
        worker(devices[0])
    else:
        with ThreadPoolExecutor(max_workers=len(devices)) as ex:
            list(ex.map(worker, devices))
    if errors:
        i, e = errors[0]
        raise RuntimeError(f"fleet item {i} failed: {e!r}") from e
    return results


def propagate_videos(prop_net, fuse_net, videos: Sequence, masks: Sequence,
                     mem: MemoryConfig = MemoryConfig(),
                     devices: Optional[List] = None) -> List[np.ndarray]:
    """Propagate a mask of frame 0 through each video, videos fanned out
    over the devices. videos[i]: (T, H, W, 3); masks[i]: (K+1, H, W, 1)
    probabilities, K objects. Returns per-video (T, H, W) labels. Each
    device gets its own prepared copy of the nets (`prepared_copies`)."""
    devices = session_devices(devices)
    nets = prepared_copies((prop_net, fuse_net), devices)

    def run(i: int, dev: torch.device) -> np.ndarray:
        core = InferenceCore(*nets[dev], videos[i], masks[i].shape[0] - 1,
                             mem=mem, device=dev)
        return core.interact(masks[i], 0).copy()

    return fleet_map(run, list(range(len(videos))), devices=devices)
