"""Metric accumulation across iterations with derived-metric hooks
(counterpart of mivos_tpu/utils/integrator.py; reference
util/log_integrator.py). Under data-parallel training each rank
accumulates its own batches; `finalize` averages the means over the
ranks with one all-reduce (the JAX `_cross_host_mean`, the reference's
reduce to rank 0, util/log_integrator.py:69-76), and only rank 0 logs.

Keys that start with 'hide' are accumulated but not logged; hooks read
them to derive metrics (IoU from intersection and union sums,
reference model/losses.py:8-17).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

Hook = Callable[[Dict[str, float]], Tuple[str, float]]


def cross_rank_mean(values: Dict[str, float]) -> Dict[str, float]:
    """Each value's mean over the ranks of the default process group
    (every rank passes the same keys); `values` itself on one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return values
    keys = sorted(values)
    # On a rank's card under NCCL; gloo reduces CPU tensors.
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([values[k] for k in keys], dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    t /= dist.get_world_size()
    return dict(zip(keys, t.tolist()))


class Integrator:
    def __init__(self, logger, is_main: bool = True):
        """is_main: whether this process logs (rank 0 under DDP)."""
        self.values: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.hooks: List[Hook] = []
        self.logger = logger
        self.is_main = is_main

    def add_tensor(self, key: str, value) -> None:
        """value: a number or a tensor (its mean; a card's tensor is
        read back here)."""
        v = float(torch.as_tensor(value, dtype=torch.float64).mean())
        self.values[key] = self.values.get(key, 0.0) + v
        self.counts[key] = self.counts.get(key, 0) + 1

    def add_dict(self, d: Dict) -> None:
        for k, v in d.items():
            self.add_tensor(k, v)

    def add_hook(self, hook: Hook) -> None:
        self.hooks.append(hook)

    def reset_except_hooks(self) -> None:
        self.values, self.counts = {}, {}

    def finalize(self, prefix: str, it: int) -> Dict[str, float]:
        """Run the hooks on this rank's sums, average every mean over the
        ranks, log all but the hidden ones (on the main process) and
        return them. Every rank must call it at the same iteration."""
        for hook in self.hooks:
            self.add_tensor(*hook(self.values))
        avgs = cross_rank_mean({k: total / self.counts[k]
                                for k, total in self.values.items()})
        out = {}
        for k, avg in avgs.items():
            if k.startswith("hide"):
                continue
            out[k] = avg
            if self.is_main and self.logger is not None:
                self.logger.log_metrics(prefix, k, avg, it)
        return out
