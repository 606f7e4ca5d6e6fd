"""Metric accumulation across iterations with derived-metric hooks
(counterpart of mivos_tpu/utils/integrator.py; reference
util/log_integrator.py), on one process: the JAX integrator's mean over
hosts waits for multi-GPU training.

Keys that start with 'hide' are accumulated but not logged; hooks read
them to derive metrics (IoU from intersection and union sums,
reference model/losses.py:8-17).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

Hook = Callable[[Dict[str, float]], Tuple[str, float]]


class Integrator:
    def __init__(self, logger):
        self.values: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.hooks: List[Hook] = []
        self.logger = logger

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
        """Run the hooks, log every mean but the hidden ones, and return
        them."""
        for hook in self.hooks:
            self.add_tensor(*hook(self.values))
        out = {}
        for k, total in self.values.items():
            if k.startswith("hide"):
                continue
            out[k] = total / self.counts[k]
            if self.logger is not None:
                self.logger.log_metrics(prefix, k, out[k], it)
        return out
