"""Space-time memory bank for one propagation pass (counterpart of
mivos_tpu/core/memory_bank.py).

Sized exactly per pass, as the reference does (inference_core.py:136-151):
keys (K, (total_m + 1) * n, CK) and values (K, (total_m + 1) * n, CV) in
the compute dtype, with slot s occupying rows [s*n, (s+1)*n) and one
transient slot past the committed ones. Writes go into the buffers in
place, and reads get the live prefix `[:, :rows]` (a view: rows stay
contiguous, the object axis strides over the full buffer).

The JAX bank rounded its capacity up to power-of-two buckets and passed
a liveness mask so that `jit` would not retrace as the bank grew. Eager
PyTorch retraces nothing, so this bank needs neither buckets nor masks.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


class MemoryBank:
    def __init__(self, k: int, n: int, key_dim: int = 128, val_dim: int = 512,
                 dtype: torch.dtype = torch.float32,
                 device: torch.device = torch.device("cpu")):
        self.k, self.n = k, n
        self.key_dim, self.val_dim = key_dim, val_dim
        self.dtype, self.device = dtype, device
        self.cap = 0        # slots allocated (committed + transient)
        self.num_slots = 0  # committed slots
        self.keys: Optional[torch.Tensor] = None
        self.values: Optional[torch.Tensor] = None

    def reset(self, total_slots: int, init_k: Optional[torch.Tensor] = None,
              init_v: Optional[torch.Tensor] = None) -> None:
        """Allocate for a pass committing up to total_slots slots (+1
        transient), seeding the first slots from (K, s*n, C) certain
        memory."""
        self.cap = total_slots + 1
        rows = self.cap * self.n
        self.keys = torch.empty((self.k, rows, self.key_dim), dtype=self.dtype,
                                device=self.device)
        self.values = torch.empty((self.k, rows, self.val_dim),
                                  dtype=self.dtype, device=self.device)
        init_rows = 0 if init_k is None else init_k.shape[1]
        if init_rows:
            self.keys[:, :init_rows] = init_k
            self.values[:, :init_rows] = init_v
        self.num_slots = init_rows // self.n

    def write(self, slot: int, mk: torch.Tensor, mv: torch.Tensor) -> None:
        """Write one frame's (K, n, C) keys/values into `slot` in place
        (the transient slot is slot == num_slots); liveness is unchanged."""
        if not 0 <= slot < self.cap:
            raise IndexError(f"slot {slot} outside bank capacity {self.cap}")
        self.keys[:, slot * self.n:(slot + 1) * self.n] = mk
        self.values[:, slot * self.n:(slot + 1) * self.n] = mv

    def live(self, include_transient: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """Views of the live rows: the committed slots, plus the transient
        slot when the previous frame was not committed."""
        rows = (self.num_slots + int(include_transient)) * self.n
        return self.keys[:, :rows], self.values[:, :rows]
