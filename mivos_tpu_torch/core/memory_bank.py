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

With a 1-D `mesh` the bank is sharded: its capacity is rounded up to a
multiple of the mesh size (the JAX bank's `min_cap`,
mivos_tpu/core/memory_bank.py:81-86), each position holds cap / D whole
slots on its device, and `keys`/`values` are grids of those buffers
(parallel/sharded_memory.py). A slot's write goes to the one shard that
owns it; the live view is each shard's live prefix, empty in shards the
pass has not reached yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mivos_tpu_torch.parallel.mesh import Mesh
from mivos_tpu_torch.parallel.sharded_memory import sharded_bank_write


class MemoryBank:
    def __init__(self, k: int, n: int, key_dim: int = 128, val_dim: int = 512,
                 dtype: torch.dtype = torch.float32, *,
                 device: torch.device | str, mesh: Optional[Mesh] = None):
        if mesh is not None and len(mesh.axis_names) != 1:
            raise ValueError(f"a bank shards over a 1-D mesh, got axes "
                             f"{mesh.axis_names}")
        self.k, self.n = k, n
        self.key_dim, self.val_dim = key_dim, val_dim
        self.dtype, self.device, self.mesh = dtype, device, mesh
        self.cap = 0        # slots allocated (committed + transient)
        self.num_slots = 0  # committed slots
        self.keys = None    # tensor, or a grid of shards with a mesh
        self.values = None

    def _empty(self, rows: int, dim: int, device) -> torch.Tensor:
        return torch.empty((self.k, rows, dim), dtype=self.dtype, device=device)

    def reset(self, total_slots: int, init_k: Optional[torch.Tensor] = None,
              init_v: Optional[torch.Tensor] = None) -> None:
        """Allocate for a pass committing up to total_slots slots (+1
        transient), seeding the first slots from (K, s*n, C) certain
        memory."""
        self.cap = total_slots + 1
        init_rows = 0 if init_k is None else init_k.shape[1]
        if self.mesh is None:
            rows = self.cap * self.n
            self.keys = self._empty(rows, self.key_dim, self.device)
            self.values = self._empty(rows, self.val_dim, self.device)
            if init_rows:
                self.keys[:, :init_rows] = init_k
                self.values[:, :init_rows] = init_v
        else:
            d = self.mesh.size
            self.cap = -(-self.cap // d) * d
            rows = self.cap // d * self.n
            self.keys = np.empty(d, dtype=object)
            self.values = np.empty(d, dtype=object)
            for i, dev in enumerate(self.mesh.devices):
                self.keys[i] = self._empty(rows, self.key_dim, dev)
                self.values[i] = self._empty(rows, self.val_dim, dev)
            for s in range(init_rows // self.n):
                self.write(s, init_k[:, s * self.n:(s + 1) * self.n],
                           init_v[:, s * self.n:(s + 1) * self.n])
        self.num_slots = init_rows // self.n

    def write(self, slot: int, mk: torch.Tensor, mv: torch.Tensor) -> None:
        """Write one frame's (K, n, C) keys/values into `slot` in place
        (the transient slot is slot == num_slots); liveness is unchanged."""
        if not 0 <= slot < self.cap:
            raise IndexError(f"slot {slot} outside bank capacity {self.cap}")
        row = slot * self.n
        if self.mesh is None:
            self.keys[:, row:row + self.n] = mk
            self.values[:, row:row + self.n] = mv
        else:
            axis = self.mesh.axis_names[0]
            sharded_bank_write(self.mesh, self.keys, mk, row, axis)
            sharded_bank_write(self.mesh, self.values, mv, row, axis)

    def rows(self, include_transient: bool) -> int:
        """The live rows M: the committed slots', plus the transient
        slot's when the previous frame was not committed."""
        return (self.num_slots + int(include_transient)) * self.n

    def live(self, include_transient: bool) -> Tuple:
        """Views of the live rows (`rows`). With a mesh, two grids of
        per-shard views."""
        rows = self.rows(include_transient)
        if self.mesh is None:
            return self.keys[:, :rows], self.values[:, :rows]
        per = self.cap // self.mesh.size * self.n
        keys = np.empty(self.mesh.size, dtype=object)
        values = np.empty(self.mesh.size, dtype=object)
        for i in range(self.mesh.size):
            local = min(max(rows - i * per, 0), per)
            keys[i] = self.keys[i][:, :local]
            values[i] = self.values[i][:, :local]
        return keys, values
