"""Memory-bank sharding over a device mesh (counterpart of
mivos_tpu/parallel/sharded_memory.py), the sequence-parallel form of
the memory read (SURVEY.md §5.7).

A long video's bank outgrows one card. Its position axis M is split
over a mesh axis, and the read runs shard by shard:

  1. the local affinity (K, N, M_d) on each shard's device;
  2. the local exact top-k of each row: (K, N, min(top_k, M_d))
     candidate values;
  3. the candidates gathered to the query's device, where the global
     k-th value and the row max are taken. Every member of the global
     top-k is in its own shard's local top-k, so the gathered pool holds
     the exact global top-k: threshold and row max are EXACT;
  4. the local thresholded exp readout on each shard, whose partial sums
     (K, N, CV) and (K, N, 1) are added on the query's device.

The JAX module's collectives (all_gather, psum) become explicit copies:
one of (K, N, k) candidates and one of (K, N, CV) partials per shard and
read, both O(query) whatever the bank's length. The read is the exact
one and reaches no kernel, as in JAX.

A sharded tensor is a grid: a numpy object array with the mesh's shape
holding, at each position, the local tensor on that position's device.
Axes that a sharding does not name hold copies. Shards may hold
different numbers of rows (a session's live prefix: early frames live
only in the first shard); a shard with none contributes nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mivos_tpu_torch.ops.cuda.memory_read import NEG_INF
from mivos_tpu_torch.ops.memory_read import affinity_matrix
from mivos_tpu_torch.parallel.mesh import Mesh, device_scope


@dataclasses.dataclass(frozen=True, eq=False)
class BankSharding:
    """The (K, M, C) layout of a distributed bank: M over `axis` (None:
    not split), K over `object_axis` (None: not split); the mesh's other
    axes hold copies."""

    mesh: Mesh
    axis: Optional[str] = "data"
    object_axis: Optional[str] = None

    def _size(self, axis: Optional[str]) -> int:
        return 1 if axis is None else self.mesh.shape[axis]

    def _coord(self, pos: Tuple[int, ...], axis: Optional[str]) -> int:
        return 0 if axis is None else pos[self.mesh.axis_names.index(axis)]

    def shard(self, x: torch.Tensor) -> np.ndarray:
        """Copy a global (K, M, C) tensor into a grid of local shards."""
        k, m = x.shape[:2]
        d, g = self._size(self.axis), self._size(self.object_axis)
        if m % d or k % g:
            raise ValueError(f"(K, M) = {(k, m)} does not split over "
                             f"{g} object x {d} position shards")
        grid = np.empty(self.mesh.devices.shape, dtype=object)
        for pos in np.ndindex(grid.shape):
            i, o = self._coord(pos, self.axis), self._coord(pos, self.object_axis)
            grid[pos] = x[o * (k // g):(o + 1) * (k // g),
                          i * (m // d):(i + 1) * (m // d)].to(
                self.mesh.devices[pos], copy=True)
        return grid


def bank_sharding(mesh: Mesh, axis: Optional[str] = "data",
                  object_axis: Optional[str] = None) -> BankSharding:
    """The sharding of a distributed bank: positions over `axis`,
    optionally objects over `object_axis` (the 2D layout)."""
    return BankSharding(mesh, axis, object_axis)


def shard_bank(mesh: Mesh, mem_k: torch.Tensor, mem_v: torch.Tensor,
               axis: Optional[str] = "data",
               object_axis: Optional[str] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Place a bank with its position axis over `axis` (and its object
    axis over `object_axis` when given): two grids of local shards."""
    sh = bank_sharding(mesh, axis, object_axis)
    return sh.shard(mem_k), sh.shard(mem_v)


def lead_positions(mesh: Mesh, axis: Optional[str],
                   object_axis: Optional[str]) -> List[List[Tuple[int, ...]]]:
    """For each object shard, the positions of its position shards in
    order, taking coordinate 0 on every axis the layout does not name
    (where copies live, the first is read)."""
    names = mesh.axis_names
    groups = mesh.shape[object_axis] if object_axis is not None else 1
    shards = mesh.shape[axis] if axis is not None else 1
    out = []
    for g in range(groups):
        row = []
        for i in range(shards):
            pos = [0] * len(names)
            if axis is not None:
                pos[names.index(axis)] = i
            if object_axis is not None:
                pos[names.index(object_axis)] = g
            row.append(tuple(pos))
        out.append(row)
    return out


def _on(cache: Dict[torch.device, torch.Tensor], x: torch.Tensor,
        device: torch.device) -> torch.Tensor:
    """x on `device`, copied at most once per device."""
    if device not in cache:
        cache[device] = x.to(device)
    return cache[device]


def sharded_memory_read(mesh: Mesh, mem_k: np.ndarray, mem_v: np.ndarray,
                        query_k: torch.Tensor, top_k: int = 50,
                        valid: Optional[torch.Tensor] = None,
                        axis: str = "data",
                        object_axis: Optional[str] = None,
                        gather: bool = True):
    """mem_k (K, M, CK) and mem_v (K, M, CV) as grids over `mesh`, M over
    `axis` (shards may hold different row counts) and K over
    `object_axis` when given (the 2D object x position layout: the
    position collectives run within each object shard). query_k (N, CK);
    valid: optional (M,) bool over the global rows in shard order.
    Returns the (K, N, CV) fp32 readout on query_k's device, equal to
    the single-device exact top-k read up to the order of its sums.
    gather=False: a list of each object shard's (K/G, N, CV) readout on
    the device of its first position shard, as JAX's output stays
    sharded over `object_axis` (the 2D session decodes it there)."""
    home = query_k.device
    queries: Dict[torch.device, torch.Tensor] = {}
    masks: Dict[torch.device, torch.Tensor] = {}
    out = []
    for row in lead_positions(mesh, axis, object_axis):
        dst = home if gather else mem_k[row[0]].device
        parts, cands, start = [], [], 0
        for pos in row:
            mk, mv = mem_k[pos], mem_v[pos]
            m = mk.shape[1]
            if m == 0:
                continue
            dev = mk.device
            aff = affinity_matrix(mk, _on(queries, query_k, dev))
            if valid is not None:
                vl = _on(masks, valid, dev)[start:start + m]
                aff = torch.where(vl[None, None, :], aff,
                                  torch.full_like(aff, NEG_INF))
            start += m
            cands.append(torch.topk(aff, min(top_k, m), dim=-1).values.to(dst))
            parts.append((aff, mv))
        if valid is not None and start != valid.shape[0]:
            raise ValueError(f"valid has {valid.shape[0]} rows, the shards {start}")
        if not parts:
            raise ValueError("sharded_memory_read: every shard is empty")
        pool = torch.cat(cands, dim=-1)
        kk = min(top_k, pool.shape[-1])
        gtop = torch.topk(pool, kk, dim=-1).values
        gmax, kth = gtop[..., :1], gtop[..., kk - 1:kk]
        acc = wsum = None
        for aff, mv in parts:
            dev = aff.device
            w = torch.where(aff >= kth.to(dev), torch.exp(aff - gmax.to(dev)),
                            torch.zeros_like(aff))
            a = torch.matmul(w.to(mv.dtype).to(torch.float32),
                             mv.to(torch.float32)).to(dst)
            s = w.sum(dim=-1, keepdim=True).to(dst)
            acc, wsum = (a, s) if acc is None else (acc + a, wsum + s)
        out.append(acc / wsum)
    if not gather:
        return out
    return out[0] if len(out) == 1 else torch.cat(out, dim=0)


def object_sharded_memory_read(mesh: Mesh, mem_k: np.ndarray,
                               mem_v: np.ndarray, query_k: torch.Tensor,
                               top_k: Optional[int] = 50,
                               valid: Optional[torch.Tensor] = None,
                               axis: str = "object", km=None,
                               query_hw=None, backend: str = "auto",
                               n_refine: int = 0, gather: bool = True):
    """Memory read with only the object axis sharded: mem_k/mem_v grids
    over `mesh` with K over `axis`. Per-object reads are independent, so
    each object shard's device runs `ops/memory_read.memory_read` on its
    objects (on a CUDA device, `backend="auto"` launches the read
    kernels there) and only the (K/D, N, CV) readouts travel, to
    query_k's device. Returns the (K, N, CV) readout there; gather=False:
    the list of the object shards' readouts, each left on its shard's
    device (the object-sharded session decodes it there)."""
    from mivos_tpu_torch.ops.memory_read import memory_read

    home = query_k.device
    queries: Dict[torch.device, torch.Tensor] = {}
    masks: Dict[torch.device, torch.Tensor] = {}
    out = []
    for (pos,) in lead_positions(mesh, None, axis):
        mk, mv = mem_k[pos], mem_v[pos]
        dev = mk.device
        vl = None if valid is None else _on(masks, valid, dev)
        with device_scope(dev):
            out.append(memory_read(mk, mv, _on(queries, query_k, dev),
                                   top_k=top_k, valid=vl, km=km,
                                   query_hw=query_hw, backend=backend,
                                   n_refine=n_refine))
    if not gather:
        return out
    return torch.cat([r.to(home) for r in out], dim=0)


def sharded_bank_write(mesh: Mesh, bank: np.ndarray, data: torch.Tensor,
                       row: int, axis: str = "data") -> np.ndarray:
    """Write one frame's (K, n, C) rows at global row offset `row` into a
    position-sharded bank grid (equal shards) in place, without
    gathering it, and return the grid. Exactly one position shard owns
    the rows: the session keeps whole slots per shard (capacity a
    multiple of the axis size, rows a multiple of n). Every copy of that
    shard is written. An object-sharded session keeps one such bank per
    object shard (core/inference.py), so the write takes no object
    axis."""
    n = data.shape[1]
    local_m = bank.reshape(-1)[0].shape[1]
    owner, loc = divmod(int(row), local_m)
    if not (0 <= owner < mesh.shape[axis] and loc + n <= local_m):
        raise ValueError(f"rows [{row}, {row + n}) are not inside one shard "
                         f"of {local_m} rows")
    a = mesh.axis_names.index(axis)
    for pos in np.ndindex(bank.shape):
        if pos[a] == owner:
            shard = bank[pos]
            shard[:, loc:loc + n] = data.to(shard.device, shard.dtype)
    return bank
