"""Batching host input pipeline (counterpart of mivos_tpu/data/loader.py;
reference train.py:96-98, DataLoader with a DistributedSampler).

  ShardedSampler  a deterministic permutation per (seed, epoch), sliced
                  per shard (the DistributedSampler contract), in the JAX
                  sampler's order.
  Loader          torch's DataLoader over the sampler: worker processes
                  run dataset.__getitem__, batches are collated
                  batch-major and, with pin_memory, land in pinned host
                  memory, so the trainer's copy to the card is
                  asynchronous. Each sample seeds its own generator from
                  (seed, epoch, idx), so batches do not depend on the
                  number of workers.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch.utils.data import DataLoader


class ShardedSampler:
    """Deterministic, sharded index sampler (reference: torch
    DistributedSampler, train.py:96): a shuffled permutation of range(n)
    per (seed, epoch), padded from its start so that every shard gets
    the same count, shard s taking every num_shards-th index from s."""

    def __init__(self, n: int, num_shards: int = 1, shard: int = 0,
                 seed: int = 0):
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} of {num_shards}")
        self.n, self.num_shards, self.shard = n, num_shards, shard
        self.seed, self.epoch = seed, 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        order = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch])).permutation(self.n)
        order = np.concatenate([order, order[:(-self.n) % self.num_shards]])
        return iter(order[self.shard::self.num_shards].tolist())

    def __len__(self) -> int:
        return (self.n + self.num_shards - 1) // self.num_shards


def collate(samples: Sequence[Dict]) -> Dict:
    """Stack numeric fields batch-major into tensors; 'info' dicts become
    a list."""
    out: Dict = {}
    for key in samples[0]:
        if key == "info":
            out[key] = [s[key] for s in samples]
        else:
            out[key] = torch.from_numpy(np.stack([np.asarray(s[key])
                                                  for s in samples]))
    return out


class Loader:
    """Batches of a random-access dataset (with __getitem__, __len__ and
    optionally set_epoch) in the sampler's order, a short last batch
    dropped. Each iteration starts its workers anew, so the epoch that
    set_epoch gives the dataset reaches them."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[ShardedSampler] = None,
                 num_workers: int = 8, pin_memory: bool = False):
        self.dataset = dataset
        self.sampler = sampler or ShardedSampler(len(dataset))
        self.loader = DataLoader(dataset, batch_size, sampler=self.sampler,
                                 collate_fn=collate, num_workers=num_workers,
                                 pin_memory=pin_memory, drop_last=True)

    def set_epoch(self, epoch: int) -> None:
        self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self) -> Iterator[Dict]:
        # A generator, so that close() on an iterator left early drops
        # the DataLoader's iterator and with it its workers.
        yield from self.loader
