"""Batch normalization with statistics synchronized over processes
(counterpart of mivos_tpu/ops/syncbn.py; it replaces the reference's
C++/CUDA SyncBN extension, fbrs/model/syncbn/).

Each rank reduces its batch to the per-channel (E[x], E[x^2]), the two
are averaged over the ranks with one all-reduce, and the variance is
the biased E[x^2] - E[x]^2, as in JAX and torch's batch-norm training.
The all-reduce is `torch.distributed.nn.functional.all_reduce`, which
has a backward (the sum of the ranks' gradients), so autograd covers
the synchronized form; the in-place `dist.all_reduce` has none.

Statistics are synchronized when a process group is up (over `group`,
None = the default group), and are one process's own otherwise, as
torch.nn.SyncBatchNorm's are. Ranks must hold equal batches: the mean
of the ranks' means is the mean over the whole batch only then.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _synced(group) -> bool:
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size(group) > 1)


def batch_norm_stats(x: torch.Tensor, group=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased var) of NCHW (or NC) x over the batch
    and spatial dims, over every rank of `group` when synchronized."""
    dims = (0,) + tuple(range(2, x.ndim))
    stats = torch.stack([x.mean(dim=dims), x.square().mean(dim=dims)])
    if _synced(group):
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        stats = all_reduce(stats, group=group or dist.group.WORLD) \
            / dist.get_world_size(group)
    mean, sq = stats[0], stats[1]
    return mean, sq - mean.square()


def sync_batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    group=None, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Normalize NCHW x with the synchronized batch statistics. Returns
    (y, (mean, var)); the statistics feed the caller's running averages."""
    mean, var = batch_norm_stats(x, group)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var + eps)
    y = (x - mean.view(shape)) * (inv * weight).view(shape) + bias.view(shape)
    return y, (mean, var)
