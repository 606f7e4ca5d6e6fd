"""Run a function on the ranks of a fresh process group, in spawned
processes (for the multi-device dry run and the data-parallel checks;
training itself starts its ranks with torchrun).

The ranks are spawned, not forked: the caller may hold threads or a
CUDA context, and a spawned child imports only what the function's
module imports. They meet through a FileStore in a new temporary
directory rather than a TCP port, which concurrent callers could
collide on. Every wait is bounded, so a rank that dies or hangs fails
the call instead of blocking it.
"""
from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(fn: Callable, rank: int, world: int, backend: str,
               store_path: str, args: Sequence, timeout_s: float,
               results) -> None:
    try:
        # The ranks share the host's cores.
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              backend: str = "gloo", timeout_s: float = 600.0) -> List[Any]:
    """fn(rank, world, *args) on each of `world` spawned ranks joined in
    one process group (`backend`); fn and args must pickle (fn a
    module-level function) and so must its result. Returns the results
    in rank order. Raises RuntimeError with the rank's traceback when a
    rank fails, or when the ranks are not done within timeout_s; ranks
    left running are then killed."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, backend,
                                   os.path.join(tmp, "store"), tuple(args),
                                   timeout_s, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world:
                try:
                    rank, ok, value = results.get(
                        timeout=max(deadline - time.monotonic(), 0.1))
                except queue.Empty:
                    raise RuntimeError(
                        f"ranks {sorted(set(range(world)) - set(got))} of "
                        f"{world} not done within {timeout_s} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
                got[rank] = value
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return [got[r] for r in range(world)]
