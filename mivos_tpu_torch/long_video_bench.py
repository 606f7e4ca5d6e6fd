"""Long-video sessions on the card (counterpart of
scripts/long_video_bench.py).

Default: one 300-frame 480x854 session per query-cache configuration,
K = 2, bf16, four interaction rounds (frames 0, T-1, T/2, T/4),
after a 33-frame warm session per configuration. Configurations:

  eager  the cache on (the default): a pass's uncached frames are
         encoded in batched windows first and every later pass reuses
         them
  off    cache_queries=False: every frame of every pass encodes its own
         query features at batch 1

The JAX script's third configuration, `lazy` (round 1 encoded inside
the scan, the pre-encode from round 2), has no counterpart: the port
always pre-encodes, as the JAX default does. Prints one JSON line:
seconds per round, frames/s over the session and of the best round,
and each configuration's peak device memory.

--limit: the session at the bank's frame cap (the JAX `run_limit`):
960 frames of 480x854, K = 2, bf16, mem_freq=1, rounds at frames 0, 959
and 480. The forward pass's 959 would-be commits cross
bank_cap_frames=512, so the session thins them (every 2nd frame, a bank
of about 481 frames x 1620 rows), and the query cache stays off by its
byte cap (960 frames x ~22 MB). Asserts the cache is off, the bank stays
within bank_cap_frames and the labels are (960, 480, 854) with max <= K;
reports seconds per round, best-round frames/s, peak device memory, the
committed slots, the bank's rows (M) and the memory-read kernels'
launches against the reads the session made.

The video is JAX's: uint8 noise from numpy RandomState(77) (a seed per
configuration without --limit), made one frame at a time; the masks are
random label maps; the weights a random init from a seed.

Usage: python -m mivos_tpu_torch.long_video_bench [--limit] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, List

import numpy as np
import torch

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.utils.measure import peak_gib, reads_of, sync

T, H, W, K = 300, 480, 854, 2
LIMIT_T = 960
CONFIGS = {"eager": {}, "off": {"cache_queries": False}}


def mk_mask(seed: int, h: int = H, w: int = W, k: int = K) -> np.ndarray:
    """(k+1, h, w, 1) one-hot probabilities of a random label map."""
    labels = np.random.RandomState(seed).randint(0, k + 1, (h, w))
    return np.stack([(labels == i) for i in range(k + 1)]
                    ).astype(np.float32)[..., None]


def make_video(seed: int, t: int, h: int = H, w: int = W) -> np.ndarray:
    """(t, h, w, 3) uint8 noise, the JAX script's
    `(rng.rand(t, h, w, 3) * 255).astype(np.uint8)` made a frame at a time
    (the same numbers without a (t, h, w, 3) float64 array)."""
    rng = np.random.RandomState(seed)
    video = np.empty((t, h, w, 3), np.uint8)
    for i in range(t):
        video[i] = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    return video


def make_net(device, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
             dec_width: float = 1.0) -> PropagationNetwork:
    net = PropagationNetwork(top_k=50, dtype=dtype, dec_width=dec_width)
    return init_params(net, torch.Generator().manual_seed(seed)).to(device)


def run_config(prop: PropagationNetwork, kw: Dict, t: int, seed_base: int,
               rounds: int, device) -> Dict:
    """One multi-round session (inputs seeded per configuration, as in
    JAX): seconds per round and the peak device memory."""
    images = make_video(seed_base, t)
    masks = [mk_mask(seed_base + s) for s in range(1, rounds + 1)]
    idxs = [0, t - 1, t // 2, t // 4][:rounds]
    mem = MemoryConfig(top_k=50, mem_freq=5, query_cache_bytes=8 << 30, **kw)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    core = InferenceCore(prop, None, images, K, mem=mem, device=device)
    times = []
    for m, i in zip(masks, idxs):
        sync(device)
        t0 = time.perf_counter()
        core.interact(m, idx=i)
        sync(device)
        times.append(time.perf_counter() - t0)
    return {"rounds_s": times, "qcache_enabled": core._qcache_enabled,
            "peak_gib": peak_gib(device)}


def run_limit(prop: PropagationNetwork, device, t: int = LIMIT_T, hw=(H, W),
              k: int = K, rounds: int = 3, bank_cap_frames: int = 512,
              query_cache_bytes: int = 3 << 30, log=print) -> Dict:
    """The session at the bank's frame cap (module docstring): `rounds`
    of the interactions at frames 0, t-1 and t/2. The read kernels'
    counters are zeroed before round 1; on the card every counter must
    then equal the reads times its launches per read. Returns the
    report."""
    h, w = hw
    images = make_video(77, t, h, w)
    mem = MemoryConfig(top_k=50, mem_freq=1, bank_cap_frames=bank_cap_frames,
                       query_cache_bytes=query_cache_bytes)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    core = InferenceCore(prop, None, images, k, mem=mem, device=device)
    assert not core._qcache_enabled, (
        "the query cache should be off past its byte cap")
    report = {"frames": t, "hw": [h, w], "objects": k,
              "mem_freq_requested": 1, "bank_cap_frames": bank_cap_frames,
              "qcache_enabled": core._qcache_enabled}
    times: List[float] = []
    reads, slots, bank_rows = [], [], []
    cmr.reset_launch_counts()
    for s, idx in enumerate([0, t - 1, t // 2][:rounds]):
        reads.append(reads_of(core, idx))
        sync(device)
        t0 = time.perf_counter()
        out = core.interact(mk_mask(100 + s, h, w, k), idx=idx)
        sync(device)
        times.append(time.perf_counter() - t0)
        assert core.bank.cap <= bank_cap_frames, core.bank.cap
        slots.append(core.bank.num_slots)
        bank_rows.append(core.bank.num_slots * core.n16)
        log(f"round {s} (interact @{idx}): {times[-1]:.2f} s, "
            f"{reads[-1]} reads, committed slots {slots[-1]}")
    assert out.shape == (t, h, w) and out.max() <= k, (out.shape, out.max())
    launches = cmr.launch_counts()
    per_read = cmr.launches_per_read(prop.dtype, prop.read_refine)
    if torch.device(device).type == "cuda":
        for name, n in per_read.items():
            assert launches[name] == n * sum(reads), (name, launches[name], reads)
    report.update({
        "rounds_s": times, "best_round_fps": (t - 1) / min(times),
        "peak_gib": peak_gib(device),
        "bank_slots_committed": slots, "bank_M": bank_rows,
        # The largest read of a pass: the committed slots and the
        # transient one.
        "max_read_M": max(bank_rows) + core.n16,
        "n16": core.n16, "bank_cap": core.bank.cap,
        "reads": reads, "launches": launches})
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--limit", action="store_true",
                    help="the 960-frame session at the bank's frame cap only")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip(), flush=True)
    prop = make_net(dev, torch.bfloat16 if dev.type == "cuda" else torch.float32)
    if args.limit:
        rep = run_limit(prop, dev, log=lambda *a: print(*a, flush=True))
        print(json.dumps(rep), flush=True)
        return
    t, rounds = T, 4
    for i, (name, kw) in enumerate(CONFIGS.items()):
        t0 = time.perf_counter()
        run_config(prop, kw, 33, 1000 + 50 * i, rounds, dev)
        print(f"warmup {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    report = {}
    for i, (name, kw) in enumerate(CONFIGS.items()):
        report[name] = run_config(prop, kw, t, 2000 + 50 * i, rounds, dev)
        print(f"{name}: {report[name]}", flush=True)
    print(json.dumps({
        "rounds_s": {n: r["rounds_s"] for n, r in report.items()},
        "qcache_enabled": {n: r["qcache_enabled"] for n, r in report.items()},
        "session_fps": {n: rounds * (t - 1) / sum(r["rounds_s"])
                        for n, r in report.items()},
        "best_round_fps": {n: (t - 1) / min(r["rounds_s"])
                           for n, r in report.items()},
        "peak_gib": {n: r["peak_gib"] for n, r in report.items()},
        "frames": t, "hw": [H, W], "objects": K}), flush=True)


if __name__ == "__main__":
    main()
