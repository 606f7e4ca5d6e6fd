"""How soon a client sees the first masks of a long interaction through
`GET /v1/sessions/<id>/progress`, against the whole round (counterpart of
scripts/serve_streaming_bench.py).

Protocol:
  1. A SessionManager over a bf16 PropagationNetwork(top_k=50) (random
     init, seed 0; no fusion net, as in the JAX script) on one device,
     max_sessions 2, MemoryConfig(top_k=50); `warm(300, 480, 854, 2,
     interactions=2)`.
  2. One 300-frame 480x854 session (uint8 noise, RandomState(7)), K = 2.
     At about 22 MB of bf16 query features a frame, 300 frames exceed
     `query_cache_bytes` (3 GiB), so the session runs with the query
     cache off, as the JAX session decides; `qcache_enabled` says which
     mode ran. Two rounds, frames 0 and 299 (labels from RandomState(10)
     and (11)): `interact` runs in a thread while this one polls
     `progress()` every 25 ms and notes when each new chunk of frames is
     visible.
  3. During a third round from frame 150, `GET /progress` round trips
     through a real ThreadingHTTPServer, npz encoding included.

Prints one JSON line: the JAX script's keys (each round's time to the
first masks, chunk arrivals and wall, up to five HTTP samples) and
`qcache_enabled` and `device`. On the card the rounds' kernel launches
must equal their reads times the launches per read.

Usage: python -m mivos_tpu_torch.serve_streaming_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import io
import json
import threading
import time
import urllib.request
from typing import Dict, List, Tuple

import numpy as np

from mivos_tpu_torch import bench
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.long_video_bench import make_video
from mivos_tpu_torch.serve import SessionManager, make_server
from mivos_tpu_torch.utils.measure import LaunchTally, device_info, reads_of, require_device

T, H, W, K = 300, 480, 854, 2
POLL_S, HTTP_POLL_S = 0.025, 0.05


def labels_of(seed: int, h: int = H, w: int = W, k: int = K) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, k + 1, (h, w)).astype(np.uint8)


def make_manager(dev, prop=None) -> SessionManager:
    """The manager over `prop` (default: bench's random-init net); it
    serves a prepared copy."""
    prop = prop if prop is not None else bench.make_nets(dev, fusion=False)[0]
    return SessionManager(prop, None, mem=MemoryConfig(top_k=50), devices=[dev],
                          max_sessions=2)


def timed_round(mgr: SessionManager, sid: str, labels: np.ndarray, frame: int,
                poll_s: float = POLL_S) -> Tuple[np.ndarray, List, float]:
    """One interact in a thread, progress() polled every poll_s until it
    ends. Returns (its masks, arrivals [(seconds, frames visible)], wall
    seconds)."""
    t0 = time.monotonic()
    out = {}

    def run():
        out["masks"] = mgr.interact(sid, labels, frame)

    th = threading.Thread(target=run)
    th.start()
    arrivals, seen = [], 0
    while th.is_alive():
        p = mgr.progress(sid)
        n = len(p["frames"])
        if n > seen and not p["done"]:
            arrivals.append((time.monotonic() - t0, n))
            seen = n
        # A busy loop would contend the interpreter lock with the
        # interacting thread it measures.
        time.sleep(poll_s)
    th.join()
    return out["masks"], arrivals, time.monotonic() - t0


def http_samples(mgr: SessionManager, sid: str, labels: np.ndarray, frame: int) -> List:
    """GET /progress round trips while interact(labels, frame) runs."""
    srv = make_server(mgr, port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/v1/sessions/{sid}/progress"
    samples, out = [], {}

    def run():
        out["masks"] = mgr.interact(sid, labels, frame)

    th = threading.Thread(target=run)
    th.start()
    try:
        while th.is_alive():
            t1 = time.monotonic()
            with urllib.request.urlopen(url, timeout=60) as r:
                body = r.read()
            d = np.load(io.BytesIO(body))
            if len(d["frames"]) and not bool(d["done"]):
                samples.append({"rtt_s": time.monotonic() - t1,
                                "frames": int(len(d["frames"])),
                                "npz_bytes": len(body)})
            time.sleep(HTTP_POLL_S)
    finally:
        th.join()
        srv.shutdown()
        srv.server_close()
    return samples


def run(mgr: SessionManager, dev, t: int = T, h: int = H, w: int = W, k: int = K) -> Dict:
    """Warm-up, the two polled rounds and the HTTP round on one session."""
    warm_s = mgr.warm(t, h, w, k, interactions=2)
    print(f"warm: {warm_s:.1f} s", flush=True)
    video = make_video(7, t, h, w)
    t0 = time.monotonic()
    sid = mgr.create(video, k)
    create_s = time.monotonic() - t0
    core = mgr._get(sid).core
    tally = LaunchTally(dev)
    rounds = []
    try:
        for i, frame in enumerate([0, t - 1]):
            with tally.window(reads_of(core, frame), core.bank.dtype, core.prop_net.read_refine):
                masks, arrivals, wall = timed_round(mgr, sid, labels_of(10 + i, h, w, k), frame)
            if masks.shape != (t, h, w):
                raise RuntimeError(f"interact returned masks of {masks.shape}")
            rounds.append({"frame": frame, "wall_s": wall,
                           "t_first_masks_s": arrivals[0][0] if arrivals else None,
                           "arrivals": arrivals})
            print(f"round {i}: first masks at {arrivals[0] if arrivals else '-'}, "
                  f"wall {wall:.3f} s, {len(arrivals)} chunk arrivals", flush=True)
        with tally.window(reads_of(core, t // 2), core.bank.dtype, core.prop_net.read_refine):
            samples = http_samples(mgr, sid, labels_of(12, h, w, k), t // 2)
        qcache = core._qcache_enabled
    finally:
        mgr.close(sid)
    return {"frames": t, "hw": [h, w], "objects": k, "warm_s": warm_s,
            "create_s": create_s, "rounds": rounds,
            "http_progress_samples": samples[:5], "qcache_enabled": qcache,
            "launches": tally.check("serve streaming rounds"), "reads": tally.reads}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    rep = run(make_manager(dev), dev)
    rep["device"] = device_info(dev)
    print(json.dumps({key: v for key, v in rep.items() if key not in ("launches", "reads")}),
          flush=True)
    return rep


if __name__ == "__main__":
    main()
