"""HTTP serving entry point: interactive VOS sessions over the wire
(counterpart of serve.py). Create a session per video, send label-map
interactions, download propagated masks (API: serve/server.py).
Sessions are pinned round-robin across the host's CUDA devices.

  python -m mivos_tpu_torch.serve --prop_model saves/propagation_model.pth \
      --fusion_model saves/fusion.pth --port 8080 [--device cuda|cuda:N|cpu]

--device cuda (the default) serves on every CUDA device and fails
without one. SIGINT or SIGTERM drains: in-flight interactions finish
(up to --drain_timeout), new work gets 503, then the process exits.

Client sketch:
  import io, json, numpy as np, urllib.request
  buf = io.BytesIO(); np.savez_compressed(buf, video=video_uint8)
  r = urllib.request.urlopen(urllib.request.Request(
      f"{base}/v1/sessions?num_objects=2", buf.getvalue(), method="POST"))
  sid = json.load(r)["session_id"]
  buf = io.BytesIO(); np.savez_compressed(buf, labels=lab, frame=0)
  r = urllib.request.urlopen(urllib.request.Request(
      f"{base}/v1/sessions/{sid}/interact", buf.getvalue(), method="POST"))
  masks = np.load(io.BytesIO(r.read()))["masks"]
"""
import argparse
import signal
import threading

import torch

from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.serve.server import (SessionManager, make_server,
                                          shutdown_gracefully)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--prop_model", default="saves/propagation_model.pth")
    p.add_argument("--fusion_model", default="saves/fusion.pth")
    p.add_argument("--no_fusion", action="store_true",
                   help="serve propagation only (skip the fusion net)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--top_k", type=int, default=50)
    p.add_argument("--mem_freq", type=int, default=5)
    p.add_argument("--max_sessions", type=int, default=8)
    p.add_argument("--create_timeout", type=float, default=5.0,
                   help="seconds an HTTP create waits at capacity "
                        "before 503 (each queued create pins a handler "
                        "thread -- keep this short)")
    p.add_argument("--drain_timeout", type=float, default=30.0,
                   help="graceful-shutdown budget: seconds to wait for "
                        "in-flight interactions on SIGINT/SIGTERM")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"),
                   help="conv-tower and memory-bank compute dtype")
    p.add_argument("--warm", default=None, metavar="T,H,W,K",
                   help="run a throwaway session of this shape before "
                        "binding the port (e.g. 100,480,854,3): the "
                        "kernel build, lazy CUDA module loading and "
                        "cuDNN plans are paid before the first user")
    p.add_argument("--warm_rounds", type=int, default=1,
                   help="interactions of the warm session")
    p.add_argument("--device", default="cuda",
                   help="cuda (every CUDA device), cuda:N or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    devices = None if args.device == "cuda" else [torch.device(args.device)]
    dtype = getattr(torch, args.dtype)
    prop_net = load_reference_pth(PropagationNetwork(dtype=dtype),
                                  args.prop_model)
    fuse_net = None
    if not args.no_fusion:
        fuse_net = load_reference_pth(FusionNet(dtype=dtype),
                                      args.fusion_model)
    mgr = SessionManager(prop_net, fuse_net,
                         mem=MemoryConfig(top_k=args.top_k,
                                          mem_freq=args.mem_freq),
                         devices=devices, max_sessions=args.max_sessions)
    if args.warm:
        t, h, w, k = (int(x) for x in args.warm.split(","))
        print(f"warming a (T={t}, {h}x{w}, K={k}) session...", flush=True)
        dt = mgr.warm(t, h, w, k, interactions=args.warm_rounds)
        print(f"warm done in {dt:.1f}s", flush=True)

    srv = make_server(mgr, host=args.host, port=args.port, verbose=True,
                      create_timeout=args.create_timeout)
    print(f"serving on http://{srv.server_address[0]}:"
          f"{srv.server_address[1]} ({len(mgr.devices)} device(s): "
          f"{', '.join(map(str, mgr.devices))})", flush=True)
    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    stop.wait()
    # Graceful drain: stop accepting, let in-flight interactions
    # finish (up to --drain_timeout), free sessions, close the socket.
    print("draining...", flush=True)
    drained = shutdown_gracefully(srv, timeout=args.drain_timeout)
    print(f"shutdown complete (drained={drained})", flush=True)


if __name__ == "__main__":
    main()
