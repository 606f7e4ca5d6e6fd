"""Same-process A/B of the slim decoder (dec_width=0.5) against the
reference-width decoder on the headline bench protocol (counterpart of
scripts/slim_decoder_bench.py).

`PropagationNetwork(dec_width=0.5)` halves every internal decoder
channel; the published .pth decoders need width 1.0, so the slim decoder
is an opt-in for training from scratch. This measures speed only: random
init (seed 0), no fusion.

Protocol: bench's (60 frames 480x854, K = 3, bf16, interact on frame 0,
a full forward pass, frames and masks on the card before the clock),
for each width one warm session and then SESSIONS fresh sessions, masks
seeded per width (10 x width + session; the warm one + 99). Both widths
run in one process, full width first, so a drift of the host's load
during the run counts against the slim decoder. Prints one JSON line:
each width's frames/s, their medians and the slim/reference ratio, and
the device. On the card every session's kernel launches must equal its
reads times the launches per read.

--smoke: 12 frames of 64x96, K = 2, one session per width (wiring).

Usage: python -m mivos_tpu_torch.slim_decoder_bench [--smoke] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict

from mivos_tpu_torch import bench
from mivos_tpu_torch.utils.measure import (LaunchTally, device_info, interaction_mask,
                                           median, require_device)

SESSIONS = 3
WIDTHS = (1.0, 0.5)


def run_width(width: float, images, k: int, sessions: int, dev, tally: LaunchTally):
    prop, _ = bench.make_nets(dev, dec_width=width, fusion=False)
    h, w = images.shape[1:3]
    seed0 = int(width * 10)
    masks = [interaction_mask(seed0 + s, h, w, k, dev) for s in range(sessions)]
    warm = interaction_mask(seed0 + 99, h, w, k, dev)
    fps = bench.sessions(prop, None, images, k, masks, warm, dev, tally)
    for s, x in enumerate(fps):
        print(f"width {width}: session {s} {x:.2f} frames/s", flush=True)
    return fps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="tiny shapes, 1 session")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    t, h, w, k = (12, 64, 96, 2) if args.smoke else (bench.T, bench.RH, bench.RW, bench.K)
    sessions = 1 if args.smoke else SESSIONS
    images = bench.video(dev, t, h, w)
    tally = LaunchTally(dev)
    out = {str(width): run_width(width, images, k, sessions, dev, tally) for width in WIDTHS}
    launches = tally.check("slim decoder A/B")
    med = {w: median(v) for w, v in out.items()}
    rep = {"protocol": f"bench ({t}f {h}x{w} K={k}, interact@0)",
           "sessions_per_config": sessions, "fps": out, "median_fps": med, "speedup_slim_vs_ref": med["0.5"] / med["1.0"],
           "device": device_info(dev)}
    print(json.dumps(rep), flush=True)
    return dict(rep, launches=launches, reads=tally.reads)


if __name__ == "__main__":
    main()
