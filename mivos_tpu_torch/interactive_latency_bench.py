"""The two response times of the GUI loop on the card (counterpart of
scripts/interactive_latency_bench.py):

  f-BRS click -> mask: the default FBRSDeepLabModel (ResNet-50, ch 256),
    random init (seed 0), f-BRS-B with ZoomIn 480 / expansion 1.4 and
    L-BFGS maxiter 20, flip-averaged prediction, on a 480x854 frame;
    8 distinct clicks (positive but every third).
  S2M scribble -> mask: bf16 S2MNetwork, random init (seed 1), K = 3,
    hard aggregate, on the padded 480x864 frame; 6 distinct strokes.

Each call is timed on the host clock with the card synchronised before
and after. The JAX script took the median of the calls under 1 s (the
rest were compiles); here the first call of each (cuDNN's first use of
its shapes) is reported on its own and the median is of the others.

Usage: python -m mivos_tpu_torch.interactive_latency_bench [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

import numpy as np
import torch

from mivos_tpu_torch.interactive.clicker import Click, Clicker
from mivos_tpu_torch.interactive.fbrs_predictor import get_predictor
from mivos_tpu_torch.interactive.s2m_controller import S2MController
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.utils.measure import device_info, median, require_device, wall
from mivos_tpu_torch.utils.tensor import pad_divide_by

H, W, K = 480, 854, 3
FBRS_CLICKS, S2M_STROKES = 8, 6
ZOOM_IN = {"target_size": 480, "expansion_ratio": 1.4}


def make_fbrs_net() -> torch.nn.Module:
    return init_params(FBRSDeepLabModel(), torch.Generator().manual_seed(0))


def bench_fbrs(dev, n_iter: int) -> List[float]:
    pred = get_predictor(make_fbrs_net(), "f-BRS-B", zoom_in_params=ZOOM_IN, device=dev)
    rng = np.random.RandomState(0)
    pred.set_input_image(rng.rand(H, W, 3).astype(np.float32))
    clicker = Clicker()
    lat = []
    for i in range(n_iter):
        y = 100.0 + 17.0 * i + rng.rand()      # distinct clicks
        x = 200.0 + 23.0 * i + rng.rand()
        clicker.add_click(Click(i % 3 != 2, (y, x)))
        _, dt = wall(lambda: pred.get_prediction(clicker), dev)
        lat.append(dt)
    return lat


def bench_s2m(dev, n_iter: int) -> List[float]:
    net = init_params(S2MNetwork(dtype=torch.bfloat16), torch.Generator().manual_seed(1))
    ctrl = S2MController(net, K, ignore_class=255, device=dev)
    rng = np.random.RandomState(1)
    # The controller takes the session's padded frame; scribbles are raw.
    image = pad_divide_by(torch.from_numpy(rng.rand(H, W, 3).astype(np.float32)).to(dev))[0]
    lat = []
    for i in range(n_iter):
        scr = np.full((H, W), 255, np.int32)
        r0 = 40 + 30 * i
        scr[r0:r0 + 6, 100:700] = 1 + (i % K)   # a distinct stroke a round
        scr[r0 + 60:r0 + 66, 100:700] = 0
        prev = np.zeros(image.shape[:2], np.uint8)   # padded grid
        _, dt = wall(lambda: ctrl.interact(image, prev, scr, aggregate_hard=True), dev)
        lat.append(dt)
    return lat


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    fbrs = bench_fbrs(dev, FBRS_CLICKS)
    print("fbrs click latencies:", [round(t, 4) for t in fbrs], flush=True)
    s2m = bench_s2m(dev, S2M_STROKES)
    print("s2m scribble latencies:", [round(t, 4) for t in s2m], flush=True)
    rep = {"fbrs_click_median_ms": 1e3 * median(fbrs[1:]),
           "s2m_scribble_median_ms": 1e3 * median(s2m[1:]),
           "fbrs_first_ms": 1e3 * fbrs[0], "s2m_first_ms": 1e3 * s2m[0],
           "hw": [H, W], "objects": K, "device": device_info(dev)}
    print(json.dumps(rep), flush=True)
    return dict(rep, fbrs_s=fbrs, s2m_s=s2m)


if __name__ == "__main__":
    main()
