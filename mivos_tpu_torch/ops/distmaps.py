"""Click distance maps for interactive segmentation, NCHW
(counterpart of mivos_tpu/ops/distmaps.py; reference
fbrs/model/ops.py:55-76).

Per pixel, the minimum over a group's clicks of the normalized squared
euclidean distance, then tanh(2*sqrt(d)), in fp32. The click tensor
follows the reference predictor contract (fbrs/inference/predictors/
base.py:76-94): (B, 2P, 2) rows of (y, x), first P positive then P
negative, unused rows (-1, -1). Such a row gives distance 1e6, so the
result does not depend on P beyond the clicks it holds.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def dist_maps(points: torch.Tensor, height: int, width: int,
              norm_radius: float) -> torch.Tensor:
    """points: (B, 2P, 2) float (y, x); a row is unused where
    max(y, x) < 0. Returns (B, 2, H, W): channel 0 from the first P
    (positive) rows, channel 1 from the last P (negative) rows."""
    b, p2, _ = points.shape
    points = points.to(torch.float32)
    rows = torch.arange(height, dtype=torch.float32, device=points.device)
    cols = torch.arange(width, dtype=torch.float32, device=points.device)
    dy = (rows[None, None, :, None]
          - points[..., 0, None, None]) / norm_radius  # (B, 2P, H, 1)
    dx = (cols[None, None, None, :]
          - points[..., 1, None, None]) / norm_radius  # (B, 2P, 1, W)
    d2 = dy * dy + dx * dx                                        # (B, 2P, H, W)
    unused = points.amax(dim=-1) < 0                              # (B, 2P)
    d2 = torch.where(unused[..., None, None], 1e6, d2)
    d2 = d2.view(b, 2, p2 // 2, height, width).amin(dim=2)
    return torch.tanh(2.0 * torch.sqrt(d2))


def pad_points(pos: Sequence[Tuple[float, float]],
               neg: Sequence[Tuple[float, float]], max_points: int,
               device: torch.device | str = "cuda") -> torch.Tensor:
    """pos/neg lists of (y, x) -> (1, 2*max_points, 2) fp32 tensor on
    `device`, unused rows (-1, -1) (reference base.py:85-93)."""
    out = np.full((1, 2 * max_points, 2), -1.0, np.float32)
    for i, (y, x) in enumerate(list(pos)[:max_points]):
        out[0, i] = (y, x)
    for i, (y, x) in enumerate(list(neg)[:max_points]):
        out[0, max_points + i] = (y, x)
    return torch.from_numpy(out).to(device)
