"""Synthetic clips from a seed, made on the device.

A clip is T frames of H x W uint8 RGB, as a decoded video gives them,
and its ground-truth label map per frame (0 background, 1..K objects).
The background is a smooth colour texture that drifts; each object is a
textured ellipse that moves on a straight path, reflected at the
frame's edges, with later objects in front. Every number comes from one
`torch.Generator` on the device, seeded by the run's seed and the clip's
index, and the frames are made in a few whole-clip tensor operations.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _texture(gen, c: int, h: int, w: int, cell: int, device) -> torch.Tensor:
    """(c, h, w) smooth noise in [0, 1]: a coarse normal grid upsampled."""
    coarse = torch.randn((1, c, h // cell + 2, w // cell + 2), generator=gen,
                         device=device)
    up = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    return torch.sigmoid(up[0])


def _bounce(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """x reflected into [lo, hi]."""
    span = hi - lo
    y = torch.remainder(x - lo, 2 * span)
    return lo + torch.where(y > span, 2 * span - y, y)


def make_clip(seed: int, index: int, t: int, h: int, w: int, k: int,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """((t, h, w, 3) uint8 frames, (t, h, w) uint8 labels) of clip
    `index` under `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1000003 + index) % (1 << 63))
    rand = lambda *s: torch.rand(s, generator=gen, device=device)  # noqa: E731
    bg = _texture(gen, 3, h, w, 24, device)                       # (3, h, w)
    drift = (rand(2) - 0.5) * 0.02 * min(h, w)                    # px a frame
    ts = torch.arange(t, device=device, dtype=torch.float32)
    ys = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    # The background drifts by a whole-pixel roll per frame (cheap, smooth).
    shifts = (ts[:, None] * drift[None]).round().long().cpu().tolist()
    frames = torch.stack([torch.roll(bg, (int(dy), int(dx)), (1, 2))
                          for dy, dx in shifts])                  # (t, 3, h, w)
    labels = torch.zeros((t, h, w), dtype=torch.uint8, device=device)
    for obj in range(1, k + 1):
        ry = (0.10 + 0.15 * rand(1)) * h
        rx = (0.08 + 0.12 * rand(1)) * w
        cy0, cx0 = rand(1) * h, rand(1) * w
        vy, vx = (rand(1) - 0.5) * 0.03 * h, (rand(1) - 0.5) * 0.03 * w
        cy = _bounce(cy0 + vy * ts, 0.0, float(h)).view(t, 1, 1)
        cx = _bounce(cx0 + vx * ts, 0.0, float(w)).view(t, 1, 1)
        inside = ((ys - cy) / ry) ** 2 + ((xs - cx) / rx) ** 2 <= 1.0
        colour = _texture(gen, 3, h, w, 12, device) * 0.5 + rand(3, 1, 1) * 0.5
        frames = torch.where(inside[:, None], colour[None], frames)
        labels[inside] = obj
    return (frames * 255).round().clamp(0, 255).to(torch.uint8).permute(
        0, 2, 3, 1).contiguous(), labels


def interaction_mask(labels: torch.Tensor, k: int) -> torch.Tensor:
    """(h, w) label map -> (K+1, h, w, 1) float32 hard probabilities,
    background first: an annotator's mask of one frame."""
    ids = torch.arange(k + 1, device=labels.device, dtype=labels.dtype)
    return (labels[None] == ids.view(-1, 1, 1)).to(torch.float32)[..., None]
