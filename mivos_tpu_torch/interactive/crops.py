"""Tiled inference over overlapping crops, NCHW (counterpart of
mivos_tpu/interactive/crops.py; reference
fbrs/inference/transforms/crops.py:10-90).

For frames larger than the network's window, the prediction runs on
overlapping fixed-size crops and each pixel averages the crops that
cover it. Clicks are shifted into every crop's frame; clicks outside a
crop still contribute their distance field, as in the reference's
closed-form DistMaps.

Every crop has the same (crop_h, crop_w), so all crops and their
horizontal flips go through one batched forward, and the paste back is
one count-normalized sum.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from mivos_tpu_torch.interactive.clicker import Click
from mivos_tpu_torch.interactive.fbrs_predictor import flip_average
from mivos_tpu_torch.ops.distmaps import pad_points


# Neighbouring crops overlap by at least this share of a crop, and the
# predictor passes at most this many clicks to the network (the JAX
# package's defaults, mivos_tpu/interactive/crops.py:32, 156).
MIN_OVERLAP, NET_CLICKS_LIMIT = 0.2, 8


def get_offsets(length: int, crop_size: int) -> List[int]:
    """Crop start offsets covering `length` with at least MIN_OVERLAP
    overlap (reference crops.py:77-90)."""
    if length == crop_size:
        return [0]
    n = (length / crop_size - MIN_OVERLAP) / (1 - MIN_OVERLAP)
    n = math.ceil(n)
    overlap_ratio = (n - length / crop_size) / (n - 1)
    overlap_width = int(crop_size * overlap_ratio)
    offsets = [0]
    for _ in range(1, n):
        new_offset = offsets[-1] + crop_size - overlap_width
        if new_offset + crop_size > length:
            new_offset = length - crop_size
        offsets.append(new_offset)
    return offsets


class Crops:
    """Overlapping-crop transform (reference crops.py:10-75).

    transform: (1, 3, H, W) image and clicks -> (N, 3, ch, cw) crops and
    one shifted click list per crop. inv_transform: (N, 1, ch, cw) crop
    probabilities -> (1, 1, H, W), each pixel the mean of its crops. A
    frame smaller than the window passes through as one crop."""

    def __init__(self, crop_size: Tuple[int, int] = (320, 480)):
        self.crop_height, self.crop_width = crop_size
        self.reset()

    def reset(self):
        self.x_offsets: Optional[List[int]] = None
        self.y_offsets: Optional[List[int]] = None
        self._counts: Optional[torch.Tensor] = None

    @property
    def offsets(self) -> List[Tuple[int, int]]:
        return [(dy, dx) for dy in self.y_offsets for dx in self.x_offsets]

    def transform(self, image: torch.Tensor, clicks: List[Click]):
        h, w = image.shape[-2:]
        self._counts = None
        if h < self.crop_height or w < self.crop_width:
            return image, [clicks]

        self.x_offsets = get_offsets(w, self.crop_width)
        self.y_offsets = get_offsets(h, self.crop_height)
        counts = image.new_zeros((h, w))
        crops, clicks_lists = [], []
        for dy, dx in self.offsets:
            counts[dy:dy + self.crop_height, dx:dx + self.crop_width] += 1
            crops.append(image[0, :, dy:dy + self.crop_height,
                               dx:dx + self.crop_width])
            clicks_lists.append([
                Click(c.is_positive, (c.coords[0] - dy, c.coords[1] - dx))
                for c in clicks])
        self._counts = counts
        return torch.stack(crops), clicks_lists

    def inv_transform(self, prob: torch.Tensor) -> torch.Tensor:
        """prob: (N, C, ch, cw) per-crop maps (or the (1, C, H, W) map of a
        frame smaller than the window, returned as it is)."""
        if self._counts is None:
            return prob
        out = prob.new_zeros((1, prob.shape[1]) + tuple(self._counts.shape))
        for p, (dy, dx) in zip(prob, self.offsets):
            out[0, :, dy:dy + self.crop_height, dx:dx + self.crop_width] += p
        return out / self._counts

    def get_state(self):
        return (self.x_offsets, self.y_offsets, self._counts)

    def set_state(self, state):
        self.x_offsets, self.y_offsets, self._counts = state


class TiledPredictor:
    """A NoC-harness predictor (set_input_image / get_prediction /
    get_states / set_states, as FeatureBRSPredictor) that runs the full
    network on overlapping crops: all crops and their flips in one
    batched forward, the flip-averaged probabilities pasted back with
    count normalization."""

    def __init__(self, net, crop_size: Tuple[int, int] = (320, 480),
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.crops = Crops(crop_size)
        self.original_image = None

    def set_input_image(self, image) -> None:
        """image: (H, W, 3) normalized, numpy or tensor."""
        image = torch.as_tensor(image).to(self.device, torch.float32)
        self.original_image = image.permute(2, 0, 1)[None]
        self.crops.reset()

    def _points_nd(self, clicks_lists: Sequence[List[Click]]) -> torch.Tensor:
        """(N, 2P, 2) points of every crop's clicks, P the most positive or
        negative clicks of any crop."""
        pos = [[c.coords for c in cl[:NET_CLICKS_LIMIT] if c.is_positive]
               for cl in clicks_lists]
        neg = [[c.coords for c in cl[:NET_CLICKS_LIMIT] if not c.is_positive]
               for cl in clicks_lists]
        p = max(max(map(len, pos)), max(map(len, neg)), 1)
        return torch.cat([pad_points(ps, ns, p, self.device)
                          for ps, ns in zip(pos, neg)])

    @torch.no_grad()
    def get_prediction(self, clicker) -> torch.Tensor:
        """-> (H, W) probability map of the full frame, on the device."""
        crops, clicks_lists = self.crops.transform(self.original_image,
                                                   clicker.get_clicks())
        w = crops.shape[-1]
        points = self._points_nd(clicks_lists)
        # Mirror x for every real click, including one outside the crop
        # whose shifted x is negative. Only the (-1, -1) padding keeps its
        # coordinates; a real click up and left of a crop has the same
        # encoding and drops out of both halves, as in the JAX package.
        is_click = (points[..., 0] >= 0) | (points[..., 1] >= 0)
        fpoints = points.clone()
        fpoints[..., 1] = torch.where(is_click, w - 1 - points[..., 1],
                                      points[..., 1])
        batch = torch.cat([crops, torch.flip(crops, dims=[-1])])
        prob = torch.sigmoid(self.net(batch, torch.cat([points, fpoints])))
        return self.crops.inv_transform(flip_average(prob))[0, 0]

    def get_states(self):
        return {"transform_states": self.crops.get_state()}

    def set_states(self, states):
        self.crops.set_state(states["transform_states"])
