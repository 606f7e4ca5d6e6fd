"""DAVIS interactive scribble utilities (counterpart of
mivos_tpu/interactive/scribbles.py; the subset of
davisinteractive.utils.scribbles the protocol needs).

Scribble JSON schema: {'scribbles': [frame_0_lines, frame_1_lines, ...]}
where each line is {'path': [[x, y], ...] in [0,1]^2, 'object_id': int}.

Without cv2: `draw_line` gives the pixels of cv2.line(thickness=1,
LINE_8), OpenCV's 8-connected Bresenham iterator drawn left to right.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def draw_line(img: np.ndarray, p0, p1, value: int) -> None:
    """Set the pixels of the segment p0 -> p1 ((x, y) integer points
    inside `img`) to `value`, as cv2.line(img, p0, p1, value, 1) does:
    the points are swapped so x increases, the major axis steps every
    pixel, and the minor axis steps where the error term dx - 2*dy*(i+1)
    + 2*dx*m turns negative, i.e. after i steps it has moved
    m_i = ceil((2*dy*i - dx) / (2*dx))."""
    (x0, y0), (x1, y1) = (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1]))
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, abs(y1 - y0)
    sy = 1 if y1 >= y0 else -1
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    i = np.arange(major + 1)
    m = -((-(2 * minor * i - major)) // (2 * major)) if major else i * 0
    if dy > dx:
        img[y0 + sy * i, x0 + m] = value
    else:
        img[y0 + sy * m, x0 + i] = value


def scribbles2mask(scribbles: Dict, output_resolution: Tuple[int, int],
                   default_value: int = -1) -> np.ndarray:
    """Rasterize every frame's scribble lines into (T, H, W) int32 maps."""
    h, w = output_resolution
    frames = scribbles["scribbles"]
    out = np.full((len(frames), h, w), default_value, dtype=np.int32)
    for ti, lines in enumerate(frames):
        for line in lines:
            path = np.asarray(line["path"], dtype=np.float64)
            if len(path) == 0:
                continue
            obj = int(line["object_id"])
            # np.round is half-to-even, as in the JAX package.
            pts = np.round(path * np.asarray([w - 1, h - 1])).astype(np.int32)
            if len(pts) == 1:
                out[ti, pts[0][1], pts[0][0]] = obj
                continue
            for a, b in zip(pts[:-1], pts[1:]):
                draw_line(out[ti], a, b, obj)
    return out


def annotated_frames(scribbles: Dict) -> List[int]:
    return [i for i, s in enumerate(scribbles["scribbles"]) if len(s) > 0]


def is_empty(scribbles: Dict) -> bool:
    return len(annotated_frames(scribbles)) == 0


def select_single_frame(scribbles: Dict) -> Tuple[Dict, int]:
    """Keep only the (first) annotated frame, the reference's frame
    selection in to_mask (davis_processor.py:42-47). Returns the reduced
    scribble dict and the frame index."""
    for idx, s in enumerate(scribbles["scribbles"]):
        if len(s) != 0:
            return {**scribbles, "scribbles": [s]}, idx
    return scribbles, 0
