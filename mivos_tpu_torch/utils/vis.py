"""Mask and click visualization (counterpart of mivos_tpu/utils/vis.py;
reference fbrs/utils/vis.py). Click markers are cv2.circle's filled
circles, drawn without cv2 (interactive/scribbles.py::_circle);
`draw_probmap` is cv2.applyColorMap's COLORMAP_HOT, so cv2 is imported
there."""
from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from mivos_tpu_torch.interactive.scribbles import _circle
from mivos_tpu_torch.utils.palette import pascal_color_map


@lru_cache(maxsize=16)
def get_palette(num_cls: int) -> np.ndarray:
    return pascal_color_map(num_cls)


def visualize_mask(mask: np.ndarray, num_cls: int) -> np.ndarray:
    """(H, W) labels -> (H, W, 3) uint8 colors (vis.py:19-23)."""
    palette = get_palette(num_cls)
    return palette[mask.astype(np.int32)].astype(np.uint8)


def draw_probmap(x: np.ndarray) -> np.ndarray:
    """Probability map -> heatmap image (vis.py:31-33)."""
    import cv2

    return cv2.applyColorMap((np.clip(x, 0, 1) * 255).astype(np.uint8),
                             cv2.COLORMAP_HOT)


def draw_points(image: np.ndarray, points, color,
                radius: int = 3) -> np.ndarray:
    """Draw (y, x) click markers as filled circles (vis.py:36-44)."""
    image = image.copy()
    for p in points:
        if p[0] < 0:
            continue
        disc = np.zeros(image.shape[:2], bool)
        _circle(disc, int(p[1]), int(p[0]), radius, True)
        image[disc] = color
    return image


def blend_mask(image: np.ndarray, mask: Optional[np.ndarray],
               alpha: float = 0.6) -> np.ndarray:
    """Alpha-blend a colored label map onto an RGB image (vis.py:104-129
    draw_with_blend_and_clicks, minus the click layer)."""
    if mask is None:
        return image
    colored = visualize_mask(mask, int(mask.max()) + 1)
    result = image.astype(np.float32)
    fg = mask > 0
    result[fg] = (1 - alpha) * result[fg] + alpha * colored[fg]
    return result.astype(np.uint8)


def draw_with_blend_and_clicks(image: np.ndarray,
                               mask: Optional[np.ndarray] = None,
                               alpha: float = 0.6,
                               clicks_list=None,
                               radius: int = 4) -> np.ndarray:
    """The reference's main debug renderer (vis.py:104-129)."""
    result = blend_mask(image, mask, alpha)
    if clicks_list:
        pos = [c.coords for c in clicks_list if c.is_positive]
        neg = [c.coords for c in clicks_list if not c.is_positive]
        result = draw_points(result, pos, (0, 255, 0), radius)
        result = draw_points(result, neg, (255, 0, 0), radius)
    return result
