"""The DAVIS palette, indexed-PNG output and the GUI's mask overlay
(counterpart of mivos_tpu/utils/palette.py). PIL is imported only when
a file is written."""
from __future__ import annotations

import numpy as np


def pascal_color_map(n: int = 256) -> np.ndarray:
    """(N, 3) uint8 VOC bit-interleaved color map; index 0 is black."""
    cmap = np.zeros((n, 3), dtype=np.uint8)
    for i in range(n):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= (c & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = (r, g, b)
    return cmap


# Flat PIL-style palette (768 ints) with the DAVIS colors.
davis_palette = pascal_color_map().reshape(-1).tolist()

# The GUI overlay's brighter 10-color map (reference
# interactive_utils.py:107-117).
overlay_color_map = np.asarray([
    [0, 0, 0],
    [255, 50, 50],
    [50, 255, 50],
    [50, 50, 255],
    [255, 255, 50],
    [255, 50, 255],
    [50, 255, 255],
    [255, 128, 50],
    [128, 50, 255],
    [50, 255, 128],
], dtype=np.uint8)


def save_indexed_png(path: str, labels: np.ndarray) -> None:
    """Save a (H, W) uint8 label map as a palettized PNG with the DAVIS
    palette (how the reference persists masks, interactive_gui.py:325)."""
    from PIL import Image

    img = Image.fromarray(labels.astype(np.uint8), mode="P")
    img.putpalette(davis_palette)
    img.save(path)


def _contours(mask: np.ndarray) -> np.ndarray:
    """Boundary pixels of a label map (4-neighbourhood difference)."""
    pad = np.pad(mask, 1, mode="edge")
    return (
        (pad[1:-1, 1:-1] != pad[:-2, 1:-1])
        | (pad[1:-1, 1:-1] != pad[2:, 1:-1])
        | (pad[1:-1, 1:-1] != pad[1:-1, :-2])
        | (pad[1:-1, 1:-1] != pad[1:-1, 2:])
    ) & (mask > 0)


def overlay_davis(image: np.ndarray, mask: np.ndarray,
                  alpha: float = 0.5, fade: bool = False) -> np.ndarray:
    """Blend coloured masks onto an RGB uint8 image with darkened
    contours (reference interactive_utils.py:119-143). fade=True also
    dims the background (the GUI's 'fade' overlay mode)."""
    out = image.copy()
    colored = overlay_color_map[mask % len(overlay_color_map)]
    binary = mask > 0
    fg = (image * alpha + (1 - alpha) * colored).astype(image.dtype)
    out[binary] = fg[binary]
    out[_contours(mask)] = 0
    if fade:
        out[~binary] = (out[~binary] * 0.6).astype(image.dtype)
    return out
