"""The DAVIS palette and indexed-PNG output (counterpart of the parts of
mivos_tpu/utils/palette.py that --save_mask uses). PIL is imported only
when a file is written."""
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


def save_indexed_png(path: str, labels: np.ndarray) -> None:
    """Save a (H, W) uint8 label map as a palettized PNG with the DAVIS
    palette (how the reference persists masks, interactive_gui.py:325)."""
    from PIL import Image

    img = Image.fromarray(labels.astype(np.uint8), mode="P")
    img.putpalette(davis_palette)
    img.save(path)
