"""Video and image-folder loading for interactive sessions (counterpart
of mivos_tpu/interactive/video_io.py; reference
interact/interactive_utils.py:25-79). PIL and cv2 are imported inside
the functions that decode files, never when the module is imported.
"""
from __future__ import annotations

import os
from os import path
from typing import List, Optional

import numpy as np


def _target_size(h: int, w: int, min_side: Optional[int]):
    if min_side is None:
        return h, w
    ratio = min_side / min(h, w)
    return int(round(h * ratio)), int(round(w * ratio))


def load_images(folder: str, min_side: Optional[int] = 480) -> np.ndarray:
    """Sorted frames from a folder -> (T, H, W, 3) uint8 RGB."""
    import cv2
    from PIL import Image

    frames: List[np.ndarray] = []
    for name in sorted(os.listdir(folder)):
        if not name.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
            continue
        img = np.asarray(Image.open(path.join(folder, name)).convert("RGB"))
        h, w = _target_size(img.shape[0], img.shape[1], min_side)
        if (h, w) != img.shape[:2]:
            img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
        frames.append(img)
    if not frames:
        raise ValueError(f"no images found in {folder}")
    return np.stack(frames)


def load_video(filename: str, min_side: Optional[int] = 480) -> np.ndarray:
    """Decode a video -> (T, H, W, 3) uint8 RGB
    (reference interactive_utils.py:64-79)."""
    import cv2

    cap = cv2.VideoCapture(filename)
    frames: List[np.ndarray] = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        h, w = _target_size(frame.shape[0], frame.shape[1], min_side)
        if (h, w) != frame.shape[:2]:
            frame = cv2.resize(frame, (w, h), interpolation=cv2.INTER_AREA)
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {filename}")
    return np.stack(frames)


def load_masks(folder: str, min_side: Optional[int] = None) -> np.ndarray:
    """Sorted palettized masks -> (T, H, W) uint8 labels
    (reference interactive_utils.py:42-62)."""
    import cv2
    from PIL import Image

    masks: List[np.ndarray] = []
    for name in sorted(os.listdir(folder)):
        if not name.lower().endswith(".png"):
            continue
        m = np.asarray(Image.open(path.join(folder, name)).convert("P"))
        h, w = _target_size(m.shape[0], m.shape[1], min_side)
        if (h, w) != m.shape[:2]:
            m = cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)
        masks.append(m)
    if not masks:
        raise ValueError(f"no masks found in {folder}")
    return np.stack(masks)
