"""Host-side image transforms (counterpart of the parts of
mivos_tpu/data/transforms.py that the DAVIS evaluation and the GUI
session use)."""
from __future__ import annotations

from typing import Sequence

import numpy as np

# ImageNet statistics (reference dataset/range_transform.py:1-13).
IM_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IM_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def im_normalize(img: np.ndarray) -> np.ndarray:
    """uint8/float [0,255]-or-[0,1] HWC RGB -> normalized float32."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return (img - IM_MEAN) / IM_STD


def im_denormalize(img: np.ndarray) -> np.ndarray:
    """Inverse of im_normalize, clipped to [0, 1]
    (reference inv_im_trans, range_transform.py:10-12)."""
    return np.clip(np.asarray(img, np.float32) * IM_STD + IM_MEAN, 0.0, 1.0)


def all_to_onehot(masks: np.ndarray, labels: Sequence[int]) -> np.ndarray:
    """(T, H, W) label maps -> (K, T, H, W) uint8 one-hot planes
    (reference dataset/onehot_util.py:4-8)."""
    out = np.zeros((len(labels),) + masks.shape, dtype=np.uint8)
    for k, l in enumerate(labels):
        out[k] = (masks == l).astype(np.uint8)
    return out
