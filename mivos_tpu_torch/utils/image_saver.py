"""Training-visualization montages (counterpart of
mivos_tpu/utils/image_saver.py; reference util/image_saver.py).

A captioned grid of the fusion-training tensors (`pool_fusion`,
reference :124-150), which `python -m mivos_tpu_torch.train` writes every
report_every * 10 iterations. Inputs NHWC numpy. Tiles are resized with
data/transforms.py::resize (cv2's INTER_NEAREST); the captions are
cv2.putText's Hershey text, so cv2 is imported where they are drawn.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from mivos_tpu_torch.data.transforms import INTER_NEAREST, im_denormalize, resize


def _resize(im: np.ndarray, size: Optional[Tuple[int, int]]) -> np.ndarray:
    if im.ndim == 2:
        im = im[..., None]
    if size is not None and im.shape[:2] != size:
        # cv2.resize drops a single channel's axis; so does this.
        im = resize(im[..., 0] if im.shape[-1] == 1 else im, (size[1], size[0]),
                    INTER_NEAREST)
        if im.ndim == 2:
            im = im[..., None]
    return np.clip(im.astype(np.float32), 0, 1)


def get_image_array(images: Dict[str, List[np.ndarray]],
                    cell: Tuple[int, int],
                    captions: Optional[Dict[str, str]] = None) -> np.ndarray:
    """Rows = dict keys (captioned), columns = list entries
    (reference image_saver.py:47-84). cell = (h, w) of one tile."""
    import cv2

    captions = captions or {}
    h, w = cell
    n_rows = len(images)
    n_cols = len(next(iter(images.values())))
    out = np.zeros([h * n_rows, w * (n_cols + 1), 3], np.uint8)
    font = cv2.FONT_HERSHEY_SIMPLEX
    for row, (key, tiles) in enumerate(images.items()):
        caption = captions.get(key, key)
        for i, line in enumerate(caption.split("\n")):
            cv2.putText(out, line, (10, row * h + 40 + i * 40), font,
                        0.8 if h > 200 else 0.4, (255, 255, 255),
                        2 if h > 200 else 1, cv2.LINE_AA)
        for col, img in enumerate(tiles):
            img = _resize(img, (h, w))
            if img.shape[-1] == 1:
                img = np.repeat(img, 3, axis=-1)
            out[row * h:(row + 1) * h,
                (col + 1) * w:(col + 2) * w] = (img * 255).astype(np.uint8)
    return out


def pool_fusion(batch: Dict[str, np.ndarray],
                size: Tuple[int, int] = (192, 192),
                max_rows: int = 4) -> np.ndarray:
    """Montage of the fusion training batch: images, the two propagated
    segmentations per object, attention maps, network outputs, and GT
    (reference image_saver.py:124-150). Expects the train step's batch
    (NHWC) plus 'mask' (the K+1-channel aggregated output), 'attn1' and
    'attn2' (FusionTrainer.debug_outputs)."""
    req: Dict[str, List[np.ndarray]] = defaultdict(list)
    b = min(max_rows, batch["gt"].shape[0])
    for i in range(b):
        req["RGB"].append(_resize(im_denormalize(batch["rgb"][i]), size))
        req["S11"].append(_resize(batch["seg1"][i], size))
        req["S21"].append(_resize(batch["seg2"][i], size))
        req["S12"].append(_resize(batch["seg12"][i], size))
        req["S22"].append(_resize(batch["seg22"][i], size))
        if "attn1" in batch:
            req["Pos Attn1"].append(_resize(batch["attn1"][i, ..., 0], size))
            req["Neg Attn1"].append(_resize(batch["attn1"][i, ..., 1], size))
            req["Pos Attn2"].append(_resize(batch["attn2"][i, ..., 0], size))
            req["Neg Attn2"].append(_resize(batch["attn2"][i, ..., 1], size))
        if "mask" in batch:
            req["MSK1"].append(_resize(batch["mask"][i, ..., 1], size))
            req["MSK2"].append(_resize(batch["mask"][i, ..., 2], size))
        req["GT1"].append(_resize(batch["gt"][i], size))
        req["GT2"].append(_resize(batch["gt2"][i], size))
    return get_image_array(req, size)
