"""NoC (number-of-clicks) evaluation for interactive segmentation
(counterpart of mivos_tpu/eval/noc.py; reference
fbrs/inference/evaluation.py:16-56 and utils.py:103-130).

A deterministic simulated user clicks the centre of the larger error
region until the IoU target is reached; with frozen weights the IoU
trajectory replays exactly.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np

from mivos_tpu_torch.interactive.clicker import IGNORE_LABEL, Clicker


def get_iou(gt_mask: np.ndarray, pred_mask: np.ndarray) -> float:
    """(reference fbrs/inference/utils.py:103-110)."""
    keep = gt_mask != IGNORE_LABEL
    obj = gt_mask == 1
    inter = np.logical_and(np.logical_and(pred_mask, obj), keep).sum()
    union = np.logical_and(np.logical_or(pred_mask, obj), keep).sum()
    return float(inter) / max(float(union), 1.0)


def evaluate_sample(image, gt_mask: np.ndarray, predictor,
                    max_iou_thr: float, pred_thr: float = 0.49,
                    max_clicks: int = 20):
    """Clicks until IoU >= max_iou_thr or max_clicks (reference
    evaluation.py:35-56). image: (H, W, 3) normalized. Returns (clicks,
    ious, last_probs) with last_probs a host (H, W) array."""
    clicker = Clicker(gt_mask=gt_mask)
    pred_mask = np.zeros_like(gt_mask, dtype=bool)
    ious: List[float] = []

    predictor.set_input_image(image)
    probs = None
    for _ in range(max_clicks):
        clicker.make_next_click(pred_mask)
        probs = predictor.get_prediction(clicker).cpu().numpy()
        pred_mask = probs > pred_thr
        iou = get_iou(gt_mask, pred_mask)
        ious.append(iou)
        if iou >= max_iou_thr:
            break
    return clicker.clicks_list, np.asarray(ious, np.float32), probs


def evaluate_dataset(dataset, predictor, **kwargs):
    """dataset yields (image, gt_mask) pairs (reference
    evaluation.py:16-32). Returns (per-sample IoU arrays, seconds)."""
    all_ious = []
    t0 = time.time()
    for i in range(len(dataset)):
        image, gt_mask = dataset[i]
        _, ious, _ = evaluate_sample(image, gt_mask, predictor, **kwargs)
        all_ious.append(ious)
    return all_ious, time.time() - t0


def compute_noc_metric(all_ious: Sequence[np.ndarray],
                       iou_thrs: Sequence[float],
                       max_clicks: int = 20) -> Tuple[List[float], List[int]]:
    """Mean number of clicks to reach each IoU threshold, and the count
    of samples that never reached it (reference utils.py:113-130)."""
    def noc(iou_arr, thr):
        ok = np.asarray(iou_arr) >= thr
        return np.argmax(ok) + 1 if ok.any() else max_clicks

    noc_list, over_max = [], []
    for thr in iou_thrs:
        scores = np.asarray([noc(arr, thr) for arr in all_ious], np.int32)
        noc_list.append(float(scores.mean()))
        over_max.append(int((scores == max_clicks).sum()))
    return noc_list, over_max
