"""f-BRS training losses and metrics, NCHW (counterpart of
mivos_tpu/train/fbrs_losses.py; reference fbrs/model/losses.py and
fbrs/model/metrics.py).

pred and label are (B, 1, H, W) (or (B, H, W)); label -1 means ignore.
`FBRSPretrainer` (train/pretrain.py) trains the click model on
`normalized_focal_loss`; `OracleMaskLoss` is the GT-oracle BRS loss of
the predictor surface.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from mivos_tpu_torch.ops.resize import bilinear_resize_align_corners


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def normalized_focal_loss(pred_logits: torch.Tensor, label: torch.Tensor,
                          alpha: float = 0.25, gamma: float = 2.0,
                          eps: float = 1e-12,
                          ignore_label: int = -1) -> torch.Tensor:
    """NFL: focal loss whose beta weights renormalize to the valid-pixel
    count per sample (reference losses.py:9-67). The renormalizer is
    detached, as the JAX package's stop_gradient. Returns (B,) losses."""
    pred = torch.sigmoid(pred_logits)
    one_hot = label > 0
    sw = (label != ignore_label).to(pred.dtype)
    a = torch.where(one_hot, alpha * sw, (1 - alpha) * sw)
    pt = torch.where(one_hot, pred, 1 - pred)
    pt = torch.where(sw > 0, pt, torch.ones_like(pt))
    beta = (1 - pt) ** gamma
    sw_sum = sw.sum(dim=(-2, -1), keepdim=True)
    beta_sum = beta.sum(dim=(-2, -1), keepdim=True)
    mult = (sw_sum / (beta_sum + eps)).detach()
    beta = beta * mult
    # minimum (not clamp) splits the gradient at a tie, as jnp.minimum.
    loss = -a * beta * torch.log(torch.minimum(pt + eps, torch.ones_like(pt))) * sw
    bsum = _flat(sw).sum(dim=1)
    return _flat(loss).sum(dim=1) / (bsum + eps)


def focal_loss(pred_logits: torch.Tensor, label: torch.Tensor,
               alpha: float = 0.25, gamma: float = 2.0,
               eps: float = 1e-9) -> torch.Tensor:
    """Plain focal loss normalized by the positive count
    (reference losses.py:70-110). Returns (B,)."""
    pred = torch.sigmoid(pred_logits)
    one_hot = label > 0
    sw = (label != -1).to(pred.dtype)
    a = torch.where(one_hot, alpha * sw, (1 - alpha) * sw)
    pt = torch.where(one_hot, pred, 1 - pred)
    beta = (1 - pt) ** gamma
    loss = -a * beta * torch.log(torch.minimum(pt + eps, torch.ones_like(pt))) * sw
    tsum = _flat((label == 1).to(pred.dtype)).sum(dim=1)
    return _flat(loss).sum(dim=1) / (tsum + eps)


def sigmoid_bce_loss(pred_logits: torch.Tensor, label: torch.Tensor,
                     ignore_label: int = -1) -> torch.Tensor:
    """Numerically stable sigmoid BCE with an ignore mask
    (reference losses.py:113-135). Returns (B,) mean losses."""
    sw = (label != ignore_label).to(pred_logits.dtype)
    lab = torch.where(sw > 0, label.to(pred_logits.dtype),
                      torch.zeros_like(sw))
    loss = (F.relu(pred_logits) - pred_logits * lab
            + F.softplus(-pred_logits.abs()))
    return _flat(loss * sw).mean(dim=1)


def sigmoid_bce_from_probs(pred: torch.Tensor, label: torch.Tensor,
                           ignore_label: int = -1,
                           eps: float = 1e-12) -> torch.Tensor:
    """BCE on probabilities (reference losses.py:128-134, the
    from_sigmoid=True branch OracleMaskLoss uses). Returns (B,)."""
    sw = (label != ignore_label).to(pred.dtype)
    lab = torch.where(sw > 0, label.to(pred.dtype), torch.zeros_like(sw))
    loss = -(torch.log(pred + eps) * lab
             + torch.log(1.0 - pred + eps) * (1.0 - lab))
    return _flat(loss * sw).mean(dim=1)


class OracleMaskLoss:
    """GT-oracle BRS loss (reference brs_losses.py:29-58): drives the BRS
    optimization toward the ground-truth mask (BCE on probabilities)
    instead of the click constraints. After more than 5 calls, a loss
    within 1e-5 of the one 4 calls earlier returns (0, 0, 0), which tells
    the optimizer to stop.

    Call contract: (result, pos_mask, neg_mask) -> (loss, f_max_pos,
    f_max_neg); the click maps are ignored. With a predictor attached
    whose ZoomIn holds an object ROI, the GT is cropped to the ROI and
    align-corners resized to the result (reference brs_losses.py:44-48);
    a result of twice the GT's batch (a flipped pair) gets the GT and its
    mirror image."""

    def __init__(self):
        self.gt_mask: Optional[torch.Tensor] = None
        self.predictor = None
        self.history: list = []

    def set_gt_mask(self, gt_mask) -> None:
        """gt_mask: (1, 1, H, W) float probabilities or labels."""
        self.gt_mask = torch.as_tensor(gt_mask)
        self.history = []

    def __call__(self, result: torch.Tensor, pos_mask=None, neg_mask=None):
        gt = self.gt_mask.to(result.device)
        roi = getattr(getattr(self.predictor, "zoom_in", None),
                      "_object_roi", None)
        if roi is not None:
            r1, r2, c1, c2 = roi[:4]
            gt = gt[..., r1:r2 + 1, c1:c2 + 1]
        if gt.shape[-2:] != result.shape[-2:]:
            gt = bilinear_resize_align_corners(gt, tuple(result.shape[-2:]))
        if result.shape[0] == 2 * gt.shape[0]:
            gt = torch.cat([gt, gt.flip(-1)], dim=0)

        loss = sigmoid_bce_from_probs(result, gt).mean()
        self.history.append(float(loss))
        if len(self.history) > 5 and \
                abs(self.history[-5] - self.history[-1]) < 1e-5:
            return 0.0, 0.0, 0.0
        return loss, 1.0, 1.0


def compute_iou(pred_mask, gt_mask, ignore_mask=None) -> np.ndarray:
    """Per-sample IoU over the samples with a non-empty union
    (reference metrics.py:86-101). Masks are tensors or arrays."""
    pred_mask = torch.as_tensor(pred_mask).to(torch.bool)
    gt_mask = torch.as_tensor(gt_mask).to(torch.bool)
    if ignore_mask is not None:
        pred_mask = pred_mask & ~torch.as_tensor(ignore_mask).to(torch.bool)
    union = _flat(pred_mask | gt_mask).to(torch.float32).mean(dim=1)
    inter = _flat(pred_mask & gt_mask).to(torch.float32).mean(dim=1)
    union, inter = union.cpu().numpy(), inter.cpu().numpy()
    nz = union > 0
    return inter[nz] / union[nz]


@dataclasses.dataclass
class AdaptiveIoU:
    """Train-time IoU at an adaptively tuned threshold
    (reference metrics.py:29-83): each update probes the threshold
    +-thresh_step and EMA-tracks the best threshold and IoU."""

    init_thresh: float = 0.4
    thresh_step: float = 0.025
    thresh_beta: float = 0.99
    iou_beta: float = 0.9
    ignore_label: int = -1
    from_logits: bool = True

    def __post_init__(self):
        self.iou_thresh = self.init_thresh
        self.ema_iou = 0.0
        self._epoch_sum = 0.0
        self._epoch_count = 0

    def update(self, pred: torch.Tensor, gt: torch.Tensor) -> None:
        gt = torch.as_tensor(gt)
        pred = torch.as_tensor(pred)
        gt_mask = gt > 0
        if self.from_logits:
            pred = torch.sigmoid(pred)
        if int(gt_mask.sum()) == 0:
            return
        ignore = gt == self.ignore_label
        best_t = self.iou_thresh
        best = compute_iou(pred > best_t, gt_mask, ignore).mean()
        for t in (best_t - self.thresh_step, best_t + self.thresh_step):
            iou = compute_iou(pred > t, gt_mask, ignore).mean()
            if iou > best:
                best, best_t = iou, t
        self.iou_thresh = (self.thresh_beta * self.iou_thresh
                           + (1 - self.thresh_beta) * best_t)
        self.ema_iou = (self.iou_beta * self.ema_iou
                        + (1 - self.iou_beta) * best)
        self._epoch_sum += float(best)
        self._epoch_count += 1

    def get_epoch_value(self) -> float:
        return (self._epoch_sum / self._epoch_count
                if self._epoch_count else 0.0)

    def reset_epoch_stats(self) -> None:
        self._epoch_sum = 0.0
        self._epoch_count = 0
