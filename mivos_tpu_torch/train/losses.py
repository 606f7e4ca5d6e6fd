"""Fusion training losses, NCHW (counterpart of mivos_tpu/train/losses.py;
reference model/losses.py).

The JAX package takes the hardest pixels' mean from a full sort and a
prefix mask, so that `it` stays a traced value under jit; eager PyTorch
takes them with torch.topk(int(n * p)), the reference's own form. The
fraction p is computed in float32 in the JAX package's order of
operations, so both take the same number of pixels.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def bootstrap_fraction(it: int, start_warm: int, end_warm: int,
                       top_p: float = 0.15) -> np.float32:
    """Annealed hard-pixel fraction (reference losses.py:29-39): 1.0
    before start_warm, top_p after end_warm, linear in between."""
    it32 = np.float32(it)
    if it32 < start_warm:
        return np.float32(1.0)
    if it32 > end_warm:
        return np.float32(top_p)
    return (np.float32(1.0 - top_p) * (np.float32(end_warm) - it32)
            / np.float32(end_warm - start_warm) + np.float32(top_p))


def bootstrapped_ce(logits: torch.Tensor, cls_gt: torch.Tensor, it: int,
                    start_warm: int, end_warm: int,
                    top_p: float = 0.15) -> Tuple[torch.Tensor, np.float32]:
    """Per-sample mean CE over the int(n * p) hardest pixels, averaged
    over the batch. logits (B, C, H, W), cls_gt (B, H, W) integer.
    Returns (loss, p)."""
    raw = F.cross_entropy(logits, cls_gt.long(), reduction="none")
    flat = raw.flatten(1)
    p = bootstrap_fraction(it, start_warm, end_warm, top_p)
    k = int(np.floor(np.float32(flat.shape[1]) * p))
    loss = torch.topk(flat, k, dim=1).values.sum(dim=1) / max(k, 1)
    return loss.mean(), p


def fusion_loss(logits: torch.Tensor, cls_gt: torch.Tensor,
                selector: torch.Tensor, it: int, start_warm: int,
                end_warm: int, top_p: float = 0.15):
    """Selector-aware loss (reference losses.py:57-61): a sample without
    a second object competes background against object 1 only; its third
    logit is masked to -1e9, which gives the 2-class log-softmax."""
    has_second = selector[:, 1] > 0.5
    l2 = torch.where(has_second[:, None, None], logits[:, 2],
                     torch.full_like(logits[:, 2], -1e9))
    masked = torch.cat([logits[:, :2], l2[:, None]], dim=1)
    return bootstrapped_ce(masked, cls_gt, it, start_warm, end_warm, top_p)


def iou_sums(pred_mask: torch.Tensor, gt: torch.Tensor):
    """Intersection and union pixel counts at 0.5 (reference
    util/tensor_util.py:5-9)."""
    seg, g = pred_mask > 0.5, gt > 0.5
    return (seg & g).sum().to(torch.float32), (seg | g).sum().to(torch.float32)


def compute_fusion_losses(out: Dict[str, torch.Tensor],
                          batch: Dict[str, torch.Tensor], it: int,
                          start_warm: int, end_warm: int) -> Dict:
    """The metric dict (reference LossComputer.compute, losses.py:50-74).
    out['logits'] / out['mask']: (B, 3, H, W); batch['gt'] / ['gt2']:
    (B, 1, H, W). 'hide' keys feed the Integrator's IoU hook."""
    loss, p = fusion_loss(out["logits"], batch["cls_gt"], batch["selector"],
                          it, start_warm, end_warm)
    i1, u1 = iou_sums(out["mask"][:, 1], batch["gt"][:, 0])
    i2, u2 = iou_sums(out["mask"][:, 2], batch["gt2"][:, 0])
    return {"total_loss": loss, "p": p,
            "hide_iou/i": i1, "hide_iou/u": u1,
            "hide_iou/sec_i": i2, "hide_iou/sec_u": u2}
