"""DAVIS evaluation metrics: region J, boundary F, session AUC
(counterpart of mivos_tpu/eval/davis_metrics.py).

  * J (region similarity): intersection-over-union of the binary masks;
    1.0 when both masks are empty.
  * F (boundary accuracy): precision/recall of the two boundary maps
    matched within a disc of radius ceil(0.008 * image diagonal).
  * Session summary: a time-vs-(J&F) step curve per sequence sampled on
    a common grid; AUC is the normalized area under the averaged curve
    and metric@60s its value at t=60.

The per-frame work runs batched in torch on the session's device: the
boundary maps, and their dilation by the disc as a conv2d with the 0/1
disc whose integer counts are thresholded at 0.5 (exact whatever
algorithm the convolution picks). Only integer pixel counts come back
to the host, where J and F are formed in float64 with the JAX
package's formulas, so the numbers are the JAX ones bit for bit.
`SequenceJF` keeps a sequence's ground truth and its dilated boundaries
on the device across rounds.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def ellipse_disc(r: int) -> np.ndarray:
    """(2r+1, 2r+1) uint8 disc, equal to cv2.getStructuringElement(
    cv2.MORPH_ELLIPSE, (2r+1, 2r+1)): row dy spans the columns within
    rint(r * sqrt(1 - dy^2 / r^2)) of the centre (rint is half-to-even,
    as OpenCV's cvRound)."""
    size = 2 * r + 1
    disc = np.zeros((size, size), np.uint8)
    for i in range(size):
        dy = i - r
        dx = int(np.rint(r * math.sqrt((r * r - dy * dy) / (r * r))))
        disc[i, r - dx: r + dx + 1] = 1
    return disc


def boundary_radius(h: int, w: int, bound_th: float = 0.008) -> int:
    return (int(math.ceil(bound_th)) if bound_th > 1
            else int(math.ceil(bound_th * math.hypot(h, w))))


def _boundary(masks: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> foreground pixels with a background 4-neighbour
    (the image border counts as background)."""
    p = F.pad(masks, (1, 1, 1, 1))
    interior = p[:, :-2, 1:-1] & p[:, 2:, 1:-1] & p[:, 1:-1, :-2] & p[:, 1:-1, 2:]
    return masks & ~interior


def _dilate(masks: torch.Tensor, disc: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool dilated by the (D, D) 0/1 float disc."""
    r = disc.shape[-1] // 2
    counts = F.conv2d(masks[:, None].to(torch.float32), disc[None, None],
                      padding=r)
    return counts[:, 0] > 0.5


def _sum(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(1).sum(1)


def _j_from_counts(inter: np.ndarray, union: np.ndarray) -> np.ndarray:
    j = np.ones(union.shape)
    nz = union > 0
    j[nz] = inter[nz].astype(np.float64) / union[nz].astype(np.float64)
    return j


def _f_from_counts(n_gt, n_pr, hit_pr, hit_gt) -> np.ndarray:
    """db_eval_boundary's arithmetic, elementwise in float64."""
    f = np.zeros(n_gt.shape)
    f[(n_gt == 0) & (n_pr == 0)] = 1.0
    both = (n_gt > 0) & (n_pr > 0)
    precision = hit_pr[both] / n_pr[both].astype(np.float64)
    recall = hit_gt[both] / n_gt[both].astype(np.float64)
    denom = precision + recall
    val = np.zeros(precision.shape)
    ok = denom != 0
    val[ok] = 2 * precision[ok] * recall[ok] / denom[ok]
    f[both] = val
    return f


def region_j(pred, gt, num_objects: int,
             device: torch.device | str = "cpu") -> np.ndarray:
    """(K, T) region J of (T, H, W) label maps, objects 1..num_objects."""
    pred = torch.as_tensor(pred).to(device)
    gt = torch.as_tensor(gt).to(device)
    counts = [torch.stack([_sum((gt == obj) & (pred == obj)),
                           _sum((gt == obj) | (pred == obj))])
              for obj in range(1, num_objects + 1)]
    c = torch.stack(counts, dim=1).cpu().numpy()   # (2, K, T)
    return _j_from_counts(c[0], c[1])


class SequenceJF:
    """J and F of (T, H, W) label maps against one sequence's ground
    truth, objects 1..num_objects. The ground-truth boundaries and their
    dilation are computed once, on `device`."""

    def __init__(self, gt, num_objects: int, device: torch.device | str = "cpu",
                 bound_th: float = 0.008):
        self.device = torch.device(device)
        self.k = num_objects
        self.gt = torch.as_tensor(gt).to(self.device)
        h, w = self.gt.shape[-2:]
        self.disc = torch.from_numpy(ellipse_disc(boundary_radius(
            h, w, bound_th)).astype(np.float32)).to(self.device)
        self._gt_b, self._gt_d = [], []
        for obj in range(1, num_objects + 1):
            b = _boundary(self.gt == obj)
            self._gt_b.append(b)
            self._gt_d.append(_dilate(b, self.disc))

    def region_j(self, pred) -> np.ndarray:
        """(K, T) region J of `pred`."""
        return region_j(pred, self.gt, self.k, self.device)

    def jf(self, pred) -> Tuple[np.ndarray, np.ndarray]:
        """(J, F), each (K, T) float64 (mivos_tpu batched_jf)."""
        pred = torch.as_tensor(pred).to(self.device)
        rows = []
        for obj in range(1, self.k + 1):
            g, p = self.gt == obj, pred == obj
            pr_b = _boundary(p)
            gt_b, gt_d = self._gt_b[obj - 1], self._gt_d[obj - 1]
            rows.append(torch.stack([
                _sum(g & p), _sum(g | p), _sum(gt_b), _sum(pr_b),
                _sum(pr_b & gt_d), _sum(gt_b & _dilate(pr_b, self.disc))]))
        c = torch.stack(rows, dim=1).cpu().numpy()   # (6, K, T) int64
        return _j_from_counts(c[0], c[1]), _f_from_counts(*c[2:])

    def sequence_jf(self, pred) -> float:
        j, f = self.jf(pred)
        return float((j.mean() + f.mean()) / 2.0)


def db_eval_iou(gt: np.ndarray, pred: np.ndarray) -> float:
    """Region similarity J for one binary mask pair; both-empty = 1."""
    gt = gt.astype(bool)
    pred = pred.astype(bool)
    union = np.logical_or(gt, pred).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(gt, pred).sum()) / float(union)


def db_eval_boundary(gt: np.ndarray, pred: np.ndarray,
                     bound_th: float = 0.008) -> float:
    """Boundary F-measure with a match radius of bound_th * diagonal
    (bound_th > 1 is an absolute pixel radius)."""
    sj = SequenceJF(np.asarray(gt, bool)[None].astype(np.uint8), 1,
                    bound_th=bound_th)
    return float(sj.jf(np.asarray(pred, bool)[None].astype(np.uint8))[1][0, 0])


def batched_jf(pred: np.ndarray, gt: np.ndarray, num_objects: int,
               device: torch.device | str = "cpu"
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-object, per-frame J and F for (T, H, W) label maps.
    Returns (J, F) each of shape (num_objects, T); object ids 1..K."""
    return SequenceJF(gt, num_objects, device).jf(pred)


def sequence_jf(pred: np.ndarray, gt: np.ndarray, num_objects: int,
                device: torch.device | str = "cpu") -> float:
    """Mean of J and F over all objects and frames, the per-round
    scalar the interactive protocol tracks."""
    return SequenceJF(gt, num_objects, device).sequence_jf(pred)


def _step_interp(times: Sequence[float], values: Sequence[float],
                 grid: np.ndarray) -> np.ndarray:
    """Piecewise-constant curve: value at t = last submitted metric at
    or before t (0 before the first submission)."""
    out = np.zeros_like(grid)
    for t_i, v in zip(times, values):        # times ascending
        out[grid >= t_i] = v
    return out


def summarize_session(records: Dict[str, List[Tuple[float, float]]],
                      max_time: float, metric_at: float = 60.0,
                      n_samples: int = 200) -> Dict:
    """records: per sequence, the ascending [(cumulative_time, J&F)]
    trajectory, one entry per interaction round. Returns
    {auc, metric_at_<t>s, curve: {time, metric}}."""
    grid = np.linspace(0.0, max_time, n_samples)
    curves = [_step_interp([t for t, _ in traj], [v for _, v in traj], grid)
              for traj in records.values()]
    mean_curve = (np.mean(np.stack(curves), axis=0) if curves
                  else np.zeros_like(grid))
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy<2
    auc = float(trapezoid(mean_curve, grid) / max(max_time, 1e-9))
    at = float(np.interp(metric_at, grid, mean_curve))
    return {"auc": auc, f"metric_at_{int(metric_at)}s": at,
            "curve": {"time": grid.tolist(),
                      "metric": mean_curve.tolist()}}
