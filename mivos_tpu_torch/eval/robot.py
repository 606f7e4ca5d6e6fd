"""Interactive scribbles robot and local DAVIS-interactive session
(counterpart of mivos_tpu/eval/robot.py).

A deterministic simulated user that scribbles on the worst-predicted
frame, and a session object with the `davisinteractive` session's
next / get_scribbles / submit_masks surface, so the 8-round protocol
runs without that package. The robot picks the frame with the worst
region J, takes each object's largest misclassified region, erodes it
one step, thins it (Zhang-Suen) and emits the longest skeleton path as
a normalized polyline.

Without cv2, and equal to the JAX robot's cv2 calls:
  * components (cv2.connectedComponentsWithStats, 8-connectivity):
    scipy.ndimage.label with a 3x3 structure finds the same components
    but numbers them in raster order of their first pixel. The robot
    takes the first largest one, so the two can pick different blobs
    only when two error blobs tie on area.
  * `erode3x3` (cv2.erode, 3x3 ones): the image border does not erode.
  * `chamfer_distance` (cv2.distanceTransform(DIST_L2, 3)): OpenCV's
    two-pass 3x3 chamfer in float32, not the exact Euclidean distance.
    OpenCV built with IPP sums the steps of a few pixels in another
    order, one float32 ulp away.
Erosion, thinning and the distance run on the blob's bounding box plus
a 1-pixel margin, which gives the full frame's result: the margin is
background, and the frame's own border is handled as the full-frame
operation handles it.
"""
from __future__ import annotations

import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage

from mivos_tpu_torch.eval import davis_metrics

_NEIGHBORS = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
              (0, 1), (1, -1), (1, 0), (1, 1)]
# OpenCV's DIST_L2 3x3 mask steps, and FLT_MAX for "no zero seen yet".
_HV, _DIAG = np.float32(0.955), np.float32(1.3693)
_FAR = np.finfo(np.float32).max


def erode3x3(mask: np.ndarray) -> np.ndarray:
    """3x3 binary erosion; outside the image counts as foreground."""
    p = np.pad(mask.astype(bool), 1, constant_values=True)
    h, w = mask.shape
    out = np.ones((h, w), bool)
    for dy in range(3):
        for dx in range(3):
            out &= p[dy:dy + h, dx:dx + w]
    return out.astype(np.uint8)


def _row_scan(c: np.ndarray) -> np.ndarray:
    """t[j] = min(c[j], fl32(t[j-1] + HV)), t[-1] = far, with OpenCV's
    float32 rounding. Each relaxation sweep makes one more leading
    entry final (adding HV is monotone, so min and the rounded add
    commute), and a sweep that changes nothing has met the recurrence,
    whose solution is unique."""
    t = c
    while True:
        prev = np.concatenate([[_FAR], t[:-1]]) + _HV
        nxt = np.minimum(c, prev)
        if np.array_equal(nxt, t):
            return t
        t = nxt


def chamfer_distance(mask: np.ndarray) -> np.ndarray:
    """Float32 distance of each nonzero pixel to the nearest zero one,
    as cv2.distanceTransform(mask, cv2.DIST_L2, 3) gives it: OpenCV's
    forward and backward raster passes of the 3x3 chamfer (steps 0.955
    and 1.3693, summed in float32), rows vectorized. Outside the image,
    and a pixel no zero reaches, is FLT_MAX."""
    h, w = mask.shape
    tmp = np.full((h + 2, w + 2), _FAR, np.float32)
    for i in range(h):
        up = tmp[i]
        c = np.minimum(np.minimum(up[:-2], up[2:]) + _DIAG, up[1:-1] + _HV)
        c[mask[i] == 0] = 0
        tmp[i + 1, 1:-1] = _row_scan(c)
    for i in range(h - 1, -1, -1):
        down = tmp[i + 2]
        c = np.minimum(np.minimum(down[:-2], down[2:]) + _DIAG,
                       down[1:-1] + _HV)
        c = np.minimum(c, tmp[i + 1, 1:-1])
        tmp[i + 1, 1:-1] = _row_scan(c[::-1])[::-1]
    return tmp[1:-1, 1:-1].copy()


def zhang_suen_thin(mask: np.ndarray, max_iters: int = 500) -> np.ndarray:
    """Morphological thinning to a 1-px-wide 8-connected skeleton
    (vectorized Zhang-Suen, as in the JAX package)."""
    img = np.ascontiguousarray(mask.astype(np.uint8))
    for _ in range(max_iters):
        changed = False
        for step in (0, 1):
            p = np.pad(img, 1)
            P2, P3 = p[:-2, 1:-1], p[:-2, 2:]
            P4, P5 = p[1:-1, 2:], p[2:, 2:]
            P6, P7 = p[2:, 1:-1], p[2:, :-2]
            P8, P9 = p[1:-1, :-2], p[:-2, :-2]
            ring = [P2, P3, P4, P5, P6, P7, P8, P9, P2]
            B = P2 + P3 + P4 + P5 + P6 + P7 + P8 + P9
            A = np.zeros_like(B)
            for i in range(8):
                A += (ring[i] == 0) & (ring[i + 1] == 1)
            if step == 0:
                cond = ((P2 * P4 * P6) == 0) & ((P4 * P6 * P8) == 0)
            else:
                cond = ((P2 * P4 * P8) == 0) & ((P2 * P6 * P8) == 0)
            kill = (img == 1) & (B >= 2) & (B <= 6) & (A == 1) & cond
            if kill.any():
                img[kill] = 0
                changed = True
        if not changed:
            break
    return img.astype(bool)


def _longest_skeleton_path(skel: np.ndarray) -> np.ndarray:
    """Longest simple path through the skeleton's pixel graph via the
    double-BFS tree-diameter heuristic. Returns (N, 2) [row, col]."""
    ys, xs = np.nonzero(skel)
    if len(ys) == 0:
        return np.zeros((0, 2), np.int64)
    pix = set(zip(ys.tolist(), xs.tolist()))

    def bfs(start):
        parent = {start: None}
        order = [start]
        head = 0
        while head < len(order):
            cy, cx = order[head]
            head += 1
            for dy, dx in _NEIGHBORS:
                nxt = (cy + dy, cx + dx)
                if nxt in pix and nxt not in parent:
                    parent[nxt] = (cy, cx)
                    order.append(nxt)
        return order[-1], parent

    far, _ = bfs((int(ys[0]), int(xs[0])))
    end, parent = bfs(far)
    path = []
    node = end
    while node is not None:
        path.append(node)
        node = parent[node]
    return np.asarray(path[::-1], np.int64)


class InteractiveScribblesRobot:
    """Deterministic scribble generator (official robot semantics:
    worst frame -> largest per-object error blob -> skeleton path)."""

    def __init__(self, min_nb_nodes: int = 4, nb_points: int = 25,
                 min_blob_px: int = 16):
        self.min_nb_nodes = min_nb_nodes
        self.nb_points = nb_points
        self.min_blob_px = min_blob_px

    def select_frame(self, pred: np.ndarray, gt: np.ndarray,
                     num_objects: int,
                     candidates: Optional[Sequence[int]] = None,
                     region_j: Optional[np.ndarray] = None) -> int:
        """Frame with the worst mean region J over objects. region_j:
        the (K, T) J of `pred`, where the caller has it already."""
        if region_j is None:
            region_j = davis_metrics.region_j(pred, gt, num_objects)
        frames = list(candidates) if candidates else range(pred.shape[0])
        scores = [float(np.mean(region_j[:, ti].tolist())) for ti in frames]
        return int(list(frames)[int(np.argmin(scores))])

    def _object_scribble(self, error: np.ndarray,
                         obj: int, h: int, w: int) -> Optional[Dict]:
        labels, n = ndimage.label(error, structure=np.ones((3, 3), int))
        if n == 0:
            return None
        areas = np.bincount(labels.ravel())[1:]
        largest = 1 + int(np.argmax(areas))
        if areas[largest - 1] < self.min_blob_px:
            return None
        rows, cols = ndimage.find_objects(labels)[largest - 1]
        y0, x0 = max(rows.start - 1, 0), max(cols.start - 1, 0)
        crop = (slice(y0, min(rows.stop + 1, h)), slice(x0, min(cols.stop + 1, w)))
        # Erode one step first: keeps the scribble strictly interior,
        # as the official robot's safety margin does.
        blob = (labels[crop] == largest).astype(np.uint8)
        eroded = erode3x3(blob)
        if eroded.sum() >= self.min_blob_px:
            blob = eroded
        path = _longest_skeleton_path(zhang_suen_thin(blob)) + [y0, x0]
        if len(path) < self.min_nb_nodes:
            # Symmetric blobs (e.g. squares) thin to a point: fall back
            # to a polyline along the distance-transform ridge, which is
            # interior by construction.
            dt = chamfer_distance(blob)
            ys, xs = np.nonzero(dt >= max(1.0, 0.5 * dt.max()))
            if len(ys) < self.min_nb_nodes:
                return None
            ys, xs = ys + y0, xs + x0
            order = np.argsort(ys * (w + 1) + xs)
            path = np.stack([ys[order], xs[order]], axis=1)
        if len(path) > self.nb_points:
            sel = np.linspace(0, len(path) - 1, self.nb_points).astype(int)
            path = path[sel]
        return {"path": [[c / max(w - 1, 1), r / max(h - 1, 1)]
                         for r, c in path.tolist()],
                "object_id": int(obj), "start_time": 0, "end_time": 0}

    def interact(self, pred: np.ndarray, gt: np.ndarray, num_objects: int,
                 candidates: Optional[Sequence[int]] = None,
                 sequence: str = "",
                 region_j: Optional[np.ndarray] = None) -> Dict:
        """pred/gt: (T, H, W) label maps. Returns a scribble dict in the
        schema interactive/scribbles.py consumes. Round 0 (pred all
        zeros) reduces to scribbling each GT object: the protocol's
        initial human scribbles."""
        t, h, w = gt.shape
        idx = self.select_frame(pred, gt, num_objects, candidates, region_j)
        lines = []
        for obj in range(num_objects + 1):   # 0 = background corrections
            error = (gt[idx] == obj) & (pred[idx] != obj)
            line = self._object_scribble(error, obj, h, w)
            if line is not None:
                lines.append(line)
        frames: List[List[Dict]] = [[] for _ in range(t)]
        frames[idx] = lines
        return {"scribbles": frames, "annotated_frame": idx,
                "sequence": sequence}


class LocalInteractiveSession:
    """Hermetic DavisInteractiveSession: same driving surface
    (next / get_scribbles / submit_masks / get_global_summary), robot
    user, J&F bookkeeping on `device`, wall-clock timing per
    interaction. The robot runs before and the metrics after the timed
    window, as the official session times only the method."""

    def __init__(self, sequences: Dict[str, Tuple[np.ndarray, int]],
                 max_nb_interactions: int = 8,
                 max_time: Optional[float] = None,
                 robot: Optional[InteractiveScribblesRobot] = None,
                 device: torch.device | str = "cpu"):
        """sequences: name -> (gt_labels (T, H, W), num_objects)."""
        self.sequences = dict(sequences)
        self.max_rounds = max_nb_interactions
        self.max_time = (max_time if max_time is not None
                         else 30.0 * max_nb_interactions)
        self.robot = robot or InteractiveScribblesRobot()
        self.device = torch.device(device)
        self._order = list(self.sequences)
        self._seq_i = -1
        self._round = 0
        self._new_seq = False
        self._pred: Optional[np.ndarray] = None
        self._next_frames: Optional[List[int]] = None
        self._t0: Optional[float] = None
        self._elapsed = 0.0
        self._history: List[Dict] = []       # this sequence's scribbles
        self._metrics: Optional[davis_metrics.SequenceJF] = None
        self._region_j: Optional[np.ndarray] = None  # (K, T) J of _pred
        self.records: Dict[str, List[Tuple[float, float]]] = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def next(self) -> bool:
        if self._seq_i >= 0 and self._round < self.max_rounds \
                and self._elapsed < self.max_time:
            self._new_seq = False
            return True
        self._seq_i += 1
        if self._seq_i >= len(self._order):
            return False
        gt, k = self.sequences[self._order[self._seq_i]]
        self._round = 0
        self._elapsed = 0.0
        self._pred = np.zeros_like(gt)
        self._next_frames = None
        self._new_seq = True
        self._history = []
        self._metrics = davis_metrics.SequenceJF(gt, k, self.device)
        self._region_j = self._metrics.region_j(self._pred)
        self.records[self._order[self._seq_i]] = []
        return True

    def get_scribbles(self, only_last: bool = True):
        """only_last=True: this round's robot scribbles. only_last=False:
        all rounds' scribbles for the sequence merged per frame (the
        DavisInteractiveSession surface this mirrors)."""
        name = self._order[self._seq_i]
        gt, k = self.sequences[name]
        scribbles = self.robot.interact(self._pred, gt, k,
                                        candidates=self._next_frames,
                                        sequence=name,
                                        region_j=self._region_j)
        self._history.append(scribbles)
        self._t0 = time.monotonic()
        if not only_last and len(self._history) > 1:
            frames = [[] for _ in range(gt.shape[0])]
            for scr in self._history:
                for ti, lines in enumerate(scr["scribbles"]):
                    frames[ti] = frames[ti] + lines
            scribbles = {**scribbles, "scribbles": frames}
        return name, scribbles, self._new_seq

    def submit_masks(self, pred_masks: np.ndarray,
                     next_frames: Optional[Sequence[int]] = None) -> None:
        name = self._order[self._seq_i]
        self._elapsed += time.monotonic() - (self._t0 or time.monotonic())
        self._pred = np.asarray(pred_masks)
        self._next_frames = (list(next_frames)
                             if next_frames is not None
                             and len(next_frames) > 0 else None)
        j, f = self._metrics.jf(self._pred)
        self._region_j = j
        self.records[name].append(
            (self._elapsed, float((j.mean() + f.mean()) / 2.0)))
        self._round += 1

    def get_report(self) -> Dict[str, List[Tuple[float, float]]]:
        return {k: list(v) for k, v in self.records.items()}

    def get_global_summary(self, save_file: Optional[str] = None) -> Dict:
        summary = davis_metrics.summarize_session(self.records,
                                                  max_time=self.max_time)
        summary["auc_jf"] = summary["auc"]
        if save_file:
            with open(save_file, "w") as f:
                json.dump(summary, f, indent=2)
        return summary
