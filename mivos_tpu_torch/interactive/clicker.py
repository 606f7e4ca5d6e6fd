"""Click bookkeeping and the simulated user's click placement
(counterpart of mivos_tpu/interactive/clicker.py; reference
fbrs/inference/clicker.py).

The next click goes to the peak of the distance transform of the larger
error region (false negatives -> positive click, false positives ->
negative click): the deterministic protocol behind NoC evaluation. Host
numpy; the exact euclidean transform is scipy's, cast to float32 as
cv2.distanceTransform(DIST_L2, 0) returns it, so argmax ties break alike.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
from scipy.ndimage import distance_transform_edt


@dataclasses.dataclass(frozen=True)
class Click:
    is_positive: bool
    coords: Tuple[float, float]  # (y, x)


def _edt(mask: np.ndarray) -> np.ndarray:
    return distance_transform_edt(mask).astype(np.float32)


# Ground-truth value of pixels that count neither as object nor background.
IGNORE_LABEL = -1


class Clicker:
    def __init__(self, gt_mask: Optional[np.ndarray] = None):
        if gt_mask is not None:
            self.gt_mask = gt_mask == 1
            self.not_ignore_mask = gt_mask != IGNORE_LABEL
        else:
            self.gt_mask = None
        self.reset_clicks()

    def make_next_click(self, pred_mask: np.ndarray) -> None:
        assert self.gt_mask is not None
        self.add_click(self._get_next_click(pred_mask))

    def _get_next_click(self, pred_mask: np.ndarray,
                        padding: bool = True) -> Click:
        """Reference clicker.py:32-59: distance-transform peak of the
        larger error region."""
        fn_mask = np.logical_and(np.logical_and(self.gt_mask, ~pred_mask),
                                 self.not_ignore_mask)
        fp_mask = np.logical_and(np.logical_and(~self.gt_mask, pred_mask),
                                 self.not_ignore_mask)
        if padding:
            fn_mask = np.pad(fn_mask, 1, "constant")
            fp_mask = np.pad(fp_mask, 1, "constant")
        fn_dt = _edt(fn_mask)
        fp_dt = _edt(fp_mask)
        if padding:
            fn_dt = fn_dt[1:-1, 1:-1]
            fp_dt = fp_dt[1:-1, 1:-1]
        fn_dt = fn_dt * self.not_clicked_map
        fp_dt = fp_dt * self.not_clicked_map

        is_positive = fn_dt.max() > fp_dt.max()
        dt = fn_dt if is_positive else fp_dt
        coords = np.unravel_index(dt.argmax(), dt.shape)
        return Click(is_positive=bool(is_positive),
                     coords=(float(coords[0]), float(coords[1])))

    def add_click(self, click: Click) -> None:
        coords = click.coords
        if click.is_positive:
            self.num_pos_clicks += 1
        else:
            self.num_neg_clicks += 1
        self.clicks_list.append(click)
        if self.gt_mask is not None:
            self.not_clicked_map[int(coords[0]), int(coords[1])] = False

    def _remove_last_click(self) -> None:
        click = self.clicks_list.pop()
        if click.is_positive:
            self.num_pos_clicks -= 1
        else:
            self.num_neg_clicks -= 1
        if self.gt_mask is not None:
            self.not_clicked_map[int(click.coords[0]),
                                 int(click.coords[1])] = True

    def reset_clicks(self) -> None:
        if self.gt_mask is not None:
            self.not_clicked_map = np.ones_like(self.gt_mask, dtype=bool)
        self.num_pos_clicks = 0
        self.num_neg_clicks = 0
        self.clicks_list: List[Click] = []

    def get_clicks(self) -> List[Click]:
        return self.clicks_list

    def get_state(self):
        return list(self.clicks_list)

    def set_state(self, state) -> None:
        self.reset_clicks()
        for click in state:
            self.add_click(click)

    def __len__(self) -> int:
        return len(self.clicks_list)
