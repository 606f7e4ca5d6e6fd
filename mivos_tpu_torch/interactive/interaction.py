"""GUI interaction state machines (counterpart of
mivos_tpu/interactive/interaction.py; reference interact/interaction.py).

Each class turns raw user input (strokes, clicks, region selections)
into a (K+1, nh, nw, 1) aggregated probability mask, with bounded undo
history (deque maxlen 50). Headless: a widget layer only routes events
here. Strokes are drawn on the host with `scribbles.draw_line`, cv2.line
to the pixel at every brush size.

Layouts (the JAX package's, as tensors on the session's device):
  image      (nh, nw, 3)  PADDED, normalized
  prev_mask  (K, nh, nw, 1) PADDED foreground probabilities
  true_size  (h, w) unpadded
"""
from __future__ import annotations

import time
from collections import deque
from copy import deepcopy
from typing import List, Tuple

import numpy as np
import torch

from mivos_tpu_torch.interactive.scribbles import draw_line
from mivos_tpu_torch.ops.aggregate import aggregate_sbg, aggregate_wbg
from mivos_tpu_torch.utils.tensor import pad_divide_by, unpad

MAX_HISTORY = 50


def _segment(path: List) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """The last two points of a stroke, rounded (half to even, as the
    JAX package) to integer (x, y)."""
    (x0, y0), (x1, y1) = path[-2], path[-1]
    return (int(round(x0)), int(round(y0))), (int(round(x1)), int(round(y1)))


class Interaction:
    def __init__(self, image, prev_mask, true_size, controller=None):
        self.image = image
        self.prev_mask = prev_mask
        self.controller = controller
        self.start_time = time.time()
        self.history: deque = deque(maxlen=MAX_HISTORY)
        self.h, self.w = true_size
        self.out_prob = None   # (K, nh, nw, 1) foreground probabilities
        self.out_mask = None   # (K+1, nh, nw, 1) aggregated

    def undo(self):
        raise NotImplementedError

    def can_undo(self) -> bool:
        return len(self.history) > 0

    def predict(self):
        raise NotImplementedError


class FreeInteraction(Interaction):
    """Direct painting (reference interaction.py:96-179). Strokes write
    1/0 into the per-object probability planes; object 0 erases."""

    def __init__(self, image, prev_mask, true_size, num_objects: int, pad):
        super().__init__(image, prev_mask, true_size)
        self.K = num_objects
        # (K, h, w) unpadded float planes, on the host
        self.drawn_map = unpad(prev_mask, pad)[..., 0].cpu().numpy().copy()
        self.curr_path: List[List] = [[] for _ in range(self.K + 1)]
        self.all_paths = [self.curr_path]
        self.size = 3
        self.surplus_history = False

    def set_size(self, size: int) -> None:
        self.size = int(size)

    def push_point(self, x: float, y: float, k: int) -> None:
        """k: object id, 0 = eraser."""
        selected = self.curr_path[k]
        selected.append((x, y))
        if len(selected) >= 2:
            p0, p1 = _segment(selected)
            for i in range(self.K):
                draw_line(self.drawn_map[i], p0, p1, float((i + 1) == k),
                          self.size)

    def end_path(self) -> None:
        self.curr_path = [[] for _ in range(self.K + 1)]
        self.all_paths.append(self.curr_path)
        self.history.append(self.drawn_map.copy())
        self.surplus_history = True

    def predict(self):
        prob = torch.from_numpy(self.drawn_map)[..., None].to(self.image.device)
        self.out_prob = pad_divide_by(prob, 16)[0]
        self.out_mask = aggregate_sbg(self.out_prob, keep_bg=True)
        return self.out_mask

    def undo(self):
        if self.surplus_history:
            self.history.pop()
            self.surplus_history = False
        self.drawn_map = self.history.pop()
        self.all_paths = self.all_paths[:-2]
        self.curr_path = [[] for _ in range(self.K + 1)]
        self.all_paths.append(self.curr_path)
        return self.predict()

    def can_undo(self) -> bool:
        return len(self.history) > 0 and not (
            self.surplus_history and len(self.history) < 2)


class ScribbleInteraction(Interaction):
    """Indexed scribble map -> S2M (reference interaction.py:182-262).
    prev_hard_mask is the HARD indexed (nh, nw) label map."""

    IGNORE = 255

    def __init__(self, image, prev_hard_mask, true_size, s2m_controller,
                 num_objects: int):
        super().__init__(image, None, true_size, s2m_controller)
        self.prev_hard = prev_hard_mask
        self.K = num_objects
        self.drawn_map = np.full((self.h, self.w), self.IGNORE, np.uint8)
        self.curr_path: List[List] = [[] for _ in range(self.K + 1)]
        self.all_paths = [self.curr_path]
        self.size = 3
        self.surplus_history = False

    def push_point(self, x: float, y: float, k: int) -> None:
        selected = self.curr_path[k]
        selected.append((x, y))
        if len(selected) >= 2:
            p0, p1 = _segment(selected)
            draw_line(self.drawn_map, p0, p1, k, self.size)

    def end_path(self) -> None:
        self.curr_path = [[] for _ in range(self.K + 1)]
        self.all_paths.append(self.curr_path)
        self.history.append(self.drawn_map.copy())
        self.surplus_history = True

    def predict(self):
        self.out_prob = self.controller.interact(self.image, self.prev_hard,
                                                 self.drawn_map)
        self.out_mask = aggregate_wbg(self.out_prob, keep_bg=True, hard=True)
        return self.out_mask

    def undo(self):
        if self.surplus_history:
            self.history.pop()
            self.surplus_history = False
        self.drawn_map = self.history.pop()
        self.all_paths = self.all_paths[:-2]
        self.curr_path = [[] for _ in range(self.K + 1)]
        self.all_paths.append(self.curr_path)
        return self.predict()

    def can_undo(self) -> bool:
        return len(self.history) > 0 and not (
            self.surplus_history and len(self.history) < 2)


class ClickInteraction(Interaction):
    """f-BRS click refinement of one object
    (reference interaction.py:265-335)."""

    def __init__(self, image, prev_mask, true_size, fbrs_controller,
                 tar_obj: int, pad):
        super().__init__(image, prev_mask, true_size, fbrs_controller)
        self.tar_obj = tar_obj
        self.pad = pad
        self.pos_clicks: List[Tuple[float, float]] = []
        self.neg_clicks: List[Tuple[float, float]] = []
        self.out_prob = prev_mask
        self.obj_mask = None
        self.surplus_history = False

    def push_point(self, x: float, y: float, neg: bool) -> None:
        (self.neg_clicks if neg else self.pos_clicks).append((x, y))
        # The controller works on the padded grid (interaction.py:290).
        self.obj_mask = self.controller.interact(
            self.image, x + self.pad[0], y + self.pad[2], not neg)
        self.history.append(deepcopy((self.pos_clicks, self.neg_clicks)))
        self.surplus_history = True

    def predict(self):
        if self.obj_mask is None:
            self.out_prob = self.prev_mask
        else:
            obj = torch.as_tensor(self.obj_mask).to(self.prev_mask.device)
            if obj.ndim == 2:
                obj = obj[..., None]
            # A new tensor, as the JAX `.at[].set`: prev_mask may be
            # another interaction's output.
            out = self.out_prob.clone()
            out[self.tar_obj - 1] = obj
            self.out_prob = out
        self.out_mask = aggregate_sbg(self.out_prob, keep_bg=True, hard=True)
        return self.out_mask

    def undo(self):
        if self.surplus_history:
            self.history.pop()
            self.surplus_history = False
        self.pos_clicks, self.neg_clicks = self.history.pop()
        self.obj_mask = self.controller.undo()
        return self.predict()

    def can_undo(self) -> bool:
        return len(self.history) > 0 and not (
            self.surplus_history and len(self.history) < 2)


class CropperInteraction(Interaction):
    """Global map -> local crop for local-control mode
    (reference interaction.py:73-94). bounding_box = (lx, ux, ly, uy)
    on the UNPADDED grid."""

    def __init__(self, image, prev_mask, pad, bounding_box):
        lx, ux, ly, uy = bounding_box
        super().__init__(image, prev_mask, (uy - ly + 1, ux - lx + 1))
        self.bounding_box = bounding_box

        crop = unpad(prev_mask, pad)[:, ly:uy + 1, lx:ux + 1]
        self.out_prob, self.pad = pad_divide_by(crop, 16)
        self.out_mask = aggregate_sbg(self.out_prob, keep_bg=True)

        im_crop = unpad(image, pad)[ly:uy + 1, lx:ux + 1]
        self.im_crop, _ = pad_divide_by(im_crop, 16)

    def can_undo(self) -> bool:
        return False

    def predict(self):
        return self.out_mask


class LocalInteraction(Interaction):
    """Stitch a local-region result back into the global mask with a
    3px margin trim (reference interaction.py:45-71)."""

    def __init__(self, image, prev_mask, true_size, bounding_box,
                 region_prob, pad, local_pad):
        super().__init__(image, prev_mask, true_size)
        lx, ux, ly, uy = bounding_box
        out = unpad(prev_mask, pad).clone()
        region = unpad(region_prob, local_pad)
        if (ux - lx) > 6 and (uy - ly) > 6:
            out[:, ly + 3:uy - 2, lx + 3:ux - 2] = region[:, 3:-3, 3:-3]
        else:
            out[:, ly:uy + 1, lx:ux + 1] = region
        self.out_prob, _ = pad_divide_by(out, 16)
        self.out_mask = aggregate_sbg(self.out_prob, keep_bg=True)
        self.storage = None

    def can_undo(self) -> bool:
        return False

    def predict(self):
        return self.out_mask
