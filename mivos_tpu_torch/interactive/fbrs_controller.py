"""Interactive click controllers (counterpart of
mivos_tpu/interactive/fbrs_controller.py).

InteractiveController (reference fbrs/controller.py): click, undo,
partially finish and finish, with probs_history pairs (committed,
additive). FBRSController (reference interact/fbrs_controller.py): the
GUI-facing wrapper with the per-frame `anchored` latch and the f-BRS-B
settings (ZoomIn target 480, expansion 1.4, 8-click net limit, L-BFGS
maxiter 20). The model is either f-BRS family (FBRSDeepLabModel or
FBRSHRNetModel); on HRNet, f-BRS-B scales the stride-4 features
(insertion 'A'). Probability maps are kept on the host as (H, W) arrays.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mivos_tpu_torch.interactive.clicker import Click, Clicker
from mivos_tpu_torch.interactive.fbrs_predictor import (FBRSModel,
                                                        FeatureBRSPredictor,
                                                        ZoomIn)


class InteractiveController:
    def __init__(self, net: FBRSModel, prob_thresh: float = 0.5,
                 zoom_target: int = 480, zoom_expand: float = 1.4,
                 net_clicks_limit: int = 8, lbfgs_maxfun: int = 20,
                 device: torch.device | str = "cuda"):
        self.net = net
        self.device = torch.device(device)
        self.prob_thresh = prob_thresh
        self._pred_cfg = dict(zoom_target=zoom_target, zoom_expand=zoom_expand,
                              net_clicks_limit=net_clicks_limit,
                              lbfgs_maxfun=lbfgs_maxfun)
        self.clicker = Clicker()
        self.states: List = []
        self.probs_history: List = []
        self.object_count = 0
        self._result_mask: Optional[np.ndarray] = None
        self.image = None
        self.predictor: Optional[FeatureBRSPredictor] = None
        self.reset_predictor()

    def set_image(self, image) -> None:
        """image: (H, W, 3) normalized, numpy or tensor."""
        self.image = image
        self._result_mask = np.zeros(tuple(image.shape[:2]), np.uint8)
        self.object_count = 0
        self.reset_last_object()

    def add_click(self, x: float, y: float, is_positive: bool) -> None:
        self.states.append({"clicker": self.clicker.get_state(),
                            "predictor": self.predictor.get_states()})
        self.clicker.add_click(Click(is_positive=is_positive, coords=(y, x)))
        pred = self.predictor.get_prediction(self.clicker).cpu().numpy()
        if self.probs_history:
            self.probs_history.append((self.probs_history[-1][0], pred))
        else:
            self.probs_history.append((np.zeros_like(pred), pred))

    def undo_click(self) -> None:
        if not self.states:
            return
        prev = self.states.pop()
        self.clicker.set_state(prev["clicker"])
        self.predictor.set_states(prev["predictor"])
        self.probs_history.pop()

    def partially_finish_object(self) -> None:
        prob = self.current_object_prob
        if prob is None:
            return
        self.probs_history.append((prob, np.zeros_like(prob)))
        self.states.append(self.states[-1])
        self.clicker.reset_clicks()
        self.reset_predictor()

    def finish_object(self) -> None:
        prob = self.current_object_prob
        if prob is None:
            return
        self.object_count += 1
        self._result_mask[prob > self.prob_thresh] = self.object_count
        self.reset_last_object()

    def reset_last_object(self) -> None:
        self.states = []
        self.probs_history = []
        self.clicker.reset_clicks()
        self.reset_predictor()

    def reset_predictor(self) -> None:
        cfg = self._pred_cfg
        self.predictor = FeatureBRSPredictor(
            self.net,
            zoom_in=ZoomIn(target_size=cfg["zoom_target"],
                           expansion_ratio=cfg["zoom_expand"],
                           skip_clicks=1),
            net_clicks_limit=cfg["net_clicks_limit"],
            maxiter=cfg["lbfgs_maxfun"], device=self.device)
        if self.image is not None:
            self.predictor.set_input_image(self.image)

    @property
    def current_object_prob(self) -> Optional[np.ndarray]:
        if self.probs_history:
            total, additive = self.probs_history[-1]
            return np.maximum(total, additive)
        return None

    @property
    def is_incomplete_mask(self) -> bool:
        return len(self.probs_history) > 0

    @property
    def result_mask(self) -> np.ndarray:
        return self._result_mask.copy()


class FBRSController:
    """GUI-facing wrapper (reference interact/fbrs_controller.py:6-53)."""

    def __init__(self, net: FBRSModel,
                 device: torch.device | str = "cuda"):
        self.controller = InteractiveController(net, prob_thresh=0.5,
                                                device=device)
        self.anchored = False

    def unanchor(self) -> None:
        self.anchored = False

    def interact(self, image, x: float, y: float,
                 is_positive: bool) -> np.ndarray:
        """image: (H, W, 3) normalized. Returns the hard mask (H, W)
        float32."""
        if not self.anchored:
            self.controller.set_image(image)
            self.controller.reset_predictor()
            self.anchored = True
        self.controller.add_click(x, y, is_positive)
        return (self.controller.probs_history[-1][1] > 0.5).astype(np.float32)

    def undo(self) -> Optional[np.ndarray]:
        self.controller.undo_click()
        if len(self.controller.probs_history) == 0:
            return None
        return (self.controller.probs_history[-1][1] > 0.5).astype(np.float32)
