"""Headless interactive-session orchestration behind the GUI (counterpart
of mivos_tpu/interactive/gui_session.py).

Everything the reference GUI (interactive_gui.py, PyQt5) does that is
not widget plumbing lives here: frame navigation, interaction routing
and lifecycle, undo stacks, overlay composition, local-control crop and
stitch, propagation with progress callbacks, and mask/overlay saving.
A widget layer is a thin event router over this class.

Reference mapping:
  set_interaction_mode / push_point / end_path  <- on_press/motion/release
  run_propagation                               <- on_run (:542)
  undo                                          <- on_undo (:587-634)
  enter_local / finish_local                    <- :731-777, :662-686
  compose_frame                                 <- compose_current_im (:375)
  save                                          <- :325-345

Nothing here runs under torch.no_grad(): the f-BRS click optimizes
through autograd (InferenceCore and S2MController turn gradients off
for their own calls).
"""
from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.data.transforms import im_denormalize
from mivos_tpu_torch.interactive.interaction import (ClickInteraction,
                                                     CropperInteraction,
                                                     FreeInteraction,
                                                     Interaction,
                                                     LocalInteraction,
                                                     ScribbleInteraction)
from mivos_tpu_torch.ops.aggregate import aggregate_sbg
from mivos_tpu_torch.utils.palette import overlay_davis, save_indexed_png
from mivos_tpu_torch.utils.tensor import unpad
from mivos_tpu_torch.utils.timer import Timer


def _overlay(rgb: np.ndarray, mask: np.ndarray, viz_mode: str) -> np.ndarray:
    if viz_mode == "davis":
        return overlay_davis(rgb, mask)
    if viz_mode == "fade":
        return overlay_davis(rgb, mask, fade=True)
    return overlay_davis(rgb, mask, alpha=0.9)


class GuiSession:
    def __init__(self, prop_net, fuse_net, s2m_controller, fbrs_controller,
                 images, num_objects: int, mem: MemoryConfig = MemoryConfig(),
                 device: torch.device | str = "cuda"):
        """images: (T, h, w, 3) normalized (or uint8 RGB), UNPADDED."""
        self.s2m_controller = s2m_controller
        self.fbrs_controller = fbrs_controller
        self.num_objects = num_objects
        self.processor = InferenceCore(prop_net, fuse_net, images,
                                       num_objects, mem=mem, device=device)
        self.t = self.processor.t
        self.height, self.width = self.processor.h, self.processor.w

        self.cursur = 0
        self.current_object = 1
        self.brush_size = 3
        self.viz_mode = "davis"            # davis | fade | light

        self.interaction: Optional[Interaction] = None
        self.this_frame_interactions: List[Interaction] = []
        self.interacted_mask = None

        # local-control state (:731-777)
        self.in_local_mode = False
        self.local_bb = None
        self.local_interaction: Optional[Interaction] = None
        self.local_interactions: dict = {}

        # minimap/zoom state (reference :150-160, :284, :422-443):
        # a square patch of zoom_pixels around the last cursor position,
        # clamped inside the frame. Zoom + shrinks the window.
        self.zoom_pixels = 150
        self.last_ex = 0
        self.last_ey = 0
        self._minimap_local_snapshot: Optional[np.ndarray] = None

        self.algo_timer = Timer()
        self.user_timer = Timer().start()

    # ----- frame data -----

    def current_image(self) -> torch.Tensor:
        """(nh, nw, 3) PADDED normalized image of the current frame."""
        return self.processor.get_image(self.cursur)

    def current_mask(self) -> np.ndarray:
        return self.processor.np_masks[self.cursur]

    def current_prob_fg(self) -> torch.Tensor:
        """(K, nh, nw, 1) padded foreground probabilities."""
        return self.processor.get_prob(self.cursur)[1:].movedim(1, -1)

    def compose_frame(self, frame_rgb01: Optional[np.ndarray] = None
                      ) -> np.ndarray:
        """Overlay the current mask on the current frame
        (reference compose_current_im :375-393)."""
        if frame_rgb01 is None:
            img = unpad(self.current_image(), self.processor.pad)
            frame_rgb01 = im_denormalize(img.cpu().numpy())
        image = (frame_rgb01 * 255).astype(np.uint8)
        return _overlay(image, self.current_mask(), self.viz_mode)

    def compose_local_frame(self) -> np.ndarray:
        """Overlay for the local-control crop canvas (reference draws
        the cropped region while in local mode, :731-777)."""
        assert self.in_local_mode
        cropper = self.local_interactions["interact"][0]
        last = self.local_interactions["interact"][-1]
        img = unpad(cropper.im_crop, cropper.pad).cpu().numpy()
        rgb = (np.clip(im_denormalize(img), 0, 1) * 255).astype(np.uint8)
        agg = aggregate_sbg(last.out_prob, keep_bg=True)
        lab = unpad(agg, cropper.pad)[..., 0].argmax(0)
        return _overlay(rgb, lab.to(torch.uint8).cpu().numpy(), self.viz_mode)

    # ----- minimap / zoom (reference :422-443, :644-652) -----

    def set_cursor_pos(self, ex: float, ey: float) -> None:
        """Track the last pointer position (reference on_motion keeps
        last_ex/last_ey); the minimap window follows it."""
        self.last_ex, self.last_ey = float(ex), float(ey)

    def zoom_in(self) -> int:
        """Zoom + : smaller window (reference on_zoom_plus :644-647)."""
        self.zoom_pixels = max(50, self.zoom_pixels - 25)
        return self.zoom_pixels

    def zoom_out(self) -> int:
        """Zoom - : larger window (reference on_zoom_minus :649-652)."""
        self.zoom_pixels = min(300, self.zoom_pixels + 25)
        return self.zoom_pixels

    def zoom_rect(self) -> Tuple[int, int, int, int]:
        """(y0, y1, x0, x1) of the minimap window: a zoom_pixels square
        centered on the cursor, clamped fully inside the frame
        (reference update_minimap :430-434; a window larger than the
        frame covers the whole frame)."""
        r = self.zoom_pixels // 2
        ex = int(round(max(r, min(self.width - r, self.last_ex))))
        ey = int(round(max(r, min(self.height - r, self.last_ey))))
        return (max(0, ey - r), min(self.height, ey + r),
                max(0, ex - r), min(self.width, ex + r))

    def minimap_patch(self, viz: Optional[np.ndarray] = None) -> np.ndarray:
        """The minimap image: the zoom window of the composed frame --
        or, in local-control mode, the frozen pre-local snapshot so the
        user keeps the global context (reference :424-436)."""
        if self.in_local_mode and self._minimap_local_snapshot is not None:
            return self._minimap_local_snapshot
        if viz is None:
            viz = self.compose_frame()
        y0, y1, x0, x1 = self.zoom_rect()
        return viz[y0:y1, x0:x1]

    # ----- navigation -----

    def goto(self, idx: int) -> None:
        self.complete_interaction()
        self.cursur = int(np.clip(idx, 0, self.t - 1))
        self.interaction = None
        self.this_frame_interactions = []

    def set_object(self, number: int) -> None:
        """Hotkey 1..K (reference hit_number_key :688-698)."""
        if number == self.current_object:
            return
        assert 1 <= number <= self.num_objects
        self.current_object = number
        if self.fbrs_controller is not None:
            self.fbrs_controller.unanchor()

    # ----- interaction lifecycle -----

    def _image_and_prev(self):
        if self.in_local_mode:
            cropper = self.local_interactions["interact"][0]
            last = self.local_interactions["interact"][-1]
            return (cropper.im_crop, last.out_prob, cropper.h, cropper.w,
                    cropper.pad)
        if self.interaction is not None and \
                self.interaction.out_prob is not None:
            prev_soft = self.interaction.out_prob
        elif self.this_frame_interactions:
            prev_soft = self.this_frame_interactions[-1].out_prob
        else:
            prev_soft = self.current_prob_fg()
        return (self.current_image(), prev_soft, self.height, self.width,
                self.processor.pad)

    def start_interaction(self, mode: str) -> Interaction:
        """mode: 'scribble' | 'free' | 'click'. Creates (or reuses) the
        active interaction (reference on_press :833-861)."""
        last = self.local_interaction if self.in_local_mode \
            else self.interaction
        image, prev_soft, h, w, pad = self._image_and_prev()

        new: Optional[Interaction] = None
        if mode == "scribble":
            if last is None or not isinstance(last, ScribbleInteraction):
                self.complete_interaction()
                new = ScribbleInteraction(image, self._padded_hard_mask(),
                                          (h, w), self.s2m_controller,
                                          self.num_objects)
        elif mode == "free":
            if last is None or not isinstance(last, FreeInteraction):
                self.complete_interaction()
                new = FreeInteraction(image, prev_soft, (h, w),
                                      self.num_objects, pad)
                new.set_size(self.brush_size)
        elif mode == "click":
            if (last is None or not isinstance(last, ClickInteraction)
                    or last.tar_obj != self.current_object):
                self.complete_interaction()
                self.fbrs_controller.unanchor()
                new = ClickInteraction(image, prev_soft, (h, w),
                                       self.fbrs_controller,
                                       self.current_object, pad)
        else:
            raise ValueError(mode)

        if new is not None:
            if self.in_local_mode:
                self.local_interaction = new
                self.local_interactions.setdefault("interact", []).append(new)
            else:
                self.interaction = new
        return self.local_interaction if self.in_local_mode \
            else self.interaction

    def _padded_hard_mask(self) -> np.ndarray:
        lab = np.zeros((self.processor.nh, self.processor.nw), np.uint8)
        lw, uw, lh, uh = self.processor.pad
        lab[lh:self.processor.nh - uh,
            lw:self.processor.nw - uw] = self.current_mask()
        return lab

    def _active(self) -> Interaction:
        it = self.local_interaction if self.in_local_mode \
            else self.interaction
        assert it is not None, "no active interaction"
        return it

    def push_point(self, x: float, y: float, arg) -> None:
        self._active().push_point(x, y, arg)

    def end_path(self) -> None:
        it = self._active()
        if hasattr(it, "end_path"):
            it.end_path()

    def predict(self) -> np.ndarray:
        """Run the active interaction's model and store the result
        (reference update_interacted_mask :889-897)."""
        self.algo_timer.start()
        self.interacted_mask = self._active().predict()
        if not self.in_local_mode:
            self.processor.update_mask_only(
                self._unpadded(self.interacted_mask), self.cursur)
        self.algo_timer.pause()
        return self.current_mask()

    def _unpadded(self, padded_prob: torch.Tensor) -> torch.Tensor:
        """(K+1, nh, nw, 1) -> (K+1, h, w, 1): the raw-grid mask
        InferenceCore takes."""
        return unpad(padded_prob, self.processor.pad)

    def undo(self) -> bool:
        """(reference on_undo :587-634)."""
        it = self.local_interaction if self.in_local_mode \
            else self.interaction
        if it is not None and it.can_undo():
            self.interacted_mask = it.undo()
            if not self.in_local_mode:
                self.processor.update_mask_only(
                    self._unpadded(self.interacted_mask), self.cursur)
            return True
        return False

    def complete_interaction(self) -> None:
        """Archive the live interaction (reference :899-913)."""
        if self.in_local_mode:
            self.local_interaction = None
        elif self.interaction is not None:
            self.this_frame_interactions.append(self.interaction)
            self.interaction = None

    # ----- local control (:731-777, :662-686) -----

    def enter_local(self, bounding_box: Tuple[int, int, int, int]) -> None:
        lx, ux, ly, uy = bounding_box
        assert 0 <= lx < ux < self.width and 0 <= ly < uy < self.height
        self.complete_interaction()
        # Freeze the minimap at the pre-local view (reference
        # minimap_in_local, :424-428).
        self._minimap_local_snapshot = self.compose_frame()
        self.in_local_mode = True
        self.local_bb = bounding_box
        prev = (self.this_frame_interactions[-1].out_prob
                if self.this_frame_interactions else self.current_prob_fg())
        cropper = CropperInteraction(self.current_image(), prev,
                                     self.processor.pad, bounding_box)
        self.local_interactions = {"interact": [cropper]}
        self.local_interaction = None

    def finish_local(self) -> np.ndarray:
        assert self.in_local_mode
        self.complete_interaction()
        self.in_local_mode = False
        self._minimap_local_snapshot = None
        prev = (self.this_frame_interactions[-1].out_prob
                if self.this_frame_interactions else self.current_prob_fg())
        cropper = self.local_interactions["interact"][0]
        region = self.local_interactions["interact"][-1]
        stitched = LocalInteraction(
            self.current_image(), prev, (self.height, self.width),
            self.local_bb, region.out_prob, self.processor.pad,
            cropper.pad)
        stitched.storage = self.local_interactions
        self.interaction = stitched
        self.interacted_mask = stitched.predict()
        self.processor.update_mask_only(
            self._unpadded(self.interacted_mask), self.cursur)
        self.complete_interaction()
        return self.current_mask()

    # ----- propagation (:542-559) -----

    def run_propagation(self,
                        total_cb: Optional[Callable] = None,
                        step_cb: Optional[Callable] = None) -> np.ndarray:
        assert self.interacted_mask is not None, "interact first"
        self.algo_timer.start()
        self.user_timer.pause()
        masks = self.processor.interact(
            self._unpadded(self.interacted_mask), self.cursur,
            total_cb=total_cb, step_cb=step_cb)
        self.interacted_mask = None
        self.this_frame_interactions = []
        self.algo_timer.pause()
        self.user_timer.start()
        return masks

    def status_prefix(self) -> str:
        return f"[A: {self.algo_timer}, U: {self.user_timer}]"

    # ----- saving (:325-345) -----

    def save_masks(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        for ti in range(self.t):
            save_indexed_png(os.path.join(folder, f"{ti:05d}.png"),
                             self.processor.np_masks[ti])

    def save_overlays(self, folder: str) -> None:
        from PIL import Image

        os.makedirs(folder, exist_ok=True)
        cursur = self.cursur
        try:
            for ti in range(self.t):
                self.cursur = ti
                Image.fromarray(self.compose_frame()).save(
                    os.path.join(folder, f"{ti:05d}.png"))
        finally:
            self.cursur = cursur
