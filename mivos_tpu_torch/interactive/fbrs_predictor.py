"""f-BRS-B predictor: feature-space scale/bias optimization on the
device (counterpart of mivos_tpu/interactive/fbrs_predictor.py;
reference fbrs/inference/predictors/{base,brs,brs_functors,brs_losses}.py
and transforms/{zoom_in,flip,limit_longest_side}.py).

Per click:

  ZoomIn crop -> [image, flipped image] batch -> cached after-ASPP
  features (no autograd) -> L-BFGS over (scale, bias) through the small
  head replay (autograd) -> sigmoid -> unflip-average -> paste back into
  the full frame.

ZoomIn rounds crop sizes up to multiples of 32 as the JAX package does;
that changes the crop's aspect, and so the output. The JAX package's
click-count padding and jit caches are XLA workarounds and are not
ported: unused click rows have distance 1e6, so no result depends on
them. Tensors are NCHW on the predictor's device; the frame enters as
(H, W, 3) and the probability map leaves as (H, W).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from mivos_tpu_torch.interactive.clicker import Click
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.ops.distmaps import pad_points
from mivos_tpu_torch.ops.lbfgs import lbfgs_minimize
from mivos_tpu_torch.ops.resize import bilinear_resize_align_corners as up_ac

# brs.py / brs_functors.py settings of f-BRS-B, as the JAX package runs
# them (fbrs_predictor.py:49-52).
REG_WEIGHT, REG_BIAS_WEIGHT = 1e-3, 10.0
PROB_THRESH, MIN_IOU_DIFF = 0.49, 0.01
LBFGS_MEMORY = 20
# ZoomIn (reference zoom_in.py): the previous map is cut at this
# probability to find the object, and the crop is recomputed when the
# new box overlaps the old one by less than this IoU.
ZOOM_PROB_THRESH, ZOOM_RECOMPUTE_IOU = 0.5, 0.5
_UNPORTED = "(ROADMAP queue 1, item 8)"


def fbrs_objective(net: FBRSDeepLabModel, feats: torch.Tensor,
                   pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                   out_hw: Tuple[int, int]):
    """The f-BRS-B objective over x = (scale - 1, bias) of the cached head
    input (fbrs_predictor.py:76-109). feats: (2, C, h, w) after-ASPP
    features of [image, flipped image]; pos/neg_mask: (1, 1, H, W) click
    maps. Returns (predict, loss_fn): predict(x) -> (2, 1, H, W) logits;
    loss_fn(x) -> (loss, (max positive miss, max negative miss, mask))."""
    c = feats.shape[1]

    def predict(x):
        scaled = (feats * (1.0 + x[:c])[None, :, None, None]
                  + x[c:][None, :, None, None])
        return net.head_replay(scaled, out_hw)

    def loss_fn(x):
        result = torch.sigmoid(predict(x))
        # flip-average (brs_functors.py:51-54)
        r = 0.5 * (result[:1] + torch.flip(result[1:], dims=[-1]))
        pos_diff = (1.0 - r) * pos_mask
        neg_diff = r * neg_mask
        # BRSMaskLoss (brs_losses.py:11-26)
        loss = ((pos_diff ** 2).sum() / (pos_mask.sum() + 1e-5)
                + (neg_diff ** 2).sum() / (neg_mask.sum() + 1e-5))
        reg = REG_WEIGHT * ((x[:c] ** 2).sum()
                            + REG_BIAS_WEIGHT * (x[c:] ** 2).sum())
        aux = (pos_diff.detach().abs().max(), neg_diff.detach().abs().max(),
               (r.detach() > PROB_THRESH)[0, 0])
        return loss + reg, aux

    return predict, loss_fn


def _clicks_met_or_converged(aux, last_mask):
    """f-BRS's early exit (brs_functors.py:56-77): every click satisfied,
    or the mask within min_iou_diff of the last iterate's."""
    f_max_pos, f_max_neg, mask = aux
    clicks_ok = (f_max_pos < 1 - PROB_THRESH) & (f_max_neg < PROB_THRESH)
    inter = (mask & last_mask).sum()
    union = (mask | last_mask).sum()
    converged = inter / union.clamp(min=1) > 1 - MIN_IOU_DIFF
    return clicks_ok | converged, mask


def fbrs_optimize(net: FBRSDeepLabModel, feats: torch.Tensor,
                  pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                  x0: torch.Tensor, out_hw: Tuple[int, int],
                  maxiter: int = 20):
    """L-BFGS over the (scale, bias) of the cached head input
    (fbrs_predictor.py:76-122), from x0 (2C,). Returns (best_x, logits at
    best_x (2, 1, H, W), info of lbfgs_minimize)."""
    predict, loss_fn = fbrs_objective(net, feats, pos_mask, neg_mask, out_hw)
    last_mask0 = torch.zeros(tuple(out_hw), dtype=torch.bool,
                             device=feats.device)
    best_x, info = lbfgs_minimize(loss_fn, x0, maxiter=maxiter,
                                  memory_size=LBFGS_MEMORY,
                                  stop_fn=_clicks_met_or_converged,
                                  stop_state0=last_mask0)
    with torch.no_grad():
        return best_x, predict(best_x), info


# ---------------------------------------------------------------------------
# ZoomIn (host logic; reference transforms/zoom_in.py)
# ---------------------------------------------------------------------------

def _bbox_from_mask(mask: np.ndarray) -> Tuple[int, int, int, int]:
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return rmin, rmax, cmin, cmax


def _expand_bbox(bbox, expand_ratio, min_crop_size):
    rmin, rmax, cmin, cmax = bbox
    rcenter = 0.5 * (rmin + rmax)
    ccenter = 0.5 * (cmin + cmax)
    height = expand_ratio * (rmax - rmin + 1)
    width = expand_ratio * (cmax - cmin + 1)
    height = max(height, min_crop_size)
    width = max(width, min_crop_size)
    return (int(round(rcenter - 0.5 * height)),
            int(round(rcenter + 0.5 * height)),
            int(round(ccenter - 0.5 * width)),
            int(round(ccenter + 0.5 * width)))


def _clamp_bbox(bbox, rmin, rmax, cmin, cmax):
    return (max(rmin, bbox[0]), min(rmax, bbox[1]),
            max(cmin, bbox[2]), min(cmax, bbox[3]))


def _bbox_iou(b1, b2) -> float:
    h_i = max(min(b1[1], b2[1]) - max(b1[0], b2[0]) + 1, 0)
    w_i = max(min(b1[3], b2[3]) - max(b1[2], b2[2]) + 1, 0)
    inter = h_i * w_i
    a1 = (b1[1] - b1[0] + 1) * (b1[3] - b1[2] + 1)
    a2 = (b2[1] - b2[0] + 1) * (b2[3] - b2[2] + 1)
    return inter / max(a1 + a2 - inter, 1)


class ZoomIn:
    """Crop-to-object transform (reference zoom_in.py:8-124). The crop
    is resized so its longer side is target_size, each side rounded up
    to a multiple of 32."""

    def __init__(self, target_size: int = 480, skip_clicks: int = 1,
                 expansion_ratio: float = 1.4, min_crop_size: int = 200):
        self.target_size = target_size
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.min_crop_size = min_crop_size
        self.reset()

    def reset(self):
        self._input_hw = None
        self._prev_probs: Optional[torch.Tensor] = None  # (1, 1, H, W)
        self._object_roi = None
        self._roi_image = None
        self.image_changed = False

    def _roi_out_size(self, height, width):
        scale = self.target_size / max(height, width)
        nh = int(round(height * scale))
        nw = int(round(width * scale))
        bucket = lambda v: max(32, int(np.ceil(v / 32) * 32))
        return bucket(nh), bucket(nw)

    def transform(self, image: torch.Tensor, clicks: List[Click]):
        """image: (1, 3, H, W). Returns (network input, its clicks)."""
        self.image_changed = False
        if len(clicks) <= self.skip_clicks:
            return image, clicks
        self._input_hw = tuple(image.shape[-2:])

        current_roi = None
        if self._prev_probs is not None:
            pred = (self._prev_probs[0, 0] > ZOOM_PROB_THRESH).cpu().numpy()
            if pred.sum() > 0:
                for c in clicks:
                    if c.is_positive:
                        pred[int(c.coords[0]), int(c.coords[1])] = 1
                bbox = _expand_bbox(_bbox_from_mask(pred),
                                    self.expansion_ratio, self.min_crop_size)
                h, w = pred.shape
                current_roi = _clamp_bbox(bbox, 0, h - 1, 0, w - 1)
        if current_roi is None:
            return image, clicks

        update = (self._object_roi is None
                  or not self._clicks_inside(clicks)
                  or _bbox_iou(current_roi, self._object_roi)
                  < ZOOM_RECOMPUTE_IOU)
        if update:
            self._object_roi = current_roi
            rmin, rmax, cmin, cmax = current_roi
            crop = image[..., rmin:rmax + 1, cmin:cmax + 1]
            out_hw = self._roi_out_size(rmax - rmin + 1, cmax - cmin + 1)
            self._roi_image = up_ac(crop, out_hw)
            self.image_changed = True

        return self._roi_image, self._transform_clicks(clicks)

    def _clicks_inside(self, clicks) -> bool:
        r = self._object_roi
        for c in clicks:
            if c.is_positive:
                if not (r[0] <= c.coords[0] < r[1] and
                        r[2] <= c.coords[1] < r[3]):
                    return False
        return True

    def _transform_clicks(self, clicks):
        if self._object_roi is None:
            return clicks
        rmin, rmax, cmin, cmax = self._object_roi
        ch, cw = self._roi_image.shape[-2:]
        return [Click(c.is_positive,
                      (ch * (c.coords[0] - rmin) / (rmax - rmin + 1),
                       cw * (c.coords[1] - cmin) / (cmax - cmin + 1)))
                for c in clicks]

    def inv_transform(self, prob: torch.Tensor) -> torch.Tensor:
        """prob: (1, 1, h, w) probabilities at crop resolution ->
        (1, 1, H, W) on the frame."""
        if self._object_roi is None:
            self._prev_probs = prob
            return prob
        rmin, rmax, cmin, cmax = self._object_roi
        prob = up_ac(prob, (rmax - rmin + 1, cmax - cmin + 1))
        new = prob.new_zeros((1, 1) + tuple(self._input_hw))
        new[..., rmin:rmax + 1, cmin:cmax + 1] = prob
        self._prev_probs = new
        return new

    def get_state(self):
        return (self._input_hw, self._object_roi, self._prev_probs,
                self._roi_image, self.image_changed)

    def set_state(self, state):
        (self._input_hw, self._object_roi, self._prev_probs,
         self._roi_image, self.image_changed) = state


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------

class FeatureBRSPredictor:
    """Feature-space BRS over a DistMaps model (reference brs.py:54-140),
    always with flip and flip-averaging, scale and bias inserted after
    the ASPP (f-BRS-B, insertion_mode 'after_aspp'; f-BRS-A/C and HRNet
    are not ported yet). The net moves to `device` and its weights
    stop requiring gradients: autograd runs only toward (scale, bias).
    Call get_prediction outside torch.inference_mode (the optimization
    needs autograd)."""

    def __init__(self, net: FBRSDeepLabModel,
                 zoom_in: Optional[ZoomIn] = None,
                 net_clicks_limit: int = 8,
                 optimize_after_n_clicks: int = 1,
                 maxiter: int = 20,
                 max_size: Optional[int] = None,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.zoom_in = zoom_in
        self.net_clicks_limit = net_clicks_limit
        self.optimize_after_n_clicks = optimize_after_n_clicks
        self.maxiter = maxiter
        # LimitLongestSide (reference transforms/limit_longest_side.py):
        # downscale oversize inputs before prediction, invert at the end.
        self.max_size = max_size
        self._limit_scale = 1.0
        self._orig_hw = None
        self.original_image = None
        self.opt_data = None
        self.input_data = None
        self._input_key = None
        self.last_info: dict = {}

    def set_input_image(self, image) -> None:
        """image: (H, W, 3) normalized, numpy or tensor."""
        if self.zoom_in is not None:
            self.zoom_in.reset()
        image = torch.as_tensor(image).to(self.device, torch.float32)
        image = image.permute(2, 0, 1)[None]
        self._orig_hw = tuple(image.shape[-2:])
        self._limit_scale = 1.0
        if self.max_size is not None:
            longest = max(self._orig_hw)
            if longest > self.max_size:
                self._limit_scale = self.max_size / longest
                nh = int(round(self._orig_hw[0] * self._limit_scale))
                nw = int(round(self._orig_hw[1] * self._limit_scale))
                image = up_ac(image, (nh, nw))
        self.original_image = image
        self.opt_data = None
        self.input_data = None
        self._input_key = None

    def _points_nd(self, clicks: List[Click]) -> torch.Tensor:
        clicks = clicks[:self.net_clicks_limit]
        pos = [c.coords for c in clicks if c.is_positive]
        neg = [c.coords for c in clicks if not c.is_positive]
        return pad_points(pos, neg, max(len(pos), len(neg), 1), self.device)

    def _clicks_maps(self, clicks: List[Click], hw):
        """Positive and negative click maps for the loss: a 3x3 square
        of ones at each click (mivos_tpu/interactive/fbrs_predictor.py:379)."""
        radius = 1
        pos = np.zeros((1, 1) + tuple(hw), np.float32)
        neg = np.zeros((1, 1) + tuple(hw), np.float32)
        for c in clicks:
            y, x = int(round(c.coords[0])), int(round(c.coords[1]))
            t = pos if c.is_positive else neg
            t[..., max(0, y - radius): y + radius + 1,
              max(0, x - radius): x + radius + 1] = 1.0
        return (torch.from_numpy(pos).to(self.device),
                torch.from_numpy(neg).to(self.device))

    def get_prediction(self, clicker) -> torch.Tensor:
        """-> (H, W) probability map of the full frame, on the device."""
        clicks = clicker.get_clicks()
        if self._limit_scale != 1.0:
            s = self._limit_scale
            clicks = [Click(c.is_positive,
                            (c.coords[0] * s, c.coords[1] * s))
                      for c in clicks]
        image = self.original_image
        tclicks = clicks
        if self.zoom_in is not None:
            image, tclicks = self.zoom_in.transform(image, clicks)
        h, w = image.shape[-2:]
        num_clicks = len(tclicks)

        points = self._points_nd(tclicks)
        # with_flip: batch = [image, hflip(image)], flipped clicks
        fpoints = points.clone()
        fpoints[..., 1] = torch.where(points[..., 1] >= 0,
                                      w - 1 - points[..., 1], -1.0)
        batch = torch.cat([image, torch.flip(image, dims=[-1])])
        bpoints = torch.cat([points, fpoints])

        feats_key = (h, w, int(points.shape[1]), num_clicks)
        recompute = (self.input_data is None or self._input_key is None
                     or self._input_key[:2] != (h, w)
                     or (self.zoom_in is not None
                         and self.zoom_in.image_changed)
                     or num_clicks <= self.net_clicks_limit)
        if recompute:
            with torch.no_grad():   # not inference_mode: autograd follows
                self.input_data = self.net.head_input(batch, bpoints)
            self._input_key = feats_key
        feats = self.input_data
        c = feats.shape[1]
        if self.opt_data is None or self.opt_data.shape[0] != 2 * c:
            self.opt_data = torch.zeros(2 * c, device=self.device)

        info = {"recomputed": recompute, "crop_hw": (h, w), "iters": 0,
                "evals": 0, "host_reads": 0}
        if num_clicks > self.optimize_after_n_clicks:
            pos_map, neg_map = self._clicks_maps(tclicks, (h, w))
            self.opt_data, logits, opt_info = fbrs_optimize(
                self.net, feats, pos_map, neg_map, self.opt_data, (h, w),
                self.maxiter)
            info.update(iters=opt_info["iters"], evals=opt_info["evals"],
                        host_reads=opt_info["host_reads"])
        else:
            # The full forward is head_replay of head_input, which is the
            # input just cached for these clicks.
            with torch.no_grad():
                logits = self.net.head_replay(feats, (h, w))
        self.last_info = info
        prob = torch.sigmoid(logits)
        # flip-average back to a single map
        prob = 0.5 * (prob[:1] + torch.flip(prob[1:], dims=[-1]))

        if self.zoom_in is not None:
            prob = self.zoom_in.inv_transform(prob)
        if self._limit_scale != 1.0:
            prob = up_ac(prob, self._orig_hw)
        return prob[0, 0]

    def get_states(self):
        return {
            "transform_states": (self.zoom_in.get_state()
                                 if self.zoom_in else None),
            "opt_data": self.opt_data,
            "input_data": self.input_data,
            "input_key": self._input_key,
        }

    def set_states(self, states):
        if self.zoom_in is not None and states["transform_states"] is not None:
            self.zoom_in.set_state(states["transform_states"])
        self.opt_data = states["opt_data"]
        self.input_data = states["input_data"]
        self._input_key = states["input_key"]


def get_predictor(net: FBRSDeepLabModel, brs_mode: str = "f-BRS-B",
                  zoom_in_params: Optional[dict] = None,
                  predictor_params: Optional[dict] = None,
                  device: torch.device | str = "cuda"):
    """Predictor by BRS mode (reference fbrs/inference/predictors/
    __init__.py:8-95): NoBRS (no online optimization) and f-BRS-B
    (scale/bias after ASPP)."""
    zoom_in = None
    if zoom_in_params is not None:
        zoom_in = ZoomIn(**zoom_in_params)
    kw = dict(predictor_params or {})
    kw.update(zoom_in=zoom_in, device=device)
    if brs_mode == "NoBRS":
        return FeatureBRSPredictor(net, optimize_after_n_clicks=10 ** 9, **kw)
    if brs_mode == "f-BRS-B":
        return FeatureBRSPredictor(net, **kw)
    if brs_mode in ("f-BRS-A", "f-BRS-C", "RGB-BRS", "DistMap-BRS"):
        raise NotImplementedError(f"BRS mode {brs_mode} is not ported yet "
                                  f"{_UNPORTED}")
    raise ValueError(f"unknown BRS mode {brs_mode}")
