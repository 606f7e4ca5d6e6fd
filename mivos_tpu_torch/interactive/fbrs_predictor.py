"""f-BRS predictors: feature-space scale/bias optimization (f-BRS-A, -B,
-C) and input-space bias optimization (RGB-BRS, DistMap-BRS) on the
device (counterpart of mivos_tpu/interactive/fbrs_predictor.py;
reference fbrs/inference/predictors/{base,brs,brs_functors,brs_losses}.py
and transforms/{zoom_in,flip,limit_longest_side}.py).

Per click, in the feature-space modes:

  ZoomIn crop -> [image, flipped image] batch -> cached head input at
  the mode's insertion point (no autograd) -> L-BFGS over (scale, bias)
  through the mode's head replay (autograd) -> sigmoid -> unflip-average
  -> paste back into the full frame.

The input-space modes optimize an additive bias on the RGB input or on
the click distance maps through the whole network instead. With a
ground-truth mask attached (`set_oracle_gt`), the feature-space modes
fit the mask itself (OracleMaskLoss) instead of the clicks.

ZoomIn rounds crop sizes up to multiples of 32 as the JAX package does;
that changes the crop's aspect, and so the output. The JAX package's
click-count padding and jit caches are XLA workarounds and are not
ported: unused click rows have distance 1e6, so no result depends on
them. Tensors are NCHW on the predictor's device; the frame enters as
(H, W, 3) and the probability map leaves as (H, W).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from mivos_tpu_torch.interactive.clicker import Click
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.hrnet import FBRSHRNetModel
from mivos_tpu_torch.ops.distmaps import pad_points
from mivos_tpu_torch.ops.lbfgs import lbfgs_minimize
from mivos_tpu_torch.ops.resize import bilinear_resize_align_corners as up_ac
from mivos_tpu_torch.train.fbrs_losses import sigmoid_bce_from_probs

FBRSModel = Union[FBRSDeepLabModel, FBRSHRNetModel]
HeadInput = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]

# brs.py / brs_functors.py settings, as the JAX package runs them
# (mivos_tpu/interactive/fbrs_predictor.py:56-58, 501-502, 542).
REG_WEIGHT, REG_BIAS_WEIGHT = 1e-3, 10.0
PROB_THRESH, MIN_IOU_DIFF = 0.49, 0.01
LBFGS_MEMORY = 20
INPUT_REG_WEIGHT, INPUT_LBFGS_MEMORY = 1e-4, 10
# OracleMaskLoss's stop: the loss moved less than this between two
# consecutive iterations (the JAX rule, not the reference's 5-step window).
ORACLE_PLATEAU = 1e-5
# ZoomIn (reference zoom_in.py): the previous map is cut at this
# probability to find the object, and the crop is recomputed when the
# new box overlaps the old one by less than this IoU.
ZOOM_PROB_THRESH, ZOOM_RECOMPUTE_IOU = 0.5, 0.5

# insertion mode -> (head-input method, replay method, input is a pair).
# DeepLab modes are the reference's brs.py:54-140 insertion points; 'A'
# and 'C' the HRNet ones (brs.py:143-225). For 'after_c4' the cached
# input is the pair (c4, projected c1): scale and bias apply to c4, c1
# stays constant.
INSERTION_MODES = {
    "after_aspp": ("head_input", "head_replay", False),
    "after_c4": ("head_input_c4", "head_replay_c4", True),
    "after_deeplab": ("head_input_deeplab", "head_replay_deeplab", False),
    "A": ("head_input", "head_replay", False),
    "C": ("head_input_ocr", "head_replay_cls", False),
}


def head_replay(net: FBRSModel, insertion_mode: str, head_input: HeadInput,
                out_hw: Tuple[int, int]) -> torch.Tensor:
    """The mode's replay of a head input -> (B, 1, h, w) logits; on the
    unscaled input it is the full forward."""
    _, method, pair = INSERTION_MODES[insertion_mode]
    replay = getattr(net, method)
    return replay(*head_input, out_hw) if pair else replay(head_input, out_hw)


def _scaled_predict(net: FBRSModel, insertion_mode: str,
                    head_input: HeadInput, out_hw: Tuple[int, int]):
    """predict(x) over x = (scale - 1, bias) of the head input's scaled
    tensor (c4 in the pair mode), and its channel count C."""
    pair = INSERTION_MODES[insertion_mode][2]
    feats = head_input[0] if pair else head_input
    c = feats.shape[1]

    def predict(x):
        scaled = (feats * (1.0 + x[:c])[None, :, None, None]
                  + x[c:][None, :, None, None])
        return head_replay(net, insertion_mode,
                           (scaled, head_input[1]) if pair else scaled, out_hw)

    return predict, c


def _scale_bias_reg(x: torch.Tensor, c: int) -> torch.Tensor:
    return REG_WEIGHT * ((x[:c] ** 2).sum() + REG_BIAS_WEIGHT * (x[c:] ** 2).sum())


def flip_average(prob: torch.Tensor) -> torch.Tensor:
    """(2B, 1, h, w) maps of [images, flipped images] -> (B, 1, h, w)
    (brs_functors.py:51-54)."""
    n = prob.shape[0] // 2
    return 0.5 * (prob[:n] + torch.flip(prob[n:], dims=[-1]))


def _click_loss(logits: torch.Tensor, pos_mask: torch.Tensor,
                neg_mask: torch.Tensor):
    """BRSMaskLoss (brs_losses.py:11-26) of the flip-averaged map, and the
    early-exit aux: (max positive miss, max negative miss, mask)."""
    r = flip_average(torch.sigmoid(logits))
    pos_diff = (1.0 - r) * pos_mask
    neg_diff = r * neg_mask
    loss = ((pos_diff ** 2).sum() / (pos_mask.sum() + 1e-5)
            + (neg_diff ** 2).sum() / (neg_mask.sum() + 1e-5))
    aux = (pos_diff.detach().abs().max(), neg_diff.detach().abs().max(),
           (r.detach() > PROB_THRESH)[0, 0])
    return loss, aux


def fbrs_objective(net: FBRSModel, head_input: HeadInput,
                   pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                   out_hw: Tuple[int, int], insertion_mode: str = "after_aspp"):
    """The f-BRS objective over x = (scale - 1, bias) of the cached head
    input (fbrs_predictor.py:76-109). head_input: the mode's head input of
    [image, flipped image] ((c4, c1) for 'after_c4'); pos/neg_mask:
    (1, 1, H, W) click maps. Returns (predict, loss_fn): predict(x) ->
    (2, 1, H, W) logits; loss_fn(x) -> (loss, (max positive miss, max
    negative miss, mask))."""
    predict, c = _scaled_predict(net, insertion_mode, head_input, out_hw)

    def loss_fn(x):
        loss, aux = _click_loss(predict(x), pos_mask, neg_mask)
        return loss + _scale_bias_reg(x, c), aux

    return predict, loss_fn


def _clicks_met(aux):
    f_max_pos, f_max_neg, _ = aux
    return (f_max_pos < 1 - PROB_THRESH) & (f_max_neg < PROB_THRESH)


def _clicks_met_or_converged(aux, last_mask):
    """f-BRS's early exit (brs_functors.py:56-77): every click satisfied,
    or the mask within min_iou_diff of the last iterate's."""
    mask = aux[2]
    inter = (mask & last_mask).sum()
    union = (mask | last_mask).sum()
    converged = inter / union.clamp(min=1) > 1 - MIN_IOU_DIFF
    return _clicks_met(aux) | converged, mask


def fbrs_optimize(net: FBRSModel, head_input: HeadInput,
                  pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                  x0: torch.Tensor, out_hw: Tuple[int, int],
                  maxiter: int = 20, insertion_mode: str = "after_aspp"):
    """L-BFGS over the (scale, bias) of the cached head input
    (fbrs_predictor.py:76-122), from x0 (2C,). Returns (best_x, logits at
    best_x (2, 1, H, W), info of lbfgs_minimize)."""
    predict, loss_fn = fbrs_objective(net, head_input, pos_mask, neg_mask,
                                      out_hw, insertion_mode)
    last_mask0 = torch.zeros(tuple(out_hw), dtype=torch.bool,
                             device=x0.device)
    best_x, info = lbfgs_minimize(loss_fn, x0, maxiter=maxiter,
                                  memory_size=LBFGS_MEMORY,
                                  stop_fn=_clicks_met_or_converged,
                                  stop_state0=last_mask0)
    with torch.no_grad():
        return best_x, predict(best_x), info


def _loss_plateau(loss, last_loss):
    return (loss - last_loss).abs() < ORACLE_PLATEAU, loss


def optimize_oracle(net: FBRSModel, head_input: HeadInput, gt: torch.Tensor,
                    x0: torch.Tensor, out_hw: Tuple[int, int],
                    maxiter: int = 20, insertion_mode: str = "after_aspp"):
    """OracleMaskLoss BRS (fbrs_predictor.py:124-160; reference
    brs_losses.py:29-58): the (scale, bias) fitted to the ground-truth
    mask gt (1, 1, H, W) by BCE on the probabilities of [image, flipped
    image] against [gt, flipped gt], instead of to the clicks. Stops when
    the loss moves less than ORACLE_PLATEAU between two iterations.
    Returns (best_x, logits at best_x, info)."""
    predict, c = _scaled_predict(net, insertion_mode, head_input, out_hw)
    gt2 = torch.cat([gt, torch.flip(gt, dims=[-1])])

    def loss_fn(x):
        loss = sigmoid_bce_from_probs(torch.sigmoid(predict(x)), gt2).mean()
        return loss + _scale_bias_reg(x, c), loss.detach()

    best_x, info = lbfgs_minimize(
        loss_fn, x0, maxiter=maxiter, memory_size=LBFGS_MEMORY,
        stop_fn=_loss_plateau,
        stop_state0=torch.tensor(math.inf, device=x0.device))
    with torch.no_grad():
        return best_x, predict(best_x), info


def input_brs_optimize(net: FBRSModel, batch: torch.Tensor,
                       points: torch.Tensor, pos_mask: torch.Tensor,
                       neg_mask: torch.Tensor, x0: torch.Tensor, target: str,
                       maxiter: int = 20):
    """RGB-BRS (target 'rgb') or DistMap-BRS ('dist'): L-BFGS over an
    additive bias on the network input, through the whole network
    (fbrs_predictor.py:501-553; reference brs.py:228-280). batch
    (2, 3, h, w) [image, flipped image], points (2, 2P, 2); x0
    (2, h, w, 3 or 2), one bias per batch entry, channels last as in the
    JAX package. Returns (best_x shaped like x0, logits (2, 1, h, w),
    info)."""
    shape = x0.shape
    zeros = (torch.zeros(batch.shape[0], 2, *batch.shape[-2:],
                         device=batch.device) if target == "rgb"
             else torch.zeros_like(batch))

    def predict(xflat):
        x = xflat.view(shape).permute(0, 3, 1, 2)
        rgb_bias, coord_bias = (x, zeros) if target == "rgb" else (zeros, x)
        return net.forward_with_input_bias(batch, points, rgb_bias, coord_bias)

    def loss_fn(xflat):
        loss, aux = _click_loss(predict(xflat), pos_mask, neg_mask)
        return loss + INPUT_REG_WEIGHT * (xflat ** 2).sum(), aux

    def clicks_met(aux, last_mask):
        return _clicks_met(aux), aux[2]

    last_mask0 = torch.zeros(tuple(batch.shape[-2:]), dtype=torch.bool,
                             device=batch.device)
    best_x, info = lbfgs_minimize(loss_fn, x0.reshape(-1), maxiter=maxiter,
                                  memory_size=INPUT_LBFGS_MEMORY,
                                  stop_fn=clicks_met, stop_state0=last_mask0)
    with torch.no_grad():
        return best_x.view(shape), predict(best_x), info


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
# Predictors
# ---------------------------------------------------------------------------

class FeatureBRSPredictor:
    """Feature-space BRS over a DistMaps model (reference brs.py:54-225),
    always with flip and flip-averaging. insertion_mode (INSERTION_MODES)
    selects where scale and bias insert: 'after_c4' (f-BRS-A),
    'after_aspp' (f-BRS-B) or 'after_deeplab' (f-BRS-C) on DeepLab
    models, 'A' or 'C' on HRNet models. The net moves to `device` and its
    weights stop requiring gradients: autograd runs only toward (scale,
    bias). Call get_prediction outside torch.inference_mode (the
    optimization needs autograd)."""

    def __init__(self, net: FBRSModel,
                 zoom_in: Optional[ZoomIn] = None,
                 net_clicks_limit: int = 8,
                 optimize_after_n_clicks: int = 1,
                 maxiter: int = 20,
                 max_size: Optional[int] = None,
                 insertion_mode: str = "after_aspp",
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.net = net.to(self.device).eval().requires_grad_(False)
        self.zoom_in = zoom_in
        self.net_clicks_limit = net_clicks_limit
        self.optimize_after_n_clicks = optimize_after_n_clicks
        self.maxiter = maxiter
        self.insertion_mode = insertion_mode
        self._head_input = getattr(self.net, INSERTION_MODES[insertion_mode][0])
        self._input_is_pair = INSERTION_MODES[insertion_mode][2]
        # OracleMaskLoss (reference brs_losses.py:29-58): with a mask
        # attached, the optimization fits it instead of the clicks.
        self.oracle_gt: Optional[torch.Tensor] = None
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

    def _network_input(self, clicker):
        """The clicks in the network's frame (LimitLongestSide, ZoomIn)
        -> (those clicks, [image, flipped image] (2, 3, h, w), their
        points (2, 2P, 2))."""
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
        w = image.shape[-1]
        points = self._points_nd(tclicks)
        # with_flip: batch = [image, hflip(image)], flipped clicks
        fpoints = points.clone()
        fpoints[..., 1] = torch.where(points[..., 1] >= 0,
                                      w - 1 - points[..., 1], -1.0)
        batch = torch.cat([image, torch.flip(image, dims=[-1])])
        return tclicks, batch, torch.cat([points, fpoints])

    def _frame_prob(self, logits: torch.Tensor) -> torch.Tensor:
        """(2, 1, h, w) logits of the flip batch -> (H, W) probability map
        of the full frame."""
        prob = flip_average(torch.sigmoid(logits))
        if self.zoom_in is not None:
            prob = self.zoom_in.inv_transform(prob)
        if self._limit_scale != 1.0:
            prob = up_ac(prob, self._orig_hw)
        return prob[0, 0]

    def get_prediction(self, clicker) -> torch.Tensor:
        """-> (H, W) probability map of the full frame, on the device."""
        tclicks, batch, bpoints = self._network_input(clicker)
        h, w = batch.shape[-2:]
        num_clicks = len(tclicks)

        feats_key = (h, w, int(bpoints.shape[1]), num_clicks)
        recompute = (self.input_data is None or self._input_key is None
                     or self._input_key[:2] != (h, w)
                     or (self.zoom_in is not None
                         and self.zoom_in.image_changed)
                     or num_clicks <= self.net_clicks_limit)
        if recompute:
            with torch.no_grad():   # not inference_mode: autograd follows
                self.input_data = self._head_input(batch, bpoints)
            self._input_key = feats_key
        feats = self.input_data[0] if self._input_is_pair else self.input_data
        c = feats.shape[1]
        if self.opt_data is None or self.opt_data.shape[0] != 2 * c:
            self.opt_data = torch.zeros(2 * c, device=self.device)

        info = {"recomputed": recompute, "crop_hw": (h, w), "iters": 0,
                "evals": 0, "host_reads": 0}
        if num_clicks > self.optimize_after_n_clicks:
            if self.oracle_gt is not None:
                self.opt_data, logits, opt_info = optimize_oracle(
                    self.net, self.input_data, self._oracle_gt_for_crop((h, w)),
                    self.opt_data, (h, w), self.maxiter, self.insertion_mode)
            else:
                pos_map, neg_map = self._clicks_maps(tclicks, (h, w))
                self.opt_data, logits, opt_info = fbrs_optimize(
                    self.net, self.input_data, pos_map, neg_map,
                    self.opt_data, (h, w), self.maxiter, self.insertion_mode)
            info.update(iters=opt_info["iters"], evals=opt_info["evals"],
                        host_reads=opt_info["host_reads"])
        else:
            # The full forward is the replay of the head input just cached
            # for these clicks.
            with torch.no_grad():
                logits = head_replay(self.net, self.insertion_mode,
                                     self.input_data, (h, w))
        self.last_info = info
        return self._frame_prob(logits)

    def set_oracle_gt(self, gt_mask) -> None:
        """gt_mask: (H, W) or (1, 1, H, W) at the frame's resolution, or
        None to return to the click loss."""
        if gt_mask is None:
            self.oracle_gt = None
            return
        gt = torch.as_tensor(gt_mask).to(self.device, torch.float32)
        self.oracle_gt = gt[None, None] if gt.ndim == 2 else gt

    def _oracle_gt_for_crop(self, hw) -> torch.Tensor:
        """The ground truth in the frame of the network input: scaled as
        LimitLongestSide scales the frame, cut to the ZoomIn crop and
        resized to it (reference brs_losses.py:44-48)."""
        gt = self.oracle_gt
        if self._limit_scale != 1.0:
            gt = up_ac(gt, self.original_image.shape[-2:])
        roi = self.zoom_in._object_roi if self.zoom_in is not None else None
        if roi is not None:
            r1, r2, c1, c2 = roi[:4]
            gt = gt[..., r1:r2 + 1, c1:c2 + 1]
        if tuple(gt.shape[-2:]) != tuple(hw):
            gt = up_ac(gt, tuple(hw))
        return gt

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


class InputBRSPredictor(FeatureBRSPredictor):
    """RGB-BRS (target 'rgb') and DistMap-BRS ('dist'): the variable is an
    additive bias on the network input, one per batch entry, kept across
    clicks while the crop keeps its size (input_brs_optimize). Click
    handling, ZoomIn, flip-averaging and LimitLongestSide are the feature
    predictor's; every evaluation runs the whole network."""

    def __init__(self, net: FBRSModel, target: str = "rgb", **kw):
        if target not in ("rgb", "dist"):
            raise ValueError(f"unknown input BRS target {target}")
        super().__init__(net, **kw)
        self.target = target

    def get_prediction(self, clicker) -> torch.Tensor:
        tclicks, batch, bpoints = self._network_input(clicker)
        h, w = batch.shape[-2:]
        shape = (2, h, w, 3 if self.target == "rgb" else 2)
        if self.opt_data is None or tuple(self.opt_data.shape) != shape:
            self.opt_data = torch.zeros(shape, device=self.device)

        info = {"recomputed": True, "crop_hw": (h, w), "iters": 0,
                "evals": 0, "host_reads": 0}
        if len(tclicks) > self.optimize_after_n_clicks:
            pos_map, neg_map = self._clicks_maps(tclicks, (h, w))
            self.opt_data, logits, opt_info = input_brs_optimize(
                self.net, batch, bpoints, pos_map, neg_map, self.opt_data,
                self.target, self.maxiter)
            info.update(iters=opt_info["iters"], evals=opt_info["evals"],
                        host_reads=opt_info["host_reads"])
        else:
            with torch.no_grad():
                logits = self.net.forward_with_input_bias(
                    batch, bpoints, torch.zeros_like(batch),
                    batch.new_zeros((2, 2, h, w)))
        self.last_info = info
        return self._frame_prob(logits)


BRS_MODES = ("NoBRS", "f-BRS-A", "f-BRS-B", "f-BRS-C", "RGB-BRS", "DistMap-BRS")


def get_predictor(net: FBRSModel, brs_mode: str = "f-BRS-B",
                  zoom_in_params: Optional[dict] = None,
                  predictor_params: Optional[dict] = None,
                  device: torch.device | str = "cuda"):
    """Predictor by BRS mode (reference fbrs/inference/predictors/
    __init__.py:8-95):

    NoBRS        no online optimization
    f-BRS-A      scale and bias after c4 (DeepLab), HRNet 'A'
    f-BRS-B      after the ASPP (DeepLab), HRNet 'A'
    f-BRS-C      after the DeepLab head, HRNet 'C' (after the OCR)
    RGB-BRS      an additive bias on the RGB input
    DistMap-BRS  an additive bias on the click distance maps

    The input-space modes default to net_clicks_limit 5."""
    zoom_in = None
    if zoom_in_params is not None:
        zoom_in = ZoomIn(**zoom_in_params)
    kw = dict(predictor_params or {})
    kw.update(zoom_in=zoom_in, device=device)
    if brs_mode == "NoBRS":
        return FeatureBRSPredictor(net, optimize_after_n_clicks=10 ** 9, **kw)
    if brs_mode in ("f-BRS-A", "f-BRS-B", "f-BRS-C"):
        if isinstance(net, FBRSHRNetModel):
            # HRNet maps A and B to the pre-OCR insertion and C to the
            # post-OCR one (reference predictors/__init__.py:61-63).
            insertion = "C" if brs_mode == "f-BRS-C" else "A"
        else:
            insertion = {"f-BRS-A": "after_c4", "f-BRS-B": "after_aspp",
                         "f-BRS-C": "after_deeplab"}[brs_mode]
        return FeatureBRSPredictor(net, insertion_mode=insertion, **kw)
    if brs_mode in ("RGB-BRS", "DistMap-BRS"):
        kw.setdefault("net_clicks_limit", 5)
        return InputBRSPredictor(net, "rgb" if brs_mode == "RGB-BRS" else "dist",
                                 **kw)
    raise ValueError(f"unknown BRS mode {brs_mode}")
