"""Rasterized synthetic video: textured moving blobs with ground truth
(the port's copy of mivos_tpu/generation/synthetic.py; numpy only).

The stand-in for real VOS data that the repository does not hold: it
pretrains the propagation, S2M and f-BRS nets (train/pretrain.py) to
confident, peaked predictions, and feeds fusion training on synthetic
video (train_fusion_synthetic.py). Motion follows the reference's BL30K
generator at raster level (polynomial trajectories, reference
generation/blender/generate_yaml.py) without Blender.

Every function is deterministic per seed, through explicit
np.random.RandomState streams drawn in the JAX package's order, so its
outputs equal the JAX package's bit for bit. cv2 (erode, line, distance
transform, dilate) and PIL (write_dataset) are imported inside the
functions that use them.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


def _texture(rng: np.random.RandomState, h: int, w: int, cell: int,
             base: Optional[np.ndarray] = None) -> np.ndarray:
    """Smooth random RGB texture in [0, 1]: low-res noise upsampled by
    `cell` (piecewise-constant cells keep edges the encoders can key
    on), optionally tinted toward a base color."""
    lo = rng.rand(-(-h // cell), -(-w // cell), 3).astype(np.float32)
    up = np.kron(lo, np.ones((cell, cell, 1), np.float32))[:h, :w]
    if base is not None:
        up = 0.5 * up + 0.5 * base[None, None, :]
    return up


def _poly_track(rng: np.random.RandomState, t: int, lo: float, hi: float,
                degree: int = 3) -> np.ndarray:
    """Degree-`degree` polynomial through random control points, clipped
    to [lo, hi]."""
    ctrl_t = np.linspace(0, 1, degree + 1)
    ctrl_v = rng.uniform(lo, hi, degree + 1)
    coef = np.polyfit(ctrl_t, ctrl_v, degree)
    return np.clip(np.polyval(coef, np.linspace(0, 1, t)), lo, hi)


def synthetic_sequence(seed: int, t: int, h: int, w: int,
                       num_objects: int = 2,
                       min_radius: float = 0.10, max_radius: float = 0.22,
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One video: (images (T, H, W, 3) float32 in [0, 1], labels
    (T, H, W) int32, 0 = background, 1..K = objects).

    Each object is a rotating textured ellipse on a smooth polynomial
    trajectory; later object ids occlude earlier ones."""
    rng = np.random.RandomState(seed)
    bg = _texture(rng, h, w, cell=max(8, min(h, w) // 16))
    drift = rng.randint(1, 4)

    span = float(min(h, w))
    objs = []
    for _ in range(num_objects):
        objs.append({
            "cy": _poly_track(rng, t, 0.2 * h, 0.8 * h),
            "cx": _poly_track(rng, t, 0.2 * w, 0.8 * w),
            "ang": _poly_track(rng, t, 0, 2 * np.pi, degree=2),
            "ra": span * rng.uniform(min_radius, max_radius),
            "rb": span * rng.uniform(min_radius, max_radius),
            "tex": _texture(rng, h, w, cell=max(4, min(h, w) // 24),
                            base=rng.rand(3).astype(np.float32)),
        })

    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    images = np.empty((t, h, w, 3), np.float32)
    labels = np.zeros((t, h, w), np.int32)
    for ti in range(t):
        frame = np.roll(bg, drift * ti, axis=1).copy()
        lab = np.zeros((h, w), np.int32)
        for k, o in enumerate(objs, start=1):
            dy, dx = yy - o["cy"][ti], xx - o["cx"][ti]
            c, s = np.cos(o["ang"][ti]), np.sin(o["ang"][ti])
            u, v = c * dx + s * dy, -s * dx + c * dy
            mask = (u / o["ra"]) ** 2 + (v / o["rb"]) ** 2 < 1.0
            frame[mask] = o["tex"][mask]
            lab[mask] = k
        images[ti] = np.clip(frame + 0.02 * rng.randn(h, w, 3), 0, 1)
        labels[ti] = lab
    return images, labels


def labels_to_onehot(labels: np.ndarray, num_objects: int) -> np.ndarray:
    """(H, W) int labels -> (K, H, W, 1) float32 per-object masks."""
    return np.stack([(labels == k).astype(np.float32)
                     for k in range(1, num_objects + 1)])[..., None]


def degrade_mask(rng: np.random.RandomState, mask: np.ndarray,
                 max_shift: int = 6) -> np.ndarray:
    """A plausibly wrong previous mask: a random shift, and with
    probability 0.3 no previous mask at all."""
    out = np.roll(mask, (rng.randint(-max_shift, max_shift + 1),
                         rng.randint(-max_shift, max_shift + 1)),
                  axis=(0, 1))
    if rng.rand() < 0.3:
        out = np.zeros_like(out)
    return out


def random_strokes(rng: np.random.RandomState, region: np.ndarray,
                   n_strokes: int = 2, thickness: int = 2) -> np.ndarray:
    """Thin random polylines inside a boolean region: synthetic
    scribbles, drawn from the 3x3-eroded region when it keeps 8 pixels."""
    import cv2

    h, w = region.shape
    canvas = np.zeros((h, w), np.uint8)
    eroded = cv2.erode(region.astype(np.uint8),
                       np.ones((3, 3), np.uint8)).astype(bool)
    pool = eroded if eroded.sum() >= 8 else region
    ys, xs = np.nonzero(pool)
    if len(ys) == 0:
        return canvas.astype(bool)
    for _ in range(n_strokes):
        idx = rng.randint(0, len(ys), size=3)
        pts = [(int(xs[i]), int(ys[i])) for i in idx]
        for p0, p1 in zip(pts[:-1], pts[1:]):
            cv2.line(canvas, p0, p1, 1, thickness)
    return (canvas.astype(bool)) & region


def s2m_example(seed: int, h: int, w: int, num_objects: int = 2,
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One S2M training batch over objects: (x (K, H, W, 6), gt
    (K, H, W, 1), labels (H, W)). Channels: RGB, the previous mask,
    positive scribbles (in the object's missed part or the object) and
    negative scribbles (in the false positives or the background), the
    reference S2M input (s2m_controller.py:21-38)."""
    rng = np.random.RandomState(seed)
    images, labels = synthetic_sequence(seed, 1, h, w, num_objects)
    img, lab = images[0], labels[0]
    xs, gts = [], []
    for k in range(1, num_objects + 1):
        gt = lab == k
        prev = degrade_mask(rng, gt)
        pos = random_strokes(rng, gt & ~prev if (gt & ~prev).sum() > 16
                             else gt)
        neg_region = prev & ~gt
        if neg_region.sum() < 16:
            neg_region = ~gt
        neg = random_strokes(rng, neg_region)
        x = np.concatenate([
            img,
            prev.astype(np.float32)[..., None],
            pos.astype(np.float32)[..., None],
            neg.astype(np.float32)[..., None],
        ], axis=-1)
        xs.append(x)
        gts.append(gt.astype(np.float32)[..., None])
    return np.stack(xs), np.stack(gts), lab


def prop_example(seed: int, t_gap: int, h: int, w: int,
                 num_objects: int = 2,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One propagation pair `t_gap` frames apart: (ref_img (H, W, 3),
    ref_masks (K, H, W, 1), q_img (H, W, 3), q_masks (K, H, W, 1))."""
    images, labels = synthetic_sequence(seed, t_gap + 1, h, w, num_objects)
    return (images[0], labels_to_onehot(labels[0], num_objects),
            images[t_gap], labels_to_onehot(labels[t_gap], num_objects))


def prop_clip(seed: int, n_steps: int, h: int, w: int,
              num_objects: int = 2, max_gap: int = 5,
              ) -> Tuple[np.ndarray, np.ndarray]:
    """A chained-propagation clip: `n_steps + 1` frames at random gaps
    of 1..max_gap from one sequence of at least 30 frames, at a random
    offset (so motion per frame is a deployment video's). Returns (imgs
    (S+1, H, W, 3), masks (S+1, K, H, W, 1)); frame 0 is the interacted
    frame, frames 1..S the successive propagation targets."""
    rng = np.random.RandomState(seed)
    gaps = rng.randint(1, max_gap + 1, size=n_steps)
    idx = np.concatenate([[0], np.cumsum(gaps)])
    t_total = max(30, int(idx[-1]) + 1)
    start = rng.randint(0, t_total - int(idx[-1]))
    images, labels = synthetic_sequence(seed, t_total, h, w, num_objects)
    sel = start + idx
    return (images[sel],
            np.stack([labels_to_onehot(labels[i], num_objects)
                      for i in sel]))


def fbrs_example(seed: int, h: int, w: int, n_points: int = 8,
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One f-BRS click-training sample: (image (H, W, 3) float32 in
    [0, 1], gt (H, W) float32 binary mask, points (2P, 2) float32 (y, x)).

    DistMaps layout: positives fill the first P rows, negatives the
    second P, -1 elsewhere. The first positive sits at the object's
    distance-transform peak, 0-3 more uniformly inside; 0-3 negatives,
    each from a 9x9 boundary band or the whole background."""
    import cv2

    rng = np.random.RandomState(seed)
    images, labels = synthetic_sequence(seed, 1, h, w, num_objects=1,
                                        min_radius=0.12, max_radius=0.30)
    image, gt = images[0], (labels[0] == 1).astype(np.float32)
    p = n_points
    pts = np.full((2 * p, 2), -1.0, np.float32)
    dt = cv2.distanceTransform(gt.astype(np.uint8), cv2.DIST_L2, 3)
    cy, cx = np.unravel_index(int(np.argmax(dt)), dt.shape)
    pts[0] = (cy, cx)
    ys, xs = np.nonzero(gt > 0)
    n_pos = rng.randint(1, min(4, p) + 1)
    for i in range(1, n_pos):
        j = rng.randint(len(ys))
        pts[i] = (ys[j], xs[j])
    band = cv2.dilate(gt.astype(np.uint8),
                      np.ones((9, 9), np.uint8)).astype(bool) & (gt == 0)
    n_neg = rng.randint(0, min(3, p) + 1)
    for i in range(n_neg):
        region = band if (rng.rand() < 0.5 and band.sum() > 0) else gt == 0
        bys, bxs = np.nonzero(region)
        j = rng.randint(len(bys))
        pts[p + i] = (bys[j], bxs[j])
    return image, gt, pts


def write_dataset(root: str, n_videos: int = 12, t: int = 10,
                  hw: int = 384) -> List[str]:
    """Write `n_videos` synthetic 2-object videos (seeds 300, 301, ...)
    in the DAVIS layout that DAVISTestDataset and FusionDataset
    read: trainval/JPEGImages/480p/<video>/<frame>.jpg (quality 95),
    trainval/Annotations/480p/<video>/<frame>.png (DAVIS palette) and
    trainval/ImageSets/2017/train.txt (the counterpart of
    scripts/synthetic_lifecycle.py::write_dataset). Returns the names."""
    from PIL import Image

    from mivos_tpu_torch.utils.palette import save_indexed_png

    im_root = os.path.join(root, "trainval", "JPEGImages", "480p")
    gt_root = os.path.join(root, "trainval", "Annotations", "480p")
    imset = os.path.join(root, "trainval", "ImageSets", "2017")
    os.makedirs(imset, exist_ok=True)
    names = []
    for i in range(n_videos):
        name = f"synth{i:02d}"
        names.append(name)
        os.makedirs(os.path.join(im_root, name), exist_ok=True)
        os.makedirs(os.path.join(gt_root, name), exist_ok=True)
        images, labels = synthetic_sequence(300 + i, t, hw, hw,
                                            num_objects=2)
        for fi in range(t):
            Image.fromarray((images[fi] * 255).astype(np.uint8)).save(
                os.path.join(im_root, name, f"{fi:05d}.jpg"), quality=95)
            save_indexed_png(os.path.join(gt_root, name, f"{fi:05d}.png"),
                             labels[fi].astype(np.uint8))
    with open(os.path.join(imset, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return names
