"""Host-side image transforms (counterpart of
mivos_tpu/data/transforms.py).

`resize` is cv2.resize's INTER_NEAREST, INTER_CUBIC and INTER_AREA
without cv2 (the flags keep cv2's values): nearest picks cv2's source
pixels; cubic (a = -0.75) and area weigh the same source pixels with the
same weights as cv2, in float64, where cv2 works in fixed point on uint8
images, so a uint8 result may differ from cv2's by one level
(tests/test_torch_data_extras.py).

NHWC numpy, explicit RNG: one sample's random augmentation is drawn
once into an `AugParams` and applied to every stream of the sample, so
the streams stay paired (the reference re-seeds global RNGs instead,
dataset/reseed.py). The same AugParams from the same Generator state
gives the JAX package's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

# ImageNet statistics (reference dataset/range_transform.py:1-13).
IM_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IM_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def im_normalize(img: np.ndarray) -> np.ndarray:
    """uint8/float [0,255]-or-[0,1] HWC RGB -> normalized float32."""
    img = np.asarray(img, np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return (img - IM_MEAN) / IM_STD


def im_denormalize(img: np.ndarray) -> np.ndarray:
    """Inverse of im_normalize, clipped to [0, 1]
    (reference inv_im_trans, range_transform.py:10-12)."""
    return np.clip(np.asarray(img, np.float32) * IM_STD + IM_MEAN, 0.0, 1.0)


def all_to_onehot(masks: np.ndarray, labels: Sequence[int]) -> np.ndarray:
    """(T, H, W) label maps -> (K, T, H, W) uint8 one-hot planes
    (reference dataset/onehot_util.py:4-8)."""
    out = np.zeros((len(labels),) + masks.shape, dtype=np.uint8)
    for k, l in enumerate(labels):
        out[k] = (masks == l).astype(np.uint8)
    return out


@dataclasses.dataclass(frozen=True)
class AugParams:
    """One sample's paired augmentation (reference fusion_dataset.py:57-78:
    RandomHorizontalFlip, RandomCrop(384), ColorJitter(0.1, 0.03, 0.03,
    0.01))."""

    flip: bool
    crop_y: int
    crop_x: int
    crop_size: int
    brightness: float
    contrast: float
    saturation: float
    hue: float

    @staticmethod
    def sample(rng: np.random.Generator, h: int, w: int,
               crop_size: int = 384) -> "AugParams":
        """Draws, in this order: flip, crop y, crop x, brightness,
        contrast, saturation, hue (the JAX package's order)."""
        ch, cw = min(crop_size, h), min(crop_size, w)
        return AugParams(
            flip=bool(rng.random() < 0.5),
            crop_y=int(rng.integers(0, h - ch + 1)),
            crop_x=int(rng.integers(0, w - cw + 1)),
            crop_size=crop_size,
            brightness=float(rng.uniform(0.9, 1.1)),
            contrast=float(rng.uniform(0.97, 1.03)),
            saturation=float(rng.uniform(0.97, 1.03)),
            hue=float(rng.uniform(-0.01, 0.01)),
        )


def apply_geometric(img: np.ndarray, p: AugParams) -> np.ndarray:
    """Paired flip + crop of an image or mask (HW or HWC)."""
    if p.flip:
        img = img[:, ::-1]
    ch, cw = min(p.crop_size, img.shape[0]), min(p.crop_size, img.shape[1])
    return np.ascontiguousarray(
        img[p.crop_y:p.crop_y + ch, p.crop_x:p.crop_x + cw])


def apply_color_jitter(img: np.ndarray, p: AugParams) -> np.ndarray:
    """Photometric jitter of a float [0, 1] HWC RGB image: brightness,
    contrast and saturation multiplicative, hue additive in cv2's float32
    HSV (degrees), as the JAX package does. cv2 is imported here, where
    the hue is shifted, so that importing the port needs no cv2."""
    img = np.clip(np.asarray(img, np.float32) * p.brightness, 0, 1)
    gray_mean = img.mean(axis=(0, 1), keepdims=True).mean()
    img = np.clip(gray_mean + p.contrast * (img - gray_mean), 0, 1)
    gray = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    img = np.clip(gray[..., None] + p.saturation * (img - gray[..., None]),
                  0, 1)
    if abs(p.hue) > 1e-8:
        import cv2

        hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0] + p.hue * 360.0) % 360.0
        img = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return img


INTER_NEAREST, INTER_CUBIC, INTER_AREA = 0, 2, 3   # cv2's flag values
_CUBIC_A = -0.75


def _cubic_taps(src: int, dst: int):
    """cv2's bicubic taps of one axis: 4 source indices a destination
    pixel (clamped: the border replicates) and their weights."""
    scale = src / dst
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32).astype(np.float64)
    sx = np.floor(f)
    x = f - sx
    a = _CUBIC_A
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    w = np.stack([c0, c1, c2, 1.0 - c0 - c1 - c2], axis=1)
    idx = sx[:, None].astype(np.int64) + np.arange(-1, 3)[None]
    return np.clip(idx, 0, src - 1), w


def _area_taps(src: int, dst: int):
    """cv2's INTER_AREA taps of one axis. Shrinking: each destination
    pixel averages the source cells it covers, partial cells by their
    covered share (cv2 computeResizeAreaTab). Enlarging: a linear blend
    of two neighbours at cv2's area offset."""
    scale = src / dst
    if scale >= 1.0:
        rows = []
        for dx in range(dst):
            fs1 = dx * scale
            fs2 = fs1 + scale
            cell = min(scale, src - fs1)
            s2 = min(int(np.floor(fs2)), src - 1)
            s1 = min(int(np.ceil(fs1)), s2)
            taps = []
            if s1 - fs1 > 1e-3:
                taps.append((s1 - 1, (s1 - fs1) / cell))
            taps += [(sx, 1.0 / cell) for sx in range(s1, s2)]
            if fs2 - s2 > 1e-3:
                taps.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
            rows.append(taps)
        n = max(len(r) for r in rows)
        idx = np.zeros((dst, n), np.int64)
        w = np.zeros((dst, n))
        for dx, taps in enumerate(rows):
            for j, (sx, wt) in enumerate(taps):
                idx[dx, j], w[dx, j] = sx, wt
        return idx, w
    inv = dst / src
    sx = np.floor(np.arange(dst) * scale).astype(np.int64)
    fx = (np.arange(dst) + 1) - (sx + 1) * inv
    fx = np.where(fx <= 0, 0.0, fx - np.floor(fx))
    fx = np.where(sx >= src - 1, 0.0, fx)
    sx = np.minimum(sx, src - 1)
    idx = np.stack([sx, np.minimum(sx + 1, src - 1)], axis=1)
    return idx, np.stack([1.0 - fx, fx], axis=1)


def resize(img: np.ndarray, size: Tuple[int, int],
           interpolation: int = INTER_AREA) -> np.ndarray:
    """cv2.resize(img, size=(w, h), interpolation) on an (H, W) or
    (H, W, C) uint8 or float array, without cv2 (module docstring)."""
    w_out, h_out = size
    h, w = img.shape[:2]
    if interpolation == INTER_NEAREST:
        ys = np.minimum(np.floor(np.arange(h_out) * (1.0 / (h_out / h))), h - 1)
        xs = np.minimum(np.floor(np.arange(w_out) * (1.0 / (w_out / w))), w - 1)
        return np.ascontiguousarray(img[ys.astype(np.int64)][:, xs.astype(np.int64)])
    if interpolation == INTER_CUBIC:
        (iy, wy), (ix, wx) = _cubic_taps(h, h_out), _cubic_taps(w, w_out)
    elif interpolation == INTER_AREA:
        (iy, wy), (ix, wx) = _area_taps(h, h_out), _area_taps(w, w_out)
    else:
        raise ValueError(f"unsupported interpolation {interpolation}")
    x = img.astype(np.float64)
    shape = (1,) * (img.ndim - 2)
    x = (x[:, ix] * wx.reshape(wx.shape + shape)).sum(axis=2)
    x = (x[iy] * wy.reshape(wy.shape + (1,) + shape)).sum(axis=1)
    if img.dtype == np.uint8:
        return np.clip(np.floor(x + 0.5), 0, 255).astype(np.uint8)
    return x.astype(img.dtype)


def resize_min_side(img: np.ndarray, target: int,
                    interpolation: Optional[int] = None) -> np.ndarray:
    """Resize so the SHORTER side equals `target`, preserving aspect
    (the reference's 480p policy, yv_test_dataset.py:103-108);
    INTER_AREA by default."""
    h, w = img.shape[:2]
    if h > w:
        size = (target, h * target // w)   # (w, h), as cv2 takes it
    else:
        size = (w * target // h, target)
    return resize(img, size, INTER_AREA if interpolation is None else interpolation)


def pick_480p_size(h: int, w: int) -> Tuple[int, int]:
    """480p target (h, w) preserving aspect (yv_test_dataset.py:103-106)."""
    if h > w:
        return (h * 480 // w, 480)
    return (480, w * 480 // h)
