"""Host-side image transforms (counterpart of the parts of
mivos_tpu/data/transforms.py that the DAVIS evaluation, the GUI session
and fusion training use).

NHWC numpy, explicit RNG: one sample's random augmentation is drawn
once into an `AugParams` and applied to every stream of the sample, so
the streams stay paired (the reference re-seeds global RNGs instead,
dataset/reseed.py). The same AugParams from the same Generator state
gives the JAX package's arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

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
