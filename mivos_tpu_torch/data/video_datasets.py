"""Whole-video datasets: DAVIS, BL30K and YouTubeVOS (counterpart of
mivos_tpu/data/video_datasets.py; reference dataset/davis_test_dataset.py,
dataset/bl_test_dataset.py and dataset/yv_test_dataset.py).

Returns numpy NHWC dicts:
  rgb:  (T, H, W, 3) float32, ImageNet-normalized
  gt:   (K, T, H, W, 1) float32 one-hot object masks
  info: name / num_frames / labels (YouTubeVOS: its own keys)
PIL is imported only where a file is decoded; YouTubeVOS frames are
resized by data/transforms.py::resize, without cv2.
"""
from __future__ import annotations

import os
from os import path
from typing import Dict, List, Optional

import numpy as np

from mivos_tpu_torch.data.transforms import (INTER_CUBIC, INTER_NEAREST,
                                             all_to_onehot, im_normalize,
                                             pick_480p_size, resize)


def _load_rgb(p: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(p).convert("RGB"), np.uint8)


def _load_palette_mask(p: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(p).convert("P"), np.uint8)


class DAVISTestDataset:
    """DAVIS 2016/2017 val loader at 480p, multi-object (reference
    davis_test_dataset.py:18-110).

    root layout: JPEGImages/480p/<video>/%05d.jpg,
    Annotations/480p/<video>/%05d.png, ImageSets/<imset>.
    """

    def __init__(self, root: str, imset: str = "2017/val.txt"):
        self.root = root
        self.image_dir = path.join(root, "JPEGImages", "480p")
        self.mask_dir = path.join(root, "Annotations", "480p")

        self.videos: List[str] = []
        self.num_frames: Dict[str, int] = {}
        with open(path.join(root, "ImageSets", imset)) as f:
            for line in f:
                video = line.strip()
                if not video:
                    continue
                self.videos.append(video)
                self.num_frames[video] = len(
                    os.listdir(path.join(self.image_dir, video)))

    def __len__(self) -> int:
        return len(self.videos)

    def _masks(self, video: str) -> np.ndarray:
        masks = []
        for f in range(self.num_frames[video]):
            mask_file = path.join(self.mask_dir, video, f"{f:05d}.png")
            if path.exists(mask_file):
                masks.append(_load_palette_mask(mask_file))
            else:
                masks.append(np.zeros_like(masks[0]))
        return np.stack(masks)

    def load_labels(self, index: int):
        """Annotation labels only, no RGB decode. Returns ((T, H, W)
        uint8 raw-palette labels, object-id list)."""
        lab = self._masks(self.videos[index])
        labels = np.unique(lab[0])
        return lab, labels[labels != 0].tolist()

    def __getitem__(self, index: int) -> Dict:
        video = self.videos[index]
        t = self.num_frames[video]
        rgb = np.stack([im_normalize(_load_rgb(
            path.join(self.image_dir, video, f"{f:05d}.jpg")))
            for f in range(t)]).astype(np.float32)
        lab, labels = self.load_labels(index)
        gt = all_to_onehot(lab, labels).astype(np.float32)[..., None]
        return {
            "rgb": rgb,
            "gt": gt,
            "info": {"name": video, "num_frames": t, "labels": labels},
        }


class BLTestDataset:
    """BL30K loader with start/end video-range slicing (reference
    bl_test_dataset.py:17-79). root layout: JPEGImages/<video>/%05d.jpg,
    Annotations/<video>/%05d.png; labels from every frame."""

    def __init__(self, root: str, start: Optional[int] = None,
                 end: Optional[int] = None):
        self.image_dir = path.join(root, "JPEGImages")
        self.mask_dir = path.join(root, "Annotations")
        videos = sorted(os.listdir(self.image_dir))
        if start is not None and end is not None:
            videos = videos[start:end + 1]
        self.videos = videos
        self.num_frames = {
            v: len(os.listdir(path.join(self.image_dir, v))) for v in videos}

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, index: int) -> Dict:
        video = self.videos[index]
        t = self.num_frames[video]
        rgb = np.stack([im_normalize(_load_rgb(
            path.join(self.image_dir, video, f"{f:05d}.jpg")))
            for f in range(t)]).astype(np.float32)
        lab = np.stack([_load_palette_mask(
            path.join(self.mask_dir, video, f"{f:05d}.png"))
            for f in range(t)])
        labels = np.unique(lab)
        labels = labels[labels != 0].tolist()
        gt = all_to_onehot(lab, labels).astype(np.float32)[..., None]
        return {
            "rgb": rgb,
            "gt": gt,
            "info": {"name": video, "num_frames": t, "labels": labels},
        }


class YouTubeVOSTestDataset:
    """YouTubeVOS loader with sparse GT frames and label forward/backward
    mapping (reference yv_test_dataset.py:16-122). Images are resized so
    the short side is 480 (bicubic; masks nearest).

    root layout: vos/all_frames/<split>/JPEGImages/<video>/*.jpg and
    vos/<split>/Annotations/<video>/*.png (the annotated frames only).
    info: name, frames (file names), gt_obj (frame index -> the raw
    labels annotated there), size (the masks' (h, w)), label_convert
    (raw label -> 1..K), label_backward (its inverse), labels."""

    def __init__(self, data_root: str, split: str = "valid"):
        self.image_dir = path.join(data_root, "vos", "all_frames", split,
                                   "JPEGImages")
        self.mask_dir = path.join(data_root, "vos", split, "Annotations")
        self.videos = sorted(os.listdir(self.image_dir))
        self.frames = {v: sorted(os.listdir(path.join(self.image_dir, v)))
                       for v in self.videos}

    def __len__(self) -> int:
        return len(self.videos)

    def __getitem__(self, idx: int) -> Dict:
        video = self.videos[idx]
        frames = self.frames[video]
        info = {"name": video, "frames": frames, "gt_obj": {}}
        images, masks = [], []
        shape = None
        for i, f in enumerate(frames):
            images.append(_load_rgb(path.join(self.image_dir, video, f)))
            mask_file = path.join(self.mask_dir, video, f.replace(".jpg", ".png"))
            if path.exists(mask_file):
                m = _load_palette_mask(mask_file)
                shape = m.shape
                lab = np.unique(m)
                info["gt_obj"][i] = lab[lab != 0]
                masks.append(m)
            else:
                masks.append(None)
        if shape is None:
            raise ValueError(f"no annotation found for video {video}")
        lab = np.stack([m if m is not None else np.zeros(shape, np.uint8)
                        for m in masks])
        info["size"] = shape
        labels = np.unique(lab).astype(np.uint8)
        labels = labels[labels != 0]
        # Forward (raw label -> dense 1..K) and backward mapping
        # (yv_test_dataset.py:91-99).
        info["label_convert"] = {int(l): i + 1 for i, l in enumerate(labels)}
        info["label_backward"] = {i + 1: int(l) for i, l in enumerate(labels)}
        nh, nw = pick_480p_size(shape[0], shape[1])
        rgb = np.stack([im_normalize(resize(im, (nw, nh), INTER_CUBIC))
                        for im in images]).astype(np.float32)
        onehot = all_to_onehot(lab, labels.tolist())
        gt = np.stack([np.stack([resize(onehot[k, t], (nw, nh), INTER_NEAREST)
                                 for t in range(onehot.shape[1])])
                       for k in range(onehot.shape[0])]).astype(np.float32)[..., None]
        info["labels"] = labels.tolist()
        return {"rgb": rgb, "gt": gt, "info": info}
