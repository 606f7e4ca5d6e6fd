"""Fusion-module training dataset (counterpart of
mivos_tpu/data/fusion_dataset.py; reference dataset/fusion_dataset.py).

Reads the propagated probability maps that `python -m
mivos_tpu_torch.generate_fusion` writes, in the reference's layout:

  fd_root/<run>/<video>/<ref_frame>/<object>/<frame>.png   (prob * 255)

Per sample: a video, two reference frames (the target object visible
from both), a target frame and up to two objects; pairs whose two
propagated masks differ on fewer than 100 pixels are drawn again (up to
20 trials, reference :87-161); then a paired flip + 384 crop of every
stream and a colour jitter of the images. NHWC float32 numpy out.

All randomness of sample `idx` comes from one numpy Generator seeded
with SeedSequence([seed, epoch, idx]), drawn in the JAX dataset's order,
so the samples equal the JAX dataset's bit for bit under any worker
layout.

Unlike the JAX dataset (mivos_tpu/data/fusion_dataset.py:80, where
`rng.integers(0)` raises ValueError), an instance directory that holds
no reference frame, as `generate_fusion` writes for a video with no
usable object, is dropped when the dataset is built, and a video left
with no instance is left out of `videos`; the draws of every other
video are unchanged.
"""
from __future__ import annotations

import os
from os import path
from typing import Dict, List

import numpy as np

from mivos_tpu_torch.data.transforms import (AugParams, apply_color_jitter,
                                             apply_geometric, im_normalize)


def _open(p: str, mode: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(p).convert(mode), np.uint8)


class FusionDataset:
    CROP = 384
    MAX_TRIALS = 20
    MIN_DIFF_PIXELS = 100

    def __init__(self, im_root: str, gt_root: str, fd_root: str,
                 seed: int = 0):
        self.im_root, self.gt_root = im_root, gt_root
        self.seed, self.epoch = seed, 0
        videos = sorted(os.listdir(im_root))
        # run folders -> each video's instance paths (reference :38-50),
        # without instances that hold no reference frame.
        self.vid_to_instance: Dict[str, List[str]] = {}
        for run in sorted(os.listdir(fd_root)):
            for vid in sorted(os.listdir(path.join(fd_root, run))):
                inst = path.join(fd_root, run, vid)
                if os.listdir(inst):
                    self.vid_to_instance.setdefault(vid, []).append(inst)
        self.videos = [v for v in videos if v in self.vid_to_instance]

    def set_epoch(self, epoch: int) -> None:
        """Reshuffles selection and augmentation per epoch (the
        DistributedSampler.set_epoch counterpart, reference train.py:114)."""
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.videos)

    def _try_pick(self, rng: np.random.Generator, idx: int, trial: int):
        if trial < 5:
            video = self.videos[idx % len(self.videos)]
        else:
            video = self.videos[rng.integers(len(self.videos))]
        inst = self.vid_to_instance[video]
        video_path = inst[rng.integers(len(inst))]

        all_ref = sorted(os.listdir(video_path))
        first_ref = all_ref[rng.integers(len(all_ref))]
        objs = sorted(os.listdir(path.join(video_path, first_ref)))
        tar_obj = objs[rng.integers(len(objs))]
        tar_frames = sorted(os.listdir(path.join(video_path, first_ref,
                                                 tar_obj)))
        tar_frame = tar_frames[rng.integers(len(tar_frames))]

        # Second reference: seen from the first, and covering the target
        # frame for the target object (reference :113-127).
        options = [
            r for r in all_ref
            if r != first_ref
            and path.exists(path.join(video_path, first_ref, tar_obj,
                                      r + ".png"))
            and path.exists(path.join(video_path, r, tar_obj, tar_frame))
        ]
        if not options:
            return None
        secon_ref = options[rng.integers(len(options))]
        sec_objs = [
            o for o in objs
            if o != tar_obj
            and path.exists(path.join(video_path, first_ref, o, tar_frame))
            and path.exists(path.join(video_path, secon_ref, o, tar_frame))
        ]
        sec_obj = sec_objs[rng.integers(len(sec_objs))] if sec_objs else None
        return video, video_path, first_ref, secon_ref, tar_obj, sec_obj, \
            tar_frame

    def __getitem__(self, idx: int) -> Dict:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, idx]))
        pick = None
        for trial in range(self.MAX_TRIALS):
            pick = self._try_pick(rng, idx, trial)
            if pick is None:
                continue
            video, vp, ref1, ref2, obj1, obj2, tar_frame = pick
            seg1 = _open(path.join(vp, ref1, obj1, tar_frame), "L")
            seg2 = _open(path.join(vp, ref2, obj1, tar_frame), "L")
            # Enough disagreement between the two propagated masks
            # (reference :158-161), relaxed in the last quarter of trials.
            diff = np.abs(seg1.astype(np.float32)
                          - seg2.astype(np.float32)) > 255 * 0.1
            if trial >= self.MAX_TRIALS * 0.75 or \
                    diff.sum() >= self.MIN_DIFF_PIXELS:
                break
            pick = None
        if pick is None:
            raise RuntimeError(f"no usable fusion sample at index {idx}")

        tar_int = int(tar_frame[:-4])
        dist_den = abs(int(ref1) - int(ref2))
        dist = np.asarray([abs(int(ref1) - tar_int) / dist_den,
                           abs(int(ref2) - tar_int) / dist_den], np.float32)
        png, jpg = f"{tar_int:05d}.png", f"{tar_int:05d}.jpg"
        r2png, r2jpg = f"{int(ref2):05d}.png", f"{int(ref2):05d}.jpg"

        im = _open(path.join(self.im_root, video, jpg), "RGB")
        r2im = _open(path.join(self.im_root, video, r2jpg), "RGB")
        gt_lab = _open(path.join(self.gt_root, video, png), "P")
        r2gt_lab = _open(path.join(self.gt_root, video, r2png), "P")
        r2seg = _open(path.join(vp, ref1, obj1, r2png), "L")

        p = AugParams.sample(rng, im.shape[0], im.shape[1], self.CROP)

        def seg_t(x):
            return apply_geometric(x, p).astype(np.float32)[..., None] / 255.0

        def gt_t(lab, obj):
            return (apply_geometric(lab, p) == int(obj)).astype(
                np.float32)[..., None]

        def im_t(x):
            x = apply_geometric(x, p).astype(np.float32) / 255.0
            return im_normalize(apply_color_jitter(x, p))

        out = {
            "rgb": im_t(im),
            "src2_ref_im": im_t(r2im),
            "gt": gt_t(gt_lab, obj1),
            "seg1": seg_t(seg1),
            "seg2": seg_t(seg2),
            "src2_ref": seg_t(r2seg),
            "src2_ref_gt": gt_t(r2gt_lab, obj1),
            "dist": dist,
            "info": {"name": video, "frames": [ref1, ref2, tar_frame]},
        }
        if obj2 is not None:
            out["seg12"] = seg_t(_open(path.join(vp, ref1, obj2, tar_frame), "L"))
            out["seg22"] = seg_t(_open(path.join(vp, ref2, obj2, tar_frame), "L"))
            out["src2_ref2"] = seg_t(_open(path.join(vp, ref1, obj2, r2png), "L"))
            out["gt2"] = gt_t(gt_lab, obj2)
            out["src2_ref_gt2"] = gt_t(r2gt_lab, obj2)
            out["selector"] = np.asarray([1.0, 1.0], np.float32)
        else:
            zs = np.zeros_like(out["seg1"])
            out.update(seg12=zs, seg22=zs, src2_ref2=zs,
                       gt2=np.zeros_like(out["gt"]),
                       src2_ref_gt2=np.zeros_like(out["gt"]),
                       selector=np.asarray([1.0, 0.0], np.float32))
        # Class map: 0 background, 1 object 1, 2 object 2 (reference :233-236).
        cls_gt = np.zeros(out["gt"].shape[:2], np.int32)
        cls_gt[out["gt"][..., 0] > 0.5] = 1
        cls_gt[out["gt2"][..., 0] > 0.5] = 2
        out["cls_gt"] = cls_gt
        return out
