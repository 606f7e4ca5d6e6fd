"""Data-side modules of the PyTorch port against the JAX package:
`interactive/scribbles.py::mask_to_scribble`,
`data/transforms.py::{resize, resize_min_side, pick_480p_size}`,
`data/video_datasets.py::YouTubeVOSTestDataset`,
`utils/load_subset.py` and `eval/davis_contract.py`.

Tolerances: mask_to_scribble, pick_480p_size, load_subset and the
contract checkers are exact. `resize` against cv2.resize (which the JAX
package calls): INTER_NEAREST exact; INTER_CUBIC and INTER_AREA within
one level on uint8 images (cv2 rounds through fixed point, the port
through float64), so the YouTubeVOS frames are within 1/255 before
normalization (1/255 over the smallest std after) and its masks exact.
"""
import importlib
import os

import cv2
import numpy as np
import pytest
from PIL import Image

from mivos_tpu.data import transforms as jtransforms
from mivos_tpu.data.video_datasets import YouTubeVOSTestDataset as JYouTubeVOS
from mivos_tpu.eval import davis_contract as jcontract
from mivos_tpu.interactive.scribbles import mask_to_scribble as j_mask_to_scribble
from mivos_tpu_torch.data import transforms
from mivos_tpu_torch.data.video_datasets import YouTubeVOSTestDataset
from mivos_tpu_torch.eval import davis_contract
from mivos_tpu_torch.eval.robot import LocalInteractiveSession
from mivos_tpu_torch.interactive.scribbles import mask_to_scribble
from mivos_tpu_torch.utils import load_subset

# mivos_tpu.utils re-exports the function under the module's name.
jload = importlib.import_module("mivos_tpu.utils.load_subset")
LEVEL = 1   # uint8 levels between cv2's fixed point and the port's float64


def _labels(seed, h=48, w=64, k=3):
    rng = np.random.RandomState(seed)
    lab = np.zeros((h, w), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    for obj in range(1, k + 1):
        cy, cx, r = rng.randint(0, h), rng.randint(0, w), rng.randint(4, 16)
        lab[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = obj
    return lab


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("num_points", [5, 20])
def test_mask_to_scribble_matches_jax(seed, num_points):
    mask = _labels(seed)
    if seed == 5:
        mask[:] = 2   # one label over the whole frame: no zero to measure from
    got = mask_to_scribble(mask, 2, 4, num_points, np.random.RandomState(seed))
    want = j_mask_to_scribble(mask, 2, 4, num_points, np.random.RandomState(seed))
    assert got == want
    assert davis_contract.check_scribbles(got, num_frames=4) == []


@pytest.mark.parametrize("hw", [(37, 53), (360, 640), (481, 857), (640, 360)])
@pytest.mark.parametrize("interp", [cv2.INTER_NEAREST, cv2.INTER_CUBIC, cv2.INTER_AREA])
def test_resize_min_side_matches_cv2(hw, interp):
    img = (np.random.RandomState(hw[0]).rand(*hw, 3) * 255).astype(np.uint8)
    for target in (480, 24):
        got = transforms.resize_min_side(img, target, interp)
        want = jtransforms.resize_min_side(img, target, interp)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want.astype(int)).max()
        assert diff <= (0 if interp == cv2.INTER_NEAREST else LEVEL), diff
    # The default is INTER_AREA.
    assert transforms.resize_min_side(img, 24).shape == jtransforms.resize_min_side(img, 24).shape


def test_resize_flags_are_cv2_ones():
    assert (transforms.INTER_NEAREST, transforms.INTER_CUBIC, transforms.INTER_AREA) == (
        cv2.INTER_NEAREST, cv2.INTER_CUBIC, cv2.INTER_AREA)


def test_resize_float_and_gray():
    rng = np.random.RandomState(1)
    gray = rng.rand(40, 70).astype(np.float32)
    for interp in (cv2.INTER_NEAREST, cv2.INTER_CUBIC, cv2.INTER_AREA):
        got = transforms.resize(gray, (33, 21), interp)
        want = cv2.resize(gray, (33, 21), interpolation=interp)
        assert got.shape == want.shape == (21, 33) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("hw", [(480, 854), (720, 1280), (1280, 720), (360, 640), (500, 500)])
def test_pick_480p_size_matches_jax(hw):
    assert transforms.pick_480p_size(*hw) == jtransforms.pick_480p_size(*hw)


def _youtube_tree(root):
    """Two videos: 3 frames of 90x160 (GT on frames 0 and 2, raw labels 3
    and 7), and 2 frames of 120x100 (GT on frame 0 only)."""
    rng = np.random.RandomState(0)
    palette = (np.arange(768) % 256).astype(np.uint8).tolist()
    for video, (h, w), t, gt in (("vid_a", (90, 160), 3, {0: (3,), 2: (3, 7)}),
                                 ("vid_b", (120, 100), 2, {0: (5,)})):
        im_dir = os.path.join(root, "vos", "all_frames", "valid", "JPEGImages", video)
        gt_dir = os.path.join(root, "vos", "valid", "Annotations", video)
        os.makedirs(im_dir)
        os.makedirs(gt_dir)
        for i in range(t):
            img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(im_dir, f"{i:05d}.jpg"))
            if i in gt:
                lab = np.zeros((h, w), np.uint8)
                for j, raw in enumerate(gt[i]):
                    lab[10 + 20 * j:40 + 20 * j, 20:60 + 10 * j] = raw
                png = Image.fromarray(lab, mode="P")
                png.putpalette(palette)
                png.save(os.path.join(gt_dir, f"{i:05d}.png"))


def test_youtube_vos_matches_jax(tmp_path):
    _youtube_tree(str(tmp_path))
    mine, theirs = YouTubeVOSTestDataset(str(tmp_path)), JYouTubeVOS(str(tmp_path))
    assert len(mine) == len(theirs) == 2 and mine.videos == theirs.videos
    for i in range(2):
        a, b = mine[i], theirs[i]
        assert a["rgb"].shape == b["rgb"].shape and a["rgb"].dtype == np.float32
        np.testing.assert_allclose(a["rgb"], b["rgb"],
                                   atol=LEVEL / 255 / transforms.IM_STD.min() + 1e-6)
        np.testing.assert_array_equal(a["gt"], b["gt"])
        ia, ib = a["info"], b["info"]
        assert set(ia) == set(ib)
        for key in ("name", "frames", "size", "label_convert", "label_backward", "labels"):
            assert ia[key] == ib[key], key
        assert ia["gt_obj"].keys() == ib["gt_obj"].keys()
        for f in ia["gt_obj"]:
            np.testing.assert_array_equal(ia["gt_obj"][f], ib["gt_obj"][f])
    assert mine[0]["rgb"].shape[1:3] == (480, 853)
    assert mine[0]["info"]["label_backward"] == {1: 3, 2: 7}


def test_load_subset_matches_jax(tmp_path):
    p = tmp_path / "subset.txt"
    p.write_text("bear\nblackswan\n\nbmx-trees\nbear\n")
    assert load_subset.load_subset(str(p)) == jload.load_subset(str(p))
    assert load_subset.load_sub_davis(str(p)) == jload.load_sub_davis(str(p))
    assert load_subset.load_sub_yv(str(p)) == jload.load_sub_yv(str(p))


def _payloads():
    good = mask_to_scribble(_labels(0), 1, 3)
    return [good, {"nope": []}, "x", {"scribbles": "x"},
            {"scribbles": [[{"object_id": 1, "path": [[2.0, 0.5]]}]]},
            {"scribbles": [[{"path": [[0.1, 0.2]]}]]},
            {"scribbles": [[{"object_id": 9, "path": [[0.1, 0.2, 0.3]]}], ["x"], 3]}]


@pytest.mark.parametrize("i", range(7))
def test_contract_checkers_match_jax(i):
    payload = _payloads()[i]
    for kw in ({}, {"num_frames": 3, "num_objects": 3}):
        assert davis_contract.check_scribbles(payload, **kw) == \
            jcontract.check_scribbles(payload, **kw)
    triple = ("seq", payload, True)
    assert davis_contract.check_get_scribbles_result(triple) == \
        jcontract.check_get_scribbles_result(triple)
    for summary in ({"auc": 0.5}, {"x": 1}, 3):
        assert davis_contract.check_summary(summary) == jcontract.check_summary(summary)


def test_contract_on_the_port_session():
    class Bad:
        def next(self):
            return False

    for cls in (LocalInteractiveSession, Bad):
        assert davis_contract.check_session_methods(cls) == \
            jcontract.check_session_methods(cls)
        assert davis_contract.check_session_ctor(cls) == jcontract.check_session_ctor(cls)
    assert davis_contract.check_session_methods(LocalInteractiveSession) == []
    assert davis_contract.check_session_methods(Bad) != []
