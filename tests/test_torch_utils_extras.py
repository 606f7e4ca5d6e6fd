"""`utils/image_saver.py` and `utils/vis.py` of the PyTorch port against
the JAX package's, and the training montage of `python -m
mivos_tpu_torch.train`.

Every comparison is exact (bit for bit): the montages' tiles are resized
nearest (the port's copy of cv2's INTER_NEAREST picks cv2's pixels), the
captions and the heat map are cv2's in both packages, and the click
markers are cv2.circle's filled circles, which the port draws without
cv2.
"""
import numpy as np
import pytest
import torch

from mivos_tpu.utils import image_saver as jsaver
from mivos_tpu.utils import vis as jvis
from mivos_tpu_torch.config import TrainConfig
from mivos_tpu_torch.interactive.clicker import Click
from mivos_tpu_torch.train.__main__ import save_montage
from mivos_tpu_torch.train.trainer import FusionTrainer
from mivos_tpu_torch.utils import image_saver, vis


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_serve.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, b=3, h=40, w=56):
    """A fusion training batch (NHWC) with the forward outputs the
    montage shows."""
    rng = np.random.RandomState(seed)
    m = lambda c=1: rng.rand(b, h, w, c).astype(np.float32)  # noqa: E731
    return {"rgb": rng.randn(b, h, w, 3).astype(np.float32), "seg1": m(), "seg2": m(),
            "seg12": m(), "seg22": m(), "gt": (m() > 0.5).astype(np.float32),
            "gt2": (m() > 0.5).astype(np.float32), "mask": m(3), "attn1": m(2),
            "attn2": m(2)}


@pytest.mark.parametrize("size", [(40, 56), (64, 48), (240, 320)])
def test_pool_fusion_matches_jax(size):
    batch = _batch(0)
    got = image_saver.pool_fusion(batch, size=size)
    want = jsaver.pool_fusion(batch, size=size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    lean = {k: v for k, v in batch.items() if k not in ("mask", "attn1", "attn2")}
    np.testing.assert_array_equal(image_saver.pool_fusion(lean, size, max_rows=2),
                                  jsaver.pool_fusion(lean, size, max_rows=2))


def test_get_image_array_matches_jax():
    rng = np.random.RandomState(1)
    images = {"a": [rng.rand(30, 20, 3), rng.rand(17, 9)],
              "b": [rng.rand(30, 20, 1), rng.rand(64, 64, 3)]}
    caps = {"a": "first\nsecond"}
    for cell in ((30, 20), (220, 210)):
        np.testing.assert_array_equal(image_saver.get_image_array(images, cell, caps),
                                      jsaver.get_image_array(images, cell, caps))


def test_vis_matches_jax():
    rng = np.random.RandomState(2)
    image = (rng.rand(60, 80, 3) * 255).astype(np.uint8)
    mask = rng.randint(0, 4, (60, 80))
    np.testing.assert_array_equal(vis.visualize_mask(mask, 4), jvis.visualize_mask(mask, 4))
    np.testing.assert_array_equal(vis.get_palette(7), jvis.get_palette(7))
    prob = rng.rand(60, 80).astype(np.float32) * 1.4 - 0.2
    np.testing.assert_array_equal(vis.draw_probmap(prob), jvis.draw_probmap(prob))
    pts = [(0, 0), (59, 79), (-1, 5), (30, 40), (3, 77)]
    for radius in (1, 3, 4, 9):
        np.testing.assert_array_equal(vis.draw_points(image, pts, (0, 255, 0), radius),
                                      jvis.draw_points(image, pts, (0, 255, 0), radius))
    for alpha in (0.6, 0.3):
        np.testing.assert_array_equal(vis.blend_mask(image, mask, alpha),
                                      jvis.blend_mask(image, mask, alpha))
    assert vis.blend_mask(image, None) is image
    clicks = [Click(True, (10, 12)), Click(False, (50, 70)), Click(True, (30, 79))]
    np.testing.assert_array_equal(
        vis.draw_with_blend_and_clicks(image, mask, 0.6, clicks, 4),
        jvis.draw_with_blend_and_clicks(image, mask, 0.6, clicks, 4))


def test_train_montage(tmp_path):
    """The montage the train CLI writes every report_every * 10
    iterations: the batch and the trainer's forward outputs through
    pool_fusion, as the JAX train.py logs it."""
    from PIL import Image

    trainer = FusionTrainer(TrainConfig(batch_size=2), None, device="cpu")
    rng = np.random.RandomState(3)
    b, h, w = 2, 32, 32
    m = lambda: rng.rand(b, h, w, 1).astype(np.float32)  # noqa: E731
    batch = {"rgb": rng.randn(b, h, w, 3).astype(np.float32),
             "cls_gt": rng.randint(0, 3, (b, h, w)).astype(np.int32),
             "gt": (m() > 0.5).astype(np.float32), "seg1": m(), "seg2": m(),
             "src2_ref": m(), "src2_ref_gt": (m() > 0.5).astype(np.float32),
             "gt2": (m() > 0.5).astype(np.float32), "seg12": m(), "seg22": m(),
             "src2_ref2": m(), "src2_ref_gt2": (m() > 0.5).astype(np.float32),
             "src2_ref_im": rng.randn(b, h, w, 3).astype(np.float32),
             "dist": rng.rand(b, 2).astype(np.float32),
             "selector": np.ones((b, 2), np.float32)}
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    path = save_montage(trainer, tensors, str(tmp_path), 500)
    assert path.endswith("pairs_000500.png")
    out = trainer.debug_outputs(batch)
    want = jsaver.pool_fusion(dict(batch, mask=out["mask"], attn1=out["attn1"],
                                   attn2=out["attn2"]))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), want)
