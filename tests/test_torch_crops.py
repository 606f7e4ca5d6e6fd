"""The PyTorch port's tiled inference (interactive/crops.py) against the
JAX package: get_offsets, Crops and its count-normalized paste, and
TiledPredictor with the DeepLab model of tests/test_torch_fbrs.py
(resnet34, ch 32, a numpy random flax tree carried into the port), fp32
on the CPU. Tolerances: crops equal, the paste 1e-6 abs, the tiled maps
1e-4 abs and the NoC drive's IoUs 1e-3 apart with identical clicks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.eval import noc as jnoc
from mivos_tpu.interactive import crops as jcrops
from mivos_tpu.interactive.clicker import Click as JClick
from mivos_tpu.interactive.clicker import Clicker as JClicker
from mivos_tpu_torch.checkpoint.from_jax import fbrs_state_dict_from_flax
from mivos_tpu_torch.eval import noc
from mivos_tpu_torch.interactive import crops
from mivos_tpu_torch.interactive.clicker import Click, Clicker
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from test_torch_fbrs import ARCH, CH, RADIUS, _jax_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores, and torch's OpenMP pool in each of them then spins
    against the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.array(x)).movedim(-1, 1)


def _nhwc(x):
    return x.movedim(1, -1).numpy()


@pytest.fixture(scope="module")
def nets():
    jnet, _, tree = _jax_tree(ARCH, 21)
    net = FBRSDeepLabModel(ARCH, ch=CH, norm_radius=RADIUS).eval()
    net.load_state_dict(fbrs_state_dict_from_flax(tree), strict=True)
    return jnet, tree, net


@pytest.mark.parametrize("length,crop", [(480, 480), (854, 480), (480, 320),
                                         (112, 64), (80, 48), (1000, 333)])
def test_get_offsets_matches_jax(length, crop):
    assert crops.get_offsets(length, crop) == jcrops.get_offsets(length, crop)


def test_crops_and_paste_match_jax():
    rng = np.random.RandomState(5)
    image = rng.randn(1, 80, 112, 3).astype(np.float32)
    clicks = [(True, (40.0, 66.0)), (False, (5.0, 100.0))]
    jc, tc = jcrops.Crops((48, 64)), crops.Crops((48, 64))
    jout, jcl = jc.transform(jnp.asarray(image), [JClick(*c) for c in clicks])
    tout, tcl = tc.transform(_nchw(image), [Click(*c) for c in clicks])
    assert tc.offsets == jc.offsets and len(tc.offsets) == 4
    np.testing.assert_array_equal(_nhwc(tout), np.asarray(jout))
    assert [[(c.is_positive, c.coords) for c in cl] for cl in tcl] == \
        [[(c.is_positive, c.coords) for c in cl] for cl in jcl]
    prob = rng.rand(4, 48, 64, 1).astype(np.float32)
    np.testing.assert_allclose(_nhwc(tc.inv_transform(_nchw(prob))),
                               np.asarray(jc.inv_transform(jnp.asarray(prob))),
                               atol=1e-6, rtol=0)   # 1e-6 abs
    small = image[:, :40, :50]
    sout, scl = tc.transform(_nchw(small), [Click(*c) for c in clicks])
    assert sout.shape == (1, 3, 40, 50) and len(scl) == 1
    assert tc.inv_transform(sout[:, :1]) is not None


def test_tiled_predictor_matches_jax(nets):
    """Three NoC clicks on an 80x112 frame in 48x64 crops: 4 crops and
    their flips in one batch of 8."""
    jnet, tree, net = nets
    image = np.random.RandomState(7).randn(80, 112, 3).astype(np.float32)
    gt = np.zeros((80, 112), np.int32)
    gt[30:60, 40:90] = 1
    jpred = jcrops.TiledPredictor(jnet, tree, crop_size=(48, 64))
    tpred = crops.TiledPredictor(net, crop_size=(48, 64), device="cpu")
    jclicks, jious, jprobs = jnoc.evaluate_sample(image, gt, jpred, max_iou_thr=1.1,
                                                  max_clicks=3)
    tclicks, tious, probs = noc.evaluate_sample(image, gt, tpred, max_iou_thr=1.1,
                                                max_clicks=3)
    assert [(c.is_positive, c.coords) for c in tclicks] == \
        [(c.is_positive, c.coords) for c in jclicks]
    np.testing.assert_allclose(tious, jious, atol=1e-3, rtol=0)   # 1e-3 apart
    np.testing.assert_allclose(probs, np.asarray(jprobs), atol=1e-4, rtol=0)


class _RecordingNet(torch.nn.Module):
    """A stand-in click model that records the points it is given."""

    def __init__(self):
        super().__init__()
        self.points = None

    def forward(self, image, points):
        self.points = points.clone()
        return torch.zeros(image.shape[0], 1, *image.shape[-2:])


def test_tiled_predictor_mirrors_every_real_click(nets):
    """A click left of a crop (shifted x < 0) mirrors to w - 1 - x in the
    flipped half; the (-1, -1) padding keeps its coordinates; and the
    tiled map with such a click equals JAX's."""
    rec = _RecordingNet()
    pred = crops.TiledPredictor(rec, crop_size=(48, 64), device="cpu")
    pred.set_input_image(np.zeros((60, 128, 3), np.float32))
    clicker = Clicker()
    clicker.add_click(Click(True, (30.0, 100.0)))
    clicker.add_click(Click(False, (30.0, 5.0)))
    clicker.add_click(Click(False, (40.0, 20.0)))
    prob = pred.get_prediction(clicker)
    assert prob.shape == (60, 128) and torch.all(prob == 0.5)
    n = rec.points.shape[0] // 2
    offsets = pred.crops.offsets
    assert n == len(offsets) == 6
    for i, (dy, dx) in enumerate(offsets):
        pts, fpts = rec.points[i], rec.points[n + i]
        # positive row 0; negative rows 2 and 3; padding row 1
        assert tuple(pts[1].tolist()) == tuple(fpts[1].tolist()) == (-1.0, -1.0)
        for row, (y, x) in ((0, (30.0, 100.0)), (2, (30.0, 5.0)), (3, (40.0, 20.0))):
            assert tuple(pts[row].tolist()) == (y - dy, x - dx)
            assert tuple(fpts[row].tolist()) == (y - dy, 63 - (x - dx))
    assert any(x - dx < 0 for dy, dx in offsets for x in (5.0, 20.0))

    jnet, tree, net = nets
    image = np.random.RandomState(11).randn(60, 128, 3).astype(np.float32)
    jpred = jcrops.TiledPredictor(jnet, tree, crop_size=(48, 64))
    tpred = crops.TiledPredictor(net, crop_size=(48, 64), device="cpu")
    jpred.set_input_image(jnp.asarray(image))
    tpred.set_input_image(image)
    jclicker = JClicker()
    for c in clicker.clicks_list:
        jclicker.add_click(JClick(c.is_positive, c.coords))
    np.testing.assert_allclose(tpred.get_prediction(clicker).numpy(),
                               np.asarray(jpred.get_prediction(jclicker)),
                               atol=1e-4, rtol=0)
