"""The PyTorch port's synthetic-data generator and f-BRS losses against
the JAX package's, on the CPU.

(a) generation/synthetic.py bit for bit: every public function at three
seeds and non-square sizes (prop_clip with max_gap 2 and 5), and
write_dataset's files (pixels of every JPEG and PNG, the image set)
against scripts/synthetic_lifecycle.py::write_dataset. (b)
train/fbrs_losses.py with ignore pixels present: every loss and metric
within 1e-6 relative, the gradients of normalized_focal_loss within 1e-6
of their largest magnitude (they differ without the detached
renormalizer), OracleMaskLoss with and without a ZoomIn ROI and its
plateau stop, compute_iou and AdaptiveIoU over a run of updates.
"""
import importlib.util
import os
from os import path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from mivos_tpu.generation import synthetic as jsyn
from mivos_tpu.train import fbrs_losses as jfl
from mivos_tpu_torch.generation import synthetic as syn
from mivos_tpu_torch.train import fbrs_losses as fl

REPO = path.dirname(path.dirname(path.abspath(__file__)))
SEEDS = (0, 7, 1234)
REL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _equal(got, want):
    """Equal arrays (or tuples of them), dtypes included."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
        return
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("seed", SEEDS)
def test_sequence_and_onehot_match_jax_bitwise(seed):
    kw = dict(num_objects=3, min_radius=0.08, max_radius=0.25)
    got = syn.synthetic_sequence(seed, 5, 40, 72, **kw)
    _equal(got, jsyn.synthetic_sequence(seed, 5, 40, 72, **kw))
    _equal(syn.labels_to_onehot(got[1][2], 3), jsyn.labels_to_onehot(got[1][2], 3))


@pytest.mark.parametrize("seed", SEEDS)
def test_masks_and_strokes_match_jax_bitwise(seed):
    _, lab = jsyn.synthetic_sequence(seed, 1, 48, 80, 2)
    region = lab[0] == 1
    for fn, args in ((syn.degrade_mask, (region,)),
                     (syn.random_strokes, (region,)),
                     (syn.random_strokes, (np.zeros_like(region),)),
                     (syn.random_strokes, (region, 3, 1))):
        jfn = getattr(jsyn, fn.__name__)
        got = fn(np.random.RandomState(seed), *args)
        _equal(got, jfn(np.random.RandomState(seed), *args))


@pytest.mark.parametrize("seed", SEEDS)
def test_training_examples_match_jax_bitwise(seed):
    _equal(syn.s2m_example(seed, 48, 80, 2), jsyn.s2m_example(seed, 48, 80, 2))
    _equal(syn.prop_example(seed, 3, 32, 56, 2), jsyn.prop_example(seed, 3, 32, 56, 2))
    for max_gap in (2, 5):
        _equal(syn.prop_clip(seed, 3, 32, 48, 2, max_gap=max_gap),
               jsyn.prop_clip(seed, 3, 32, 48, 2, max_gap=max_gap))
    _equal(syn.fbrs_example(seed, 48, 64, n_points=5),
           jsyn.fbrs_example(seed, 48, 64, n_points=5))


def test_write_dataset_matches_the_jax_script(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "synthetic_lifecycle", path.join(REPO, "scripts", "synthetic_lifecycle.py"))
    lifecycle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lifecycle)
    lifecycle.write_dataset(str(tmp_path / "jax"), n_videos=2, t=3, hw=48)
    names = syn.write_dataset(str(tmp_path / "port"), n_videos=2, t=3, hw=48)
    assert names == ["synth00", "synth01"]
    files = []
    for root, _, fs in os.walk(tmp_path / "jax"):
        files += [path.relpath(path.join(root, f), tmp_path / "jax") for f in fs]
    port_files = []
    for root, _, fs in os.walk(tmp_path / "port"):
        port_files += [path.relpath(path.join(root, f), tmp_path / "port") for f in fs]
    assert sorted(files) == sorted(port_files) and len(files) == 2 * 3 * 2 + 1
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".txt"):
            assert a.read_text() == b.read_text() == "synth00\nsynth01\n"
            continue
        ia, ib = Image.open(a), Image.open(b)
        assert ia.mode == ib.mode and ia.size == ib.size == (48, 48)
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        if rel.endswith(".png"):
            assert ia.getpalette() == ib.getpalette()


# ---------------------------------------------------------------- (b)

@pytest.fixture(scope="module")
def loss_data():
    """NHWC logits and labels for JAX, with ignore pixels and a sample
    with no positive; the port takes them NCHW."""
    rng = np.random.RandomState(5)
    logits = (rng.randn(3, 20, 28, 1) * 3).astype(np.float32)
    label = (rng.rand(3, 20, 28, 1) > 0.6).astype(np.float32)
    label[0, :5] = -1
    label[1, 3:9, 2:20] = -1
    label[2] = 0
    label[2, :2] = -1
    return logits, label


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if not want.size:
        return
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rel * scale, (got, want)


@pytest.mark.parametrize("name", ["normalized_focal_loss", "focal_loss",
                                  "sigmoid_bce_loss"])
def test_logit_losses_match_jax(loss_data, name):
    logits, label = loss_data
    want = getattr(jfl, name)(jnp.asarray(logits), jnp.asarray(label))
    got = getattr(fl, name)(_nchw(logits), _nchw(label))
    assert got.shape == (3,)
    _close(got.numpy(), want)
    if name == "normalized_focal_loss":   # its (B, H, W) form too
        _close(fl.normalized_focal_loss(_nchw(logits)[:, 0], _nchw(label)[:, 0]).numpy(),
               jfl.normalized_focal_loss(jnp.asarray(logits[..., 0]),
                                         jnp.asarray(label[..., 0])))


def test_normalized_focal_loss_gradients_match_jax(loss_data):
    """JAX stops the gradient at the renormalizer; without the port's
    detach the values agree and these gradients do not."""
    logits, label = loss_data
    want = jax.grad(lambda x: jfl.normalized_focal_loss(x, jnp.asarray(label)).sum())(
        jnp.asarray(logits))
    x = _nchw(logits).requires_grad_(True)
    fl.normalized_focal_loss(x, _nchw(label)).sum().backward()
    _close(x.grad.numpy().transpose(0, 2, 3, 1), want)


def test_bce_from_probs_matches_jax(loss_data):
    logits, label = loss_data
    probs = 1.0 / (1.0 + np.exp(-logits))
    want = jfl.sigmoid_bce_from_probs(jnp.asarray(probs), jnp.asarray(label))
    _close(fl.sigmoid_bce_from_probs(_nchw(probs), _nchw(label)).numpy(), want)


class _Zoom:
    def __init__(self, roi):
        self._object_roi = roi


class _Predictor:
    def __init__(self, roi):
        self.zoom_in = _Zoom(roi)


@pytest.mark.parametrize("roi", [None, (4, 27, 6, 40)], ids=["no_roi", "roi"])
def test_oracle_mask_loss_matches_jax(roi):
    """A flipped pair (batch 2) against a (1, 36, 48) GT: without a ROI
    the GT is resized to the result, with one it is cropped first; then
    the same result again until the 5-step plateau returns zeros."""
    rng = np.random.RandomState(9)
    gt = (rng.rand(1, 36, 48, 1) > 0.5).astype(np.float32)
    result = rng.uniform(0.05, 0.95, (2, 24, 30, 1)).astype(np.float32)
    jloss, loss = jfl.OracleMaskLoss(), fl.OracleMaskLoss()
    jloss.set_gt_mask(gt)
    loss.set_gt_mask(_nchw(gt))
    if roi is not None:
        jloss.predictor, loss.predictor = _Predictor(roi), _Predictor(roi)
    outs = []
    for i in range(7):
        r = result if i < 2 else result * 0.5 + 0.25
        want = jloss(jnp.asarray(r))
        got = loss(_nchw(r))
        _close(float(got[0]), float(want[0]))
        assert got[1:] == want[1:]
        outs.append(got)
    assert [o[1] for o in outs] == [1.0] * 6 + [0.0]
    assert outs[-1] == (0.0, 0.0, 0.0)
    _close(loss.history, jloss.history)


def test_compute_iou_and_adaptive_iou_match_jax(loss_data):
    logits, label = loss_data
    pred, gt = logits > 0.3, label > 0
    ignore = label == -1
    for args in ((pred, gt), (pred, gt, ignore),
                 (np.zeros_like(pred), np.zeros_like(gt))):   # empty unions
        want = jfl.compute_iou(*(jnp.asarray(a) for a in args))
        got = fl.compute_iou(*(_nchw(a) for a in args))
        assert got.dtype == np.float32
        _close(got, want)
    jm, m = jfl.AdaptiveIoU(), fl.AdaptiveIoU()
    rng = np.random.RandomState(2)
    for i in range(6):
        x = (logits + rng.randn(*logits.shape) * 0.5).astype(np.float32)
        y = label if i != 3 else np.zeros_like(label)   # no positive: skipped
        jm.update(jnp.asarray(x), jnp.asarray(y))
        m.update(_nchw(x), _nchw(y))
        assert m.iou_thresh == pytest.approx(jm.iou_thresh, rel=REL)
        assert m.ema_iou == pytest.approx(jm.ema_iou, rel=REL)
    assert m._epoch_count == jm._epoch_count == 5
    assert m.get_epoch_value() == pytest.approx(jm.get_epoch_value(), rel=REL)
    m.reset_epoch_stats()
    assert m.get_epoch_value() == 0.0
