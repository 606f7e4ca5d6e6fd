"""The PyTorch port's f-BRS-A, f-BRS-C, RGB-BRS, DistMap-BRS and the
oracle optimizer against the JAX package (tiled inference:
tests/test_torch_crops.py; the gluon init: tests/test_torch_gluon_init.py).

The DeepLab model is tests/test_torch_fbrs.py's (resnet34, ch 32, a
numpy random flax tree carried into the port, the last logit conv
scaled by 10); the same seeded numpy inputs go through both packages,
fp32 on the CPU with TF32 off. Tolerances, each stated where it is
checked: network outputs 1e-4 of each output's largest magnitude;
optimised probabilities 1e-3 abs with equal L-BFGS iteration counts and
mask IoU 0.999; the click drives identical clicks and IoUs 1e-3 apart
(the input-space drives for three clicks, see test_predictor_drive_
matches_jax; the oracle drive's IoU where JAX decides by more than
1e-3).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.eval import noc as jnoc
from mivos_tpu.interactive import fbrs_predictor as jfp
from mivos_tpu.interactive.clicker import Click as JClick
from mivos_tpu.interactive.clicker import Clicker as JClicker
from mivos_tpu.ops import lbfgs as jlbfgs
from mivos_tpu_torch.checkpoint.from_jax import fbrs_state_dict_from_flax
from mivos_tpu_torch.eval import noc
from mivos_tpu_torch.interactive import fbrs_predictor as tfp
from mivos_tpu_torch.interactive.clicker import Click, Clicker
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.hrnet import FBRSHRNetModel
from test_torch_fbrs import ARCH, CH, H, RADIUS, W, _ellipse_gt, _iou, _jax_tree

REL = 1e-4                  # network outputs, of each output's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores, and torch's OpenMP pool in each of them then spins
    against the others."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nchw(x):
    return _t(x).movedim(-1, 1)


def _nhwc(x):
    return x.movedim(1, -1).numpy()


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(out - ref).max()
    assert err <= rel * scale, (err, scale)


@pytest.fixture(scope="module")
def nets():
    jnet, _, tree = _jax_tree(ARCH, 21)
    net = FBRSDeepLabModel(ARCH, ch=CH, norm_radius=RADIUS).eval()
    net.load_state_dict(fbrs_state_dict_from_flax(tree), strict=True)
    return jnet, tree, net


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    image = rng.randn(2, H, W, 3).astype(np.float32)
    points = np.array([[[10, 20], [40, 70], [5, 90], [-1, -1]],
                       [[33, 33], [-1, -1], [-1, -1], [-1, -1]]], np.float32)
    return image, points


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("mode", ["after_c4", "after_deeplab"])
def test_head_input_and_replay_match_jax(nets, inputs, mode):
    """The f-BRS-A and f-BRS-C entry points against JAX's, and each
    replay of its head input against the full forward."""
    jnet, tree, net = nets
    image, points = inputs
    in_method, replay_method, pair = tfp.INSERTION_MODES[mode]
    jin = jnet.apply(tree, jnp.asarray(image), jnp.asarray(points),
                     method=in_method)
    jins = jin if pair else (jin,)
    jout = jnet.apply(tree, *jins, (H, W), method=replay_method)
    with torch.no_grad():
        tin = getattr(net, in_method)(_nchw(image), _t(points))
        tins = tin if pair else (tin,)
        assert len(tins) == len(jins)
        for o, r in zip(tins, jins):
            _close(_nhwc(o), r)   # 1e-4 of the largest magnitude
        out = tfp.head_replay(net, mode, tuple(_nchw(np.asarray(r)) for r in jins)
                              if pair else _nchw(np.asarray(jin)), (H, W))
        _close(_nhwc(out), jout)
        full = net(_nchw(image), _t(points))
        _close(_nhwc(tfp.head_replay(net, mode, tin, (H, W))), _nhwc(full))
    if pair:
        assert tins[0].shape[1] == 512 and tins[1].shape[1] == 32
    else:
        assert tins[0].shape[1] == CH


def test_forward_with_input_bias_matches_jax(nets, inputs):
    jnet, tree, net = nets
    image, points = inputs
    rng = np.random.RandomState(2)
    rgb = (rng.randn(2, H, W, 3) * 0.3).astype(np.float32)
    coord = (rng.randn(2, H, W, 2) * 0.3).astype(np.float32)
    ref = jnet.apply(tree, jnp.asarray(image), jnp.asarray(points),
                     jnp.asarray(rgb), jnp.asarray(coord),
                     method="forward_with_input_bias")
    with torch.no_grad():
        out = net.forward_with_input_bias(_nchw(image), _t(points), _nchw(rgb),
                                          _nchw(coord))
    _close(_nhwc(out), ref)   # 1e-4 of the largest magnitude


# ---------------------------------------------------------------- optimizers

CLICKS = np.array([[[30, 40], [-1, -1], [50, 10], [12, 80]]], np.float32)


def _flip_batch(image):
    bpoints = np.concatenate([CLICKS, CLICKS.copy()])
    bpoints[1, :, 1] = np.where(CLICKS[0, :, 1] >= 0, W - 1 - CLICKS[0, :, 1], -1)
    return np.concatenate([image[:1], image[:1, :, ::-1]]), bpoints


def _click_maps():
    pos, neg = np.zeros((1, H, W, 1), np.float32), np.zeros((1, H, W, 1), np.float32)
    pos[0, 29:32, 39:42] = 1
    neg[0, 49:52, 9:12] = 1
    neg[0, 11:14, 79:82] = 1
    return pos, neg


@pytest.fixture()
def jax_iters(monkeypatch):
    """The iteration count of each JAX L-BFGS run, read out of the jitted
    loop by a callback."""
    iters = []

    def recording(*args, **kw):
        best_x, info = jlbfgs.lbfgs_minimize(*args, **kw)
        jax.debug.callback(lambda it: iters.append(int(it)), info["iters"])
        return best_x, info

    monkeypatch.setattr(jfp, "lbfgs_minimize", recording)
    jfp._fbrs_fns.cache_clear()
    jfp._input_brs_fns.cache_clear()
    yield iters
    jfp._fbrs_fns.cache_clear()
    jfp._input_brs_fns.cache_clear()


def _flip_averaged(logits):
    p = 1 / (1 + np.exp(-np.asarray(logits, np.float64)))
    return (0.5 * (p[:1] + p[1:, :, ::-1]))[0, ..., 0]


def _check_optimized(logits, jlogits, info, jax_iters):
    """Optimised probabilities 1e-3 abs, equal iterations, mask IoU 0.999."""
    prob = torch.sigmoid(logits)
    prob = (0.5 * (prob[:1] + prob[1:].flip(-1)))[0, 0].numpy()
    jprob = _flip_averaged(jlogits)
    jax.effects_barrier()   # the iteration callback has run
    assert info["iters"] == jax_iters[0] > 0
    np.testing.assert_allclose(prob, jprob, atol=1e-3, rtol=0)   # 1e-3 abs
    mask, jmask = prob > 0.49, jprob > 0.49
    assert 0.02 < jmask.mean() < 0.98
    assert _iou(mask, jmask) >= 0.999


@pytest.mark.parametrize("mode", ["after_c4", "after_deeplab"])
def test_fbrs_optimize_matches_jax(nets, inputs, jax_iters, mode):
    """One optimization at the f-BRS-A insertion (2 x 512 variables at
    ch 32's resnet34; 2 x 2048 at ResNet-50) and at f-BRS-C's, the JAX
    side jitted as the predictor runs it."""
    jnet, tree, net = nets
    batch, bpoints = _flip_batch(inputs[0])
    in_method, _, pair = tfp.INSERTION_MODES[mode]
    jin = jnet.apply(tree, jnp.asarray(batch), jnp.asarray(bpoints), method=in_method)
    feats, aux = (jin if pair else (jin, jnp.zeros((0,))))
    pos, neg = _click_maps()
    x0 = (np.random.RandomState(1).randn(2 * feats.shape[-1]) * 0.05).astype(np.float32)
    _, jlogits = jfp._fbrs_fns(jnet, mode)[2](
        tree, feats, aux, jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(x0), H, W)
    head_input = (tuple(_nchw(np.asarray(a)) for a in jin) if pair
                  else _nchw(np.asarray(jin)))
    _, logits, info = tfp.fbrs_optimize(net, head_input, _nchw(pos), _nchw(neg),
                                        _t(x0), (H, W), 20, mode)
    _check_optimized(logits, jlogits, info, jax_iters)


@pytest.mark.parametrize("target", ["rgb", "dist"])
def test_input_brs_optimize_matches_jax(nets, inputs, jax_iters, target):
    """RGB-BRS and DistMap-BRS: L-BFGS (memory 10) over a full-frame
    input bias through the whole network."""
    jnet, tree, net = nets
    batch, bpoints = _flip_batch(inputs[0])
    pos, neg = _click_maps()
    ch = 3 if target == "rgb" else 2
    x0 = (np.random.RandomState(3).randn(2, H, W, ch) * 0.01).astype(np.float32)
    bx, jlogits = jfp._input_brs_fns(jnet, target)(
        tree, jnp.asarray(batch), jnp.asarray(bpoints), jnp.asarray(pos),
        jnp.asarray(neg), jnp.asarray(x0))
    best_x, logits, info = tfp.input_brs_optimize(
        net, _nchw(batch), _t(bpoints), _nchw(pos), _nchw(neg), _t(x0), target)
    assert best_x.shape == x0.shape
    _check_optimized(logits, jlogits, info, jax_iters)


# Past 5 iterations the oracle's fit on this random net is chaotic: after
# 20, op-by-op JAX and jitted JAX part by 0.23 in x (of 2.3), the port and
# op-by-op JAX by 0.18, while loss and gradient at x0 agree to 1.5e-7.
ORACLE_MAXITER = 5


@pytest.mark.parametrize("mode", ["after_aspp", "after_c4"])
def test_optimize_oracle_matches_jax(nets, inputs, jax_iters, mode):
    """OracleMaskLoss BRS toward a ground-truth ellipse, ORACLE_MAXITER
    iterations; the loss at the returned x is below the loss at x0."""
    jnet, tree, net = nets
    batch, bpoints = _flip_batch(inputs[0])
    in_method, _, pair = tfp.INSERTION_MODES[mode]
    jin = jnet.apply(tree, jnp.asarray(batch), jnp.asarray(bpoints), method=in_method)
    feats, aux = (jin if pair else (jin, jnp.zeros((0,))))
    gt = _ellipse_gt(H, W).astype(np.float32)[None, ..., None]
    x0 = np.zeros(2 * feats.shape[-1], np.float32)
    _, jlogits = jfp._fbrs_fns(jnet, mode, maxiter=ORACLE_MAXITER)[3](
        tree, feats, aux, jnp.asarray(gt), jnp.asarray(x0), H, W)
    head_input = (tuple(_nchw(np.asarray(a)) for a in jin) if pair
                  else _nchw(np.asarray(jin)))
    best_x, logits, info = tfp.optimize_oracle(net, head_input, _nchw(gt), _t(x0),
                                               (H, W), ORACLE_MAXITER, mode)
    _check_optimized(logits, jlogits, info, jax_iters)
    predict, _ = tfp._scaled_predict(net, mode, head_input, (H, W))
    gt2 = torch.cat([_nchw(gt), _nchw(gt).flip(-1)])
    with torch.no_grad():
        losses = [tfp.sigmoid_bce_from_probs(torch.sigmoid(predict(x)), gt2).mean()
                  for x in (_t(x0), best_x)]
    assert losses[1] < losses[0]


def test_oracle_plateau_stop_matches_jax():
    """The oracle's stop (the loss moved less than 1e-5 since the last
    iteration; the JAX rule, fbrs_predictor.py:149-151) ends a slow
    quartic descent at the same iteration in both packages' L-BFGS."""
    def quartic(x, lib):
        return lib.sum((x - 0.3) ** 4) + 1e-3 * lib.sum(x ** 2)

    x0 = np.linspace(-1.0, 1.0, 16).astype(np.float32)
    with jax.disable_jit():
        _, jinfo = jlbfgs.lbfgs_minimize(
            lambda x: (quartic(x, jnp),) * 2, jnp.asarray(x0), maxiter=40,
            stop_fn=lambda loss, last: (jnp.abs(loss - last) < 1e-5, loss),
            stop_state0=jnp.inf)
    _, info = tfp.lbfgs_minimize(
        lambda x: (quartic(x, torch), quartic(x, torch).detach()), _t(x0),
        maxiter=40, stop_fn=tfp._loss_plateau,
        stop_state0=torch.tensor(math.inf))
    assert info["iters"] == int(jinfo["iters"]) < 40


# ---------------------------------------------------------------- predictors

@pytest.mark.parametrize("brs_mode", ["f-BRS-A", "f-BRS-C", "RGB-BRS",
                                      "DistMap-BRS"])
def test_predictor_drive_matches_jax(nets, brs_mode):
    """Clicks of the NoC user through get_predictor with ZoomIn: four in
    the feature-space modes, three in the input-space ones. Their whole-
    frame bias makes the drive chaotic past its third click: noise of
    1e-6 on the frame moves the port's own third and fourth maps by
    2.3e-2 and 2.3e-2-4.7e-2 (RGB-BRS, DistMap-BRS), while the port and
    JAX stay within 7e-4 through the third (1e-5 in the feature-space
    modes through the fourth)."""
    jnet, tree, net = nets
    image = np.random.RandomState(8).randn(H, W, 3).astype(np.float32)
    gt = _ellipse_gt(H, W)
    zoom = {"target_size": 96, "min_crop_size": 40}
    jpred = jfp.get_predictor(jnet, tree, brs_mode, zoom_in_params=zoom)
    tpred = tfp.get_predictor(net, brs_mode, zoom_in_params=zoom, device="cpu")
    assert type(tpred).__name__ == type(jpred).__name__
    assert tpred.net_clicks_limit == jpred.net_clicks_limit
    if isinstance(tpred, tfp.InputBRSPredictor):
        assert tpred.target == jpred.target
    else:
        assert tpred.insertion_mode == jpred.insertion_mode
    n = 3 if brs_mode.endswith("-BRS") else 4
    jclicks, jious, _ = jnoc.evaluate_sample(image, gt, jpred, max_iou_thr=1.1,
                                             max_clicks=n)
    tclicks, tious, probs = noc.evaluate_sample(image, gt, tpred, max_iou_thr=1.1,
                                                max_clicks=n)
    assert [(c.is_positive, c.coords) for c in tclicks] == \
        [(c.is_positive, c.coords) for c in jclicks]
    assert len(tious) == n and probs.shape == (H, W)
    assert tpred.last_info["iters"] > 0
    np.testing.assert_allclose(tious, jious, atol=1e-3, rtol=0)   # 1e-3 apart


def test_oracle_predictor_matches_jax(nets):
    """set_oracle_gt on an f-BRS-B predictor with ZoomIn and
    LimitLongestSide: three clicks, the ground truth cut to each crop."""
    jnet, tree, net = nets
    image = np.random.RandomState(9).randn(H, W, 3).astype(np.float32)
    gt = _ellipse_gt(H, W)
    kw = dict(zoom_in_params={"target_size": 64, "min_crop_size": 40},
              predictor_params={"max_size": 80, "maxiter": ORACLE_MAXITER})
    jpred = jfp.get_predictor(jnet, tree, "f-BRS-B", **kw)
    tpred = tfp.get_predictor(net, "f-BRS-B", device="cpu", **kw)
    jpred.set_input_image(jnp.asarray(image))
    tpred.set_input_image(image)
    jpred.set_oracle_gt(gt)
    tpred.set_oracle_gt(gt)
    jclicker, clicker = JClicker(), Clicker()
    for pos, yx in ((True, (40.0, 66.0)), (False, (5.0, 5.0)), (True, (30.0, 50.0))):
        jclicker.add_click(JClick(pos, yx))
        clicker.add_click(Click(pos, yx))
        jprob = np.asarray(jpred.get_prediction(jclicker))
        prob = tpred.get_prediction(clicker).numpy()
        np.testing.assert_allclose(prob, jprob, atol=1e-3, rtol=0)   # 1e-3 abs
        # IoU 0.999 where JAX decides by more than the 1e-3 tolerance: the
        # third map has a pixel 9e-8 from the threshold (its mask holds
        # 960 pixels, so one flip alone is IoU 0.99896).
        decided = np.abs(jprob - 0.49) > 1e-3
        assert _iou((prob > 0.49) & decided, (jprob > 0.49) & decided) >= 0.999
    assert tpred.last_info["iters"] > 0
    roi = tpred.zoom_in._object_roi
    assert roi == jpred.zoom_in._object_roi and roi is not None
    crop_hw = tpred.last_info["crop_hw"]
    np.testing.assert_allclose(_nhwc(tpred._oracle_gt_for_crop(crop_hw)),
                               np.asarray(jpred._oracle_gt_for_crop(crop_hw)),
                               atol=1e-6, rtol=0)
    tpred.set_oracle_gt(None)
    assert tpred.oracle_gt is None


def test_get_predictor_dispatch():
    """Every mode on both families; HRNet maps f-BRS-A and -B to 'A', -C
    to 'C'; an unknown mode raises."""
    deeplab = FBRSDeepLabModel("resnet34", ch=CH)
    hrnet = FBRSHRNetModel(18, 64, small=True)
    expect = {"NoBRS": ("after_aspp", "after_aspp"),
              "f-BRS-A": ("after_c4", "A"), "f-BRS-B": ("after_aspp", "A"),
              "f-BRS-C": ("after_deeplab", "C")}
    for net, col in ((deeplab, 0), (hrnet, 1)):
        for mode in tfp.BRS_MODES:
            pred = tfp.get_predictor(net, mode, device="cpu")
            if mode in expect:
                assert type(pred) is tfp.FeatureBRSPredictor
                assert pred.insertion_mode == expect[mode][col]
            else:
                assert isinstance(pred, tfp.InputBRSPredictor)
                assert pred.net_clicks_limit == 5
                assert pred.target == ("rgb" if mode == "RGB-BRS" else "dist")
    with pytest.raises(ValueError):
        tfp.get_predictor(deeplab, "f-BRS-D", device="cpu")
