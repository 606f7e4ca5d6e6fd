"""The PyTorch port's f-BRS click path against the JAX package.

One flax tree for `FBRSDeepLabModel` (resnet34, ch 32, the JAX module's
exact structure, numpy random values with non-trivial frozen-BN
statistics, the last logit conv scaled by LOGIT_GAIN so the
probabilities spread around the 0.49 mask threshold) is carried into the
port by checkpoint/from_jax.py; the same numpy inputs then go through
both. fp32 on the CPU with TF32 off. Tolerances, each stated where it is checked:
resizes and distance maps 1e-6 abs; network outputs 1e-4 of each
output's largest magnitude; L-BFGS best_x 1e-5 (quadratic) and 1e-3
(Rosenbrock) of its largest entry; the f-BRS-B optimization's
probabilities 1e-3 abs, its mask IoU 0.999 and equal L-BFGS iterations;
ZoomIn 1e-5 abs; the click trajectories identical clicks and IoUs 1e-3
apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from mivos_tpu.checkpoint.convert import (assert_tree_matches, convert_fbrs,
                                          detect_fbrs_model as j_detect)
from mivos_tpu.eval import noc as jnoc
from mivos_tpu.interactive import fbrs_predictor as jfp
from mivos_tpu.interactive.clicker import Click as JClick
from mivos_tpu.interactive.clicker import Clicker as JClicker
from mivos_tpu.interactive.fbrs_controller import FBRSController as JFBRSController
from mivos_tpu.models.fbrs import FBRSDeepLabModel as JFBRS
from mivos_tpu.ops import distmaps as jdm
from mivos_tpu.ops import lbfgs as jlbfgs
from mivos_tpu.ops.resize import bilinear_resize_align_corners as j_up_ac
from mivos_tpu_torch.checkpoint.from_jax import fbrs_state_dict_from_flax
from mivos_tpu_torch.checkpoint.pth import detect_fbrs_model
from mivos_tpu_torch.eval import noc
from mivos_tpu_torch.interactive import fbrs_predictor as tfp
from mivos_tpu_torch.interactive.clicker import Click, Clicker
from mivos_tpu_torch.interactive.fbrs_controller import FBRSController
from mivos_tpu_torch.models import build_fbrs_from_state_dict
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.hrnet import FBRSHRNetModel
from mivos_tpu_torch.ops.distmaps import dist_maps, pad_points
from mivos_tpu_torch.ops.lbfgs import lbfgs_minimize
from mivos_tpu_torch.ops.resize import bilinear_resize_align_corners
from test_torch_models import _random_tree

H, W = 64, 96
ARCH, CH, RADIUS = "resnet34", 32, 26.0
REL = 1e-4                  # network outputs, of each output's largest magnitude
# Spreads the random-init logits over O(1). The gain also sets how well
# the click trajectories are conditioned: at 10, noise of 1e-6 on the
# image moves the port's own 4-click controller trajectory by ~1e-5 in
# probability; at 40 it moves its 4th click by 0.1, which no comparison
# of two float32 frameworks can resolve.
LOGIT_GAIN = 10.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(out, ref, rel=REL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(out - ref).max()
    assert err <= rel * scale, (err, scale)


def _iou(a, b):
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


def _jax_tree(arch, seed):
    jnet = JFBRS(arch=arch, ch=CH, norm_radius=RADIUS)
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, H, W, 3)), jnp.zeros((1, 2, 2)))
    tree = _random_tree(abstract, seed=seed)
    out = tree["params"]["sep_head_out"]
    out["kernel"] = out["kernel"] * LOGIT_GAIN
    return jnet, abstract, tree


@pytest.fixture(scope="module")
def nets():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jnet, abstract, tree = _jax_tree(ARCH, 21)
    net = FBRSDeepLabModel(ARCH, ch=CH, norm_radius=RADIUS).eval()
    net.load_state_dict(fbrs_state_dict_from_flax(tree), strict=True)
    return jnet, abstract, tree, net


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    image = rng.randn(2, H, W, 3).astype(np.float32)
    # 3 positive and 3 negative rows; the last of each group unused.
    points = np.array([[[10, 20], [40, 70], [-1, -1],
                        [5, 90], [60, 3], [-1, -1]],
                       [[33, 33], [-1, -1], [-1, -1],
                        [-1, -1], [-1, -1], [-1, -1]]], np.float32)
    return image, points


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (13, 5)), ((5, 6), (1, 4)),
                                          ((1, 6), (5, 1)), ((1, 1), (3, 2)),
                                          ((16, 24), (64, 96))])
def test_bilinear_resize_align_corners_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(0).randn(2, *in_hw, 3).astype(np.float32)
    ref = np.asarray(j_up_ac(jnp.asarray(x), out_hw))
    out = bilinear_resize_align_corners(_t(x).movedim(-1, 1), out_hw)
    np.testing.assert_allclose(out.movedim(1, -1).numpy(), ref, atol=1e-6,
                               rtol=0)   # 1e-6 abs


def test_dist_maps_match_jax(inputs):
    _, points = inputs
    ref = np.asarray(jdm.dist_maps(jnp.asarray(points), H, W, RADIUS))
    out = dist_maps(_t(points), H, W, RADIUS).movedim(1, -1).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)   # 1e-6 abs
    assert (out[1, ..., 1] == np.tanh(2 * 1e3).astype(np.float32)).all()
    pos, neg = [(3.0, 4.0), (7.5, 1.0)], [(2.0, 9.0)]
    np.testing.assert_array_equal(pad_points(pos, neg, 3, "cpu").numpy(),
                                  np.asarray(jdm.pad_points(pos, neg, 3)))


# ---------------------------------------------------------------- model

@pytest.mark.parametrize("method", ["head_input", "head_replay", "forward"])
def test_model_matches_jax(nets, inputs, method):
    jnet, _, tree, net = nets
    image, points = inputs
    jfeats = jnet.apply(tree, jnp.asarray(image), jnp.asarray(points),
                        method="head_input")
    with torch.no_grad():
        if method == "head_input":
            ref = jfeats
            out = net.head_input(_t(image).movedim(-1, 1), _t(points))
        elif method == "head_replay":
            ref = jnet.apply(tree, jfeats, (H, W), method="head_replay")
            out = net.head_replay(_t(jfeats).movedim(-1, 1), (H, W))
        else:
            ref = jnet.apply(tree, jnp.asarray(image), jnp.asarray(points))
            out = net(_t(image).movedim(-1, 1), _t(points))
    assert out.shape[1] == (CH + 32 if method == "head_input" else 1)
    _close(out.movedim(1, -1).numpy(), ref)   # 1e-4 of the largest magnitude


def test_resnet50_deep_stem_forward_matches_jax(inputs):
    image, points = inputs
    jnet, _, tree = _jax_tree("resnet50", 22)
    net = FBRSDeepLabModel("resnet50", ch=CH, norm_radius=RADIUS).eval()
    net.load_state_dict(fbrs_state_dict_from_flax(tree), strict=True)
    assert isinstance(net.feature_extractor.backbone.conv1, torch.nn.Sequential)
    ref = jnet.apply(tree, jnp.asarray(image), jnp.asarray(points))
    with torch.no_grad():
        out = net(_t(image).movedim(-1, 1), _t(points))
    _close(out.movedim(1, -1).numpy(), ref)   # 1e-4 of the largest magnitude


def test_bridge_round_trip_and_detection(nets):
    _, abstract, tree, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back = convert_fbrs(sd)
    assert_tree_matches(back, abstract)
    orig = jax.tree_util.tree_leaves_with_path(tree)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(orig) == len(back_leaves) == len(sd)
    for path, leaf in orig:
        np.testing.assert_array_equal(back_leaves[path], np.asarray(leaf))
    for key in ("rgb_conv.2.running_var", "feature_extractor.backbone.conv1.weight",
                "feature_extractor.aspp.concurent.4.gap.1.weight",
                "feature_extractor.head.block.1.body.0.weight",
                "head.layers.2.bias"):
        assert key in sd, key
    r50 = FBRSDeepLabModel("resnet50", ch=128).state_dict()
    assert "feature_extractor.backbone.conv1.6.weight" in r50
    for state in (net.state_dict(), r50):
        assert detect_fbrs_model(state) == j_detect(
            {k: v.numpy() for k, v in state.items()})
    twin = build_fbrs_from_state_dict(net.state_dict())
    assert (twin.arch, twin.ch) == (ARCH, CH)
    # An HRNet-OCR state dict builds its model, strictly loaded.
    hrnet = FBRSHRNetModel(18, 64, small=True).state_dict()
    built = build_fbrs_from_state_dict(hrnet)
    assert isinstance(built, FBRSHRNetModel)
    assert (built.width, built.ocr_width, built.small) == (18, 64, True)
    assert all(torch.equal(v, hrnet[k]) for k, v in built.state_dict().items())
    with pytest.raises(ValueError):
        build_fbrs_from_state_dict({"conv1.weight": torch.zeros(1)})


# ---------------------------------------------------------------- L-BFGS
# The JAX reference runs op by op (jax.disable_jit): jit fuses the
# objective and changes its float32 rounding, and on Rosenbrock that
# alone moves best_x by 5% after 20 iterations (jit against op-by-op
# JAX), while the port and op-by-op JAX agree to 1e-4.

def _rosenbrock(x):
    return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2, None


def _jax_lbfgs(fun, x0, **kw):
    with jax.disable_jit():
        x, info = jlbfgs.lbfgs_minimize(fun, jnp.asarray(x0), **kw)
    return np.asarray(x), int(info["iters"])


def test_lbfgs_spd_quadratic_matches_jax():
    rng = np.random.RandomState(0)
    a = rng.randn(8, 8).astype(np.float32)
    a = (a @ a.T + 0.5 * np.eye(8)).astype(np.float32)
    b = rng.randn(8).astype(np.float32)
    x0 = rng.randn(8).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    ref, jit = _jax_lbfgs(lambda x: (0.5 * x @ ja @ x - jb @ x, None), x0)
    x, info = lbfgs_minimize(lambda x: (0.5 * x @ ta @ x - tb @ x, None), _t(x0))
    assert info["iters"] == jit
    _close(x.numpy(), ref, rel=1e-5)   # 1e-5 of the largest entry
    assert info["evals"] > info["iters"] and info["host_reads"] >= info["iters"]


def test_lbfgs_rosenbrock_matches_jax():
    x0 = np.array([-1.2, 1.0], np.float32)
    ref, jit = _jax_lbfgs(_rosenbrock, x0, maxiter=20)
    x, info = lbfgs_minimize(_rosenbrock, _t(x0), maxiter=20)
    assert info["iters"] == jit == 20
    _close(x.numpy(), ref, rel=1e-3)   # 1e-3 of the largest entry
    # Line-search steps and iterations each read one flag.
    assert info["host_reads"] == info["evals"] - 1


def test_lbfgs_stop_fn_matches_jax():
    x0 = np.array([-1.2, 1.0], np.float32)
    _, jit = _jax_lbfgs(_rosenbrock, x0, maxiter=20,
                        stop_fn=lambda aux, s: (s >= 2, s + 1),
                        stop_state0=jnp.asarray(0))
    _, info = lbfgs_minimize(_rosenbrock, _t(x0), maxiter=20,
                             stop_fn=lambda aux, s: (torch.tensor(s >= 2), s + 1),
                             stop_state0=0)
    assert info["iters"] == jit == 3


@pytest.mark.parametrize("maxiter", [2, 20])
def test_fbrs_optimize_matches_jax(nets, inputs, monkeypatch, maxiter):
    """The f-BRS-B step (fbrs_predictor.py:76-122) on one cached head
    input, the JAX side jitted as the predictor runs it; its iteration
    count is read out of the jitted loop by a callback."""
    jnet, _, tree, net = nets
    image, _ = inputs
    clicks = np.array([[[30, 40], [-1, -1], [50, 10], [12, 80]]], np.float32)
    bpoints = np.concatenate([clicks, clicks.copy()])
    bpoints[1, :, 1] = np.where(clicks[0, :, 1] >= 0, W - 1 - clicks[0, :, 1], -1)
    batch = np.concatenate([image[:1], image[:1, :, ::-1]])
    feats = np.asarray(jnet.apply(tree, jnp.asarray(batch), jnp.asarray(bpoints),
                                  method="head_input"))
    pos, neg = np.zeros((1, H, W, 1), np.float32), np.zeros((1, H, W, 1), np.float32)
    pos[0, 29:32, 39:42] = 1
    neg[0, 49:52, 9:12] = 1
    neg[0, 11:14, 79:82] = 1
    c2 = 2 * feats.shape[-1]
    x0 = (np.random.RandomState(1).randn(c2) * 0.05).astype(np.float32)

    iters = []

    def recording(*args, **kw):
        best_x, info = jlbfgs.lbfgs_minimize(*args, **kw)
        jax.debug.callback(lambda it: iters.append(int(it)), info["iters"])
        return best_x, info

    monkeypatch.setattr(jfp, "lbfgs_minimize", recording)
    jfp._fbrs_fns.cache_clear()
    optimize = jfp._fbrs_fns(jnet, maxiter=maxiter)[2]
    _, jlogits = optimize(tree, jnp.asarray(feats), jnp.zeros((0,)),
                          jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(x0), H, W)
    jfp._fbrs_fns.cache_clear()
    jprob = 1 / (1 + np.exp(-np.asarray(jlogits)))
    jprob = 0.5 * (jprob[:1] + jprob[1:, :, ::-1])[0, ..., 0]

    _, logits, info = tfp.fbrs_optimize(
        net, _t(feats).movedim(-1, 1), _t(pos).movedim(-1, 1),
        _t(neg).movedim(-1, 1), _t(x0), (H, W), maxiter)
    prob = torch.sigmoid(logits)
    prob = (0.5 * (prob[:1] + prob[1:].flip(-1)))[0, 0].numpy()
    assert info["iters"] == iters[0]
    np.testing.assert_allclose(prob, jprob, atol=1e-3, rtol=0)   # 1e-3 abs
    mask, jmask = prob > 0.49, jprob > 0.49
    assert 0.05 < jmask.mean() < 0.95
    assert _iou(mask, jmask) >= 0.999


# ---------------------------------------------------------------- clicker

def test_clicker_matches_jax_cv2():
    rng = np.random.RandomState(3)
    for _ in range(50):
        h, w = rng.randint(20, 90, 2)
        gt = (ndi.gaussian_filter(rng.rand(h, w), 3) > 0.5).astype(np.int32)
        pred = ndi.gaussian_filter(rng.rand(h, w), 2) > 0.5
        jc, tc = JClicker(gt), Clicker(gt)
        for _ in range(3):
            jc.make_next_click(pred)
            tc.make_next_click(pred)
            a, b = jc.clicks_list[-1], tc.clicks_list[-1]
            assert (a.is_positive, a.coords) == (b.is_positive, b.coords)
            pred = pred ^ (rng.rand(h, w) > 0.9)


# ---------------------------------------------------------------- ZoomIn

def test_zoom_in_matches_jax():
    rng = np.random.RandomState(6)
    fh, fw = 96, 128
    image = rng.randn(1, fh, fw, 3).astype(np.float32)
    prev = np.zeros((1, fh, fw, 1), np.float32)
    prev[0, 30:60, 40:90] = 0.9
    clicks = [(True, (45.0, 60.0)), (False, (10.0, 10.0)), (True, (70.0, 100.0))]
    jz = jfp.ZoomIn(target_size=128, min_crop_size=40)
    tz = tfp.ZoomIn(target_size=128, min_crop_size=40)
    jz._prev_probs = prev
    tz._prev_probs = _t(prev).movedim(-1, 1)
    jimg, jcl = jz.transform(jnp.asarray(image), [JClick(*c) for c in clicks])
    timg, tcl = tz.transform(_t(image).movedim(-1, 1), [Click(*c) for c in clicks])
    assert jz._object_roi == tz._object_roi and jz.image_changed and tz.image_changed
    assert tuple(timg.shape[-2:]) == tuple(jimg.shape[1:3])
    assert all(c.shape[-1] % 32 == 0 for c in (timg,)) and timg.shape[-2] % 32 == 0
    np.testing.assert_allclose(timg.movedim(1, -1).numpy(), np.asarray(jimg),
                               atol=1e-5, rtol=0)   # 1e-5 abs
    assert [(c.is_positive, c.coords) for c in tcl] == \
        [(c.is_positive, c.coords) for c in jcl]
    crop = rng.rand(1, *jimg.shape[1:3], 1).astype(np.float32)
    jout = np.asarray(jz.inv_transform(jnp.asarray(crop)))
    tout = tz.inv_transform(_t(crop).movedim(-1, 1)).movedim(1, -1).numpy()
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=0)   # 1e-5 abs


# ---------------------------------------------------------------- trajectories

def _ellipse_gt(fh, fw):
    yy, xx = np.mgrid[:fh, :fw]
    return (((yy - 40) / 22) ** 2 + ((xx - 66) / 34) ** 2 <= 1).astype(np.int32)


def test_evaluate_sample_matches_jax(nets):
    jnet, _, tree, net = nets
    image = np.random.RandomState(8).randn(H, W, 3).astype(np.float32)
    gt = _ellipse_gt(H, W)
    zoom = {"target_size": 96, "min_crop_size": 40}
    jpred = jfp.get_predictor(jnet, tree, "f-BRS-B", zoom_in_params=zoom)
    tpred = tfp.get_predictor(net, "f-BRS-B", zoom_in_params=zoom, device="cpu")
    jclicks, jious, _ = jnoc.evaluate_sample(image, gt, jpred, max_iou_thr=1.1,
                                             max_clicks=4)
    tclicks, tious, probs = noc.evaluate_sample(image, gt, tpred, max_iou_thr=1.1,
                                                max_clicks=4)
    assert [(c.is_positive, c.coords) for c in tclicks] == \
        [(c.is_positive, c.coords) for c in jclicks]
    assert len(tious) == 4 and probs.shape == (H, W)
    np.testing.assert_allclose(tious, jious, atol=1e-3, rtol=0)   # 1e-3 apart
    assert noc.compute_noc_metric([tious], [0.5, 0.9], 4) == \
        jnoc.compute_noc_metric([jious], [0.5, 0.9], 4)


def test_nobrs_with_limit_longest_side_matches_jax(nets):
    """NoBRS (no optimization) with LimitLongestSide: the frame is scaled
    to a longest side of 48 and the map back to 64x96."""
    jnet, _, tree, net = nets
    image = np.random.RandomState(10).randn(H, W, 3).astype(np.float32)
    params = {"max_size": 48}
    jpred = jfp.get_predictor(jnet, tree, "NoBRS", predictor_params=params)
    tpred = tfp.get_predictor(net, "NoBRS", predictor_params=params, device="cpu")
    jpred.set_input_image(jnp.asarray(image))
    tpred.set_input_image(image)
    jclicker, clicker = JClicker(), Clicker()
    for pos, yx in ((True, (30.0, 50.0)), (False, (10.0, 80.0))):
        jclicker.add_click(JClick(pos, yx))
        clicker.add_click(Click(pos, yx))
        ref = np.asarray(jpred.get_prediction(jclicker))
        out = tpred.get_prediction(clicker).numpy()
        assert out.shape == (H, W) and tpred.last_info["iters"] == 0
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)   # 1e-4 abs
    for mode, kind in (("f-BRS-A", "after_c4"), ("f-BRS-C", "after_deeplab"),
                       ("RGB-BRS", "rgb"), ("DistMap-BRS", "dist")):
        pred = tfp.get_predictor(net, mode, device="cpu")
        assert getattr(pred, "target", None) == kind or pred.insertion_mode == kind
    with pytest.raises(ValueError):
        tfp.get_predictor(net, "no-such-mode", device="cpu")


def test_fbrs_controller_trajectory_matches_jax(nets):
    """Four clicks of the simulated user through the GUI-facing
    controller (its defaults: ZoomIn 480, f-BRS-B), an undo, and the
    click again; then finish_object."""
    jnet, _, tree, net = nets
    image = np.random.RandomState(9).randn(H, W, 3).astype(np.float32)
    gt = _ellipse_gt(H, W)
    jc, tc = JFBRSController(jnet, tree), FBRSController(net, device="cpu")
    clicker, jclicker = Clicker(gt), JClicker(gt)
    pred = jpred = np.zeros_like(gt, bool)
    for i in range(4):
        clicker.make_next_click(pred)
        jclicker.make_next_click(jpred)
        c, jcl = clicker.clicks_list[-1], jclicker.clicks_list[-1]
        assert (c.is_positive, c.coords) == (jcl.is_positive, jcl.coords)
        jm = jc.interact(jnp.asarray(image), c.coords[1], c.coords[0], c.is_positive)
        tm = tc.interact(image, c.coords[1], c.coords[0], c.is_positive)
        assert abs(_iou(tm > 0.5, gt) - _iou(jm > 0.5, gt)) <= 1e-3
        if i == 2:
            before = tc.controller.probs_history[-2][1]
            undone = tc.undo()
            jc.undo()
            np.testing.assert_array_equal(undone, (before > 0.5).astype(np.float32))
            tm = tc.interact(image, c.coords[1], c.coords[0], c.is_positive)
            jm = jc.interact(jnp.asarray(image), c.coords[1], c.coords[0],
                             c.is_positive)
            assert abs(_iou(tm > 0.5, gt) - _iou(jm > 0.5, gt)) <= 1e-3
        pred = tc.controller.probs_history[-1][1] > 0.49
        jpred = jc.controller.probs_history[-1][1] > 0.49
        assert _iou(pred, jpred) >= 0.999
    for ctl in (tc.controller, jc.controller):
        ctl.finish_object()
    assert tc.controller.object_count == jc.controller.object_count == 1
    assert _iou(tc.controller.result_mask == 1,
                jc.controller.result_mask == 1) >= 0.999


# ---------------------------------------------------------------- entry point

@pytest.fixture()
def one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores, and torch's OpenMP pool spinning against the others made
    one RGB-BRS run (a ResNet-50 forward and backward per evaluation)
    take minutes instead of seconds."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("brs_mode", ["NoBRS", "f-BRS-A", "f-BRS-B", "f-BRS-C",
                                      "RGB-BRS", "DistMap-BRS"])
def test_click_to_mask_writes_the_mask(tmp_path, brs_mode, one_torch_thread):
    from PIL import Image

    from mivos_tpu_torch import click_to_mask

    rgb = (np.random.RandomState(2).rand(48, 64, 3) * 255).astype(np.uint8)
    src = tmp_path / "img.png"
    Image.fromarray(rgb).save(src)
    out = tmp_path / "mask.png"
    click_to_mask.main(["--image", str(src), "--clicks", "20,30,+ 5,60,-",
                        "--zoom_target", "64", "--output", str(out),
                        "--brs_mode", brs_mode, "--device", "cpu"])
    mask = Image.open(out)
    assert mask.mode == "P" and mask.size == (64, 48)
    assert set(np.unique(np.asarray(mask))) <= {0, 1}
    assert mask.getpalette()[:6] == [0, 0, 0, 128, 0, 0]


def test_indexed_png_reads_back_with_pil(tmp_path):
    from PIL import Image

    from mivos_tpu_torch.utils.palette import davis_palette, save_indexed_png

    labels = np.random.RandomState(5).randint(0, 6, (37, 53)).astype(np.uint8)
    save_indexed_png(str(tmp_path / "l.png"), labels)
    img = Image.open(tmp_path / "l.png")
    assert img.mode == "P"
    np.testing.assert_array_equal(np.asarray(img), labels)
    assert img.getpalette() == davis_palette
