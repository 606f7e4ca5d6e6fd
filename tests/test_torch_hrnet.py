"""The PyTorch port's HRNet-OCR f-BRS model against the JAX package.

One flax tree for `FBRSHRNetModel` (W18, OCR 64, small, numpy random
values with non-trivial frozen-BN statistics) is carried into the port
by checkpoint/from_jax.py; the same seeded numpy inputs then go through
both. The frame is 52x76, so the branches are 13x19, 7x10, 4x5 and 2x3:
every stride-2 conv rounds an odd size up and every upsample goes to an
odd size. The tree's seed is one whose random logits spread around 0
(std 2.3 at this frame; most seeds saturate every pixel at |logit| > 15,
where no f-BRS step moves a mask). fp32 on the CPU with TF32 off.
Tolerances, each stated where it is checked: network outputs 1e-4 of
each output's largest magnitude; the spatial gather 1e-6 abs; optimised
probabilities 1e-3 abs with equal L-BFGS iteration counts and mask IoU
0.999; the click drives identical clicks, IoUs 1e-3 apart and final
masks at IoU 0.99 (see test_hrnet_drive_matches_jax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import (assert_tree_matches,
                                          convert_fbrs_hrnet,
                                          detect_fbrs_model as j_detect)
from mivos_tpu.eval import noc as jnoc
from mivos_tpu.interactive import fbrs_predictor as jfp
from mivos_tpu.models import build_fbrs_from_state_dict as j_build
from mivos_tpu.models.hrnet import FBRSHRNetModel as JHRNet
from mivos_tpu.models.hrnet import spatial_gather as j_spatial_gather
from mivos_tpu.ops import lbfgs as jlbfgs
from mivos_tpu_torch.checkpoint.from_jax import fbrs_hrnet_state_dict_from_flax
from mivos_tpu_torch.checkpoint.pth import detect_fbrs_model
from mivos_tpu_torch.eval import noc
from mivos_tpu_torch.interactive import fbrs_predictor as tfp
from mivos_tpu_torch.models import build_fbrs_from_state_dict
from mivos_tpu_torch.models.hrnet import FBRSHRNetModel, spatial_gather
from test_torch_models import _random_tree

H, W = 52, 76
WIDTH, OCR, SMALL, RADIUS = 18, 64, True, 26.0
SEED = 5
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


def _iou(a, b):
    return np.logical_and(a, b).sum() / max(np.logical_or(a, b).sum(), 1)


@pytest.fixture(scope="module")
def nets():
    jnet = JHRNet(width=WIDTH, ocr_width=OCR, small=SMALL, norm_radius=RADIUS)
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, H, W, 3)), jnp.zeros((1, 2, 2)))
    tree = _random_tree(abstract, seed=SEED)
    net = FBRSHRNetModel(WIDTH, OCR, SMALL, RADIUS).eval()
    net.load_state_dict(fbrs_hrnet_state_dict_from_flax(tree), strict=True)
    return jnet, abstract, tree, net


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(4)
    image = rng.randn(2, H, W, 3).astype(np.float32)
    points = np.array([[[10, 20], [40, 70], [5, 60], [-1, -1]],
                       [[33, 33], [-1, -1], [-1, -1], [-1, -1]]], np.float32)
    return image, points


def _fe(mode):
    """A flax method that runs the model's HighResolutionNet in `mode`."""
    return lambda module, x: module.feature_extractor(x, mode=mode)


@pytest.fixture(scope="module")
def stages(nets, inputs):
    """The JAX package's HighResolutionNet input, features and OCR
    features for `inputs`."""
    jnet, _, tree, _ = nets
    image, points = inputs
    x = jnet.apply(tree, jnp.asarray(image), jnp.asarray(points),
                   method=lambda m, i, p: m._backbone_input(i, p))
    feats = jnet.apply(tree, x, method=_fe("features"))
    ocr = jnet.apply(tree, feats, method=_fe("ocr_features"))
    return {"full": x, "features": x, "head": feats, "ocr_features": feats,
            "cls": ocr}


# ---------------------------------------------------------------- modes

@pytest.mark.parametrize("mode", ["full", "features", "head", "ocr_features",
                                  "cls"])
def test_high_resolution_net_modes_match_jax(nets, stages, mode):
    jnet, _, tree, net = nets
    x = stages[mode]
    ref = jnet.apply(tree, x, method=_fe(mode))
    with torch.no_grad():
        out = net.feature_extractor(_nchw(x), mode=mode)
    pairs = list(zip(out, ref)) if mode in ("full", "head") else [(out, ref)]
    assert len(pairs) == (2 if mode in ("full", "head") else 1)
    for o, r in pairs:
        _close(_nhwc(o), r)   # 1e-4 of the largest magnitude
    if mode == "features":
        assert out.shape == (2, 15 * WIDTH, 13, 19)


def test_spatial_gather_matches_jax():
    rng = np.random.RandomState(1)
    feats = rng.randn(2, 7, 10, 16).astype(np.float32)
    probs = rng.randn(2, 7, 10, 3).astype(np.float32) * 3
    ref = np.asarray(j_spatial_gather(jnp.asarray(feats), jnp.asarray(probs)))
    out = spatial_gather(_nchw(feats), _nchw(probs)).numpy()
    assert out.shape == (2, 3, 16)
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)   # 1e-6 abs


@pytest.mark.parametrize("entry", ["head_input", "head_replay", "head_input_ocr",
                                   "head_replay_cls", "forward", "with_aux"])
def test_model_entry_points_match_jax(nets, inputs, stages, entry):
    jnet, _, tree, net = nets
    image, points = inputs
    ji, jp = jnp.asarray(image), jnp.asarray(points)
    with torch.no_grad():
        if entry in ("head_input", "head_input_ocr"):
            refs = (jnet.apply(tree, ji, jp, method=entry),)
            outs = (getattr(net, entry)(_nchw(image), _t(points)),)
        elif entry in ("head_replay", "head_replay_cls"):
            x = stages["head" if entry == "head_replay" else "cls"]
            refs = (jnet.apply(tree, x, (H, W), method=entry),)
            outs = (getattr(net, entry)(_nchw(x), (H, W)),)
            # The replay of the head input is the full forward.
            full = net(_nchw(image), _t(points))
            head = getattr(net, "head_input" if entry == "head_replay"
                           else "head_input_ocr")(_nchw(image), _t(points))
            _close(_nhwc(getattr(net, entry)(head, (H, W))), _nhwc(full))
        elif entry == "forward":
            refs = (jnet.apply(tree, ji, jp),)
            outs = (net(_nchw(image), _t(points)),)
        else:
            refs = jnet.apply(tree, ji, jp, with_aux=True)
            outs = net(_nchw(image), _t(points), with_aux=True)
    for o, r in zip(outs, refs):
        _close(_nhwc(o), r)   # 1e-4 of the largest magnitude


class _JHRNetWithBias(JHRNet):
    """The JAX model with the input-bias forward the port's HRNet adds for
    RGB-BRS and DistMap-BRS, composed of the JAX model's own parts (as the
    JAX DeepLab model's `forward_with_input_bias`, fbrs.py:302-313)."""

    def forward_with_input_bias(self, image, points, rgb_bias, coord_bias):
        from mivos_tpu.ops.distmaps import dist_maps
        from mivos_tpu.ops.resize import bilinear_resize_align_corners
        import flax.linen as nn

        h, w = image.shape[1:3]
        coord = dist_maps(points, h, w, self.norm_radius) + coord_bias
        x = jnp.concatenate([image + rgb_bias, coord], axis=-1)
        x = self.rgb_conv_1(self.rgb_conv_bn(
            nn.leaky_relu(self.rgb_conv_0(x), negative_slope=0.2)))
        out, _ = self.feature_extractor(x)
        return bilinear_resize_align_corners(out, (h, w))


def test_forward_with_input_bias_matches_jax(nets, inputs):
    _, _, tree, net = nets
    image, points = inputs
    rng = np.random.RandomState(2)
    rgb = (rng.randn(2, H, W, 3) * 0.3).astype(np.float32)
    coord = (rng.randn(2, H, W, 2) * 0.3).astype(np.float32)
    jnet = _JHRNetWithBias(width=WIDTH, ocr_width=OCR, small=SMALL,
                           norm_radius=RADIUS)
    ref = jnet.apply(tree, jnp.asarray(image), jnp.asarray(points),
                     jnp.asarray(rgb), jnp.asarray(coord),
                     method="forward_with_input_bias")
    with torch.no_grad():
        out = net.forward_with_input_bias(_nchw(image), _t(points), _nchw(rgb),
                                          _nchw(coord))
        zero = net.forward_with_input_bias(_nchw(image), _t(points),
                                           torch.zeros(2, 3, H, W),
                                           torch.zeros(2, 2, H, W))
        full = net(_nchw(image), _t(points))
    _close(_nhwc(out), ref)   # 1e-4 of the largest magnitude
    assert torch.equal(zero, full)


# ---------------------------------------------------------------- weights

def test_bridge_round_trip_and_detection(nets):
    _, abstract, tree, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    back = convert_fbrs_hrnet(sd)
    assert_tree_matches(back, abstract)
    orig = jax.tree_util.tree_leaves_with_path(tree)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(orig) == len(back_leaves) == len(sd)
    for path, leaf in orig:
        np.testing.assert_array_equal(back_leaves[path], np.asarray(leaf))
    fe = "feature_extractor."
    for key in ("stage2.0.branches.0.0.conv1.weight",
                "stage3.0.fuse_layers.2.0.1.0.weight",
                "stage3.0.fuse_layers.2.0.1.1.running_var",
                "stage4.1.fuse_layers.0.3.0.weight",
                "stage4.1.fuse_layers.0.3.1.weight",
                "transition1.0.0.weight", "transition1.1.0.0.weight",
                "transition3.3.0.1.bias", "layer1.0.downsample.0.weight",
                "conv3x3_ocr.0.bias",
                "ocr_distri_head.object_context_block.f_pixel.1.0.running_mean",
                "ocr_distri_head.object_context_block.f_up.0.weight",
                "ocr_distri_head.conv_bn_dropout.1.0.weight",
                "aux_head.3.bias", "cls_head.weight"):
        assert fe + key in sd, key
    assert "rgb_conv.2.running_var" in sd
    ref = j_detect(sd)
    assert detect_fbrs_model(net.state_dict()) == ref == {
        "kind": "hrnet", "width": WIDTH, "ocr_width": OCR, "small": SMALL}
    twin = build_fbrs_from_state_dict(net.state_dict())
    jtwin, _ = j_build(sd)
    assert isinstance(twin, FBRSHRNetModel)
    assert (twin.width, twin.ocr_width, twin.small) == \
        (jtwin.width, jtwin.ocr_width, jtwin.small)


def test_full_width_structure_matches_jax():
    """HRNet-W32, OCR 128, small=False (the f-BRS release's
    hrnet32_ocr128): the port's state_dict maps onto the JAX tree's
    structure and shapes, and both detect it alike."""
    jnet = JHRNet(width=32, ocr_width=128, small=False)
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2, 2)))
    sd = {k: v.numpy() for k, v in FBRSHRNetModel(32, 128).state_dict().items()}
    back = convert_fbrs_hrnet(sd)
    assert_tree_matches(back, abstract)
    assert len(jax.tree_util.tree_leaves(abstract)) == len(sd)
    assert sd["feature_extractor.conv3x3_ocr.0.weight"].shape == (256, 480, 3, 3)
    assert detect_fbrs_model(sd) == j_detect(sd) == {
        "kind": "hrnet", "width": 32, "ocr_width": 128, "small": False}


# ---------------------------------------------------------------- f-BRS

def _flip_batch(image, clicks):
    bpoints = np.concatenate([clicks, clicks.copy()])
    bpoints[1, :, 1] = np.where(clicks[0, :, 1] >= 0, W - 1 - clicks[0, :, 1], -1)
    return np.concatenate([image[:1], image[:1, :, ::-1]]), bpoints


@pytest.mark.parametrize("insertion", ["A", "C"])
def test_fbrs_optimize_matches_jax(nets, inputs, monkeypatch, insertion):
    """One optimization at HRNet insertion 'A' (960 variables) and 'C'
    (256), the JAX side jitted as the predictor runs it; its iteration
    count is read out of the jitted loop by a callback."""
    jnet, _, tree, net = nets
    image, _ = inputs
    clicks = np.array([[[30, 40], [-1, -1], [20, 10], [12, 60]]], np.float32)
    batch, bpoints = _flip_batch(image, clicks)
    method = tfp.INSERTION_MODES[insertion][0]
    feats = np.asarray(jnet.apply(tree, jnp.asarray(batch), jnp.asarray(bpoints),
                                  method=method))
    pos, neg = np.zeros((1, H, W, 1), np.float32), np.zeros((1, H, W, 1), np.float32)
    pos[0, 29:32, 39:42] = 1
    neg[0, 19:22, 9:12] = 1
    neg[0, 11:14, 59:62] = 1
    x0 = (np.random.RandomState(1).randn(2 * feats.shape[-1]) * 0.05).astype(np.float32)

    iters = []

    def recording(*args, **kw):
        best_x, info = jlbfgs.lbfgs_minimize(*args, **kw)
        jax.debug.callback(lambda it: iters.append(int(it)), info["iters"])
        return best_x, info

    monkeypatch.setattr(jfp, "lbfgs_minimize", recording)
    jfp._fbrs_fns.cache_clear()
    optimize = jfp._fbrs_fns(jnet, insertion)[2]
    _, jlogits = optimize(tree, jnp.asarray(feats), jnp.zeros((0,)),
                          jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(x0), H, W)
    jfp._fbrs_fns.cache_clear()
    jprob = 1 / (1 + np.exp(-np.asarray(jlogits)))
    jprob = 0.5 * (jprob[:1] + jprob[1:, :, ::-1])[0, ..., 0]

    _, logits, info = tfp.fbrs_optimize(net, _nchw(feats), _nchw(pos), _nchw(neg),
                                        _t(x0), (H, W), 20, insertion)
    prob = torch.sigmoid(logits)
    prob = (0.5 * (prob[:1] + prob[1:].flip(-1)))[0, 0].numpy()
    jax.effects_barrier()   # the iteration callback has run
    assert info["iters"] == iters[0] > 0
    np.testing.assert_allclose(prob, jprob, atol=1e-3, rtol=0)   # 1e-3 abs
    mask, jmask = prob > 0.49, jprob > 0.49
    assert 0.05 < jmask.mean() < 0.95
    assert _iou(mask, jmask) >= 0.999


def _ellipse_gt(fh, fw):
    yy, xx = np.mgrid[:fh, :fw]
    return (((yy - 26) / 15) ** 2 + ((xx - 40) / 24) ** 2 <= 1).astype(np.int32)


@pytest.mark.parametrize("brs_mode", ["f-BRS-B", "f-BRS-C"])
def test_hrnet_drive_matches_jax(nets, brs_mode):
    """Four clicks of the NoC user through get_predictor (HRNet maps
    f-BRS-B to insertion 'A', f-BRS-C to 'C') with ZoomIn."""
    jnet, _, tree, net = nets
    image = np.random.RandomState(8).randn(H, W, 3).astype(np.float32)
    gt = _ellipse_gt(H, W)
    zoom = {"target_size": 64, "min_crop_size": 30}
    jpred = jfp.get_predictor(jnet, tree, brs_mode, zoom_in_params=zoom)
    tpred = tfp.get_predictor(net, brs_mode, zoom_in_params=zoom, device="cpu")
    assert tpred.insertion_mode == jpred.insertion_mode == \
        {"f-BRS-B": "A", "f-BRS-C": "C"}[brs_mode]
    jclicks, jious, jprobs = jnoc.evaluate_sample(image, gt, jpred,
                                                  max_iou_thr=1.1, max_clicks=4)
    tclicks, tious, probs = noc.evaluate_sample(image, gt, tpred,
                                                max_iou_thr=1.1, max_clicks=4)
    assert [(c.is_positive, c.coords) for c in tclicks] == \
        [(c.is_positive, c.coords) for c in jclicks]
    assert tpred.last_info["iters"] > 0
    np.testing.assert_allclose(tious, jious, atol=1e-3, rtol=0)   # 1e-3 apart
    # The maps themselves part by up to 7e-3 after four clicks: with the
    # same head input both packages optimize to within 2e-6, but the
    # step of L-BFGS's third iteration carries the head inputs' float32
    # difference (5e-7 of their scale) into x 5e-3 of its scale, as a
    # 7e-5 perturbation of the port's own input does. Held as the card is
    # held to the CPU: mask IoU 0.99.
    jprobs = np.asarray(jprobs)
    assert _iou(probs > 0.49, jprobs > 0.49) >= 0.99, np.abs(probs - jprobs).max()


def test_click_to_mask_loads_an_hrnet_checkpoint(nets, tmp_path):
    """`python -m mivos_tpu_torch.click_to_mask --fbrs_model` with a
    reference-named HRNet .pth: detected, built and strictly loaded."""
    from PIL import Image

    from mivos_tpu_torch import click_to_mask

    *_, net = nets
    torch.save(net.state_dict(), tmp_path / "hrnet.pth")
    rgb = (np.random.RandomState(2).rand(H, W, 3) * 255).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "img.png")
    out = tmp_path / "mask.png"
    click_to_mask.main(["--image", str(tmp_path / "img.png"),
                        "--fbrs_model", str(tmp_path / "hrnet.pth"),
                        "--clicks", "20,30,+ 5,60,-", "--zoom_target", "64",
                        "--brs_mode", "f-BRS-C", "--output", str(out),
                        "--device", "cpu"])
    mask = Image.open(out)
    assert mask.mode == "P" and mask.size == (W, H)
    assert set(np.unique(np.asarray(mask))) <= {0, 1}
