"""The PyTorch port's S2MPretrainer, FBRSPretrainer and
calibrate_frozen_bn against the JAX package's, on the CPU, with the
checks of tests/test_torch_pretrain.py (`_compare_runs`: first step's
loss and IoU within 1e-5 relative, its clipped gradient within 1e-4 of
its global norm, every state_dict tensor within 3 * lr of JAX's after 3
steps, the same tensors changed).

S2M runs in float32. The f-BRS cases run in float64 in both packages
(jax.enable_x64, the port's net .double()): in float32 the random tree's
ResNet-50 backbone has ReLU inputs within rounding of zero, so two
correct float32 implementations differ there by 1e-3 of a backbone
gradient, and Adam's first step turns every entry below that into a full
+-lr move in either direction. calibrate_frozen_bn writes float32
statistics in both packages whatever the net's dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import convert_fbrs
from mivos_tpu.models import fbrs as j_fbrs
from mivos_tpu.models.fbrs import FBRSDeepLabModel as JFBRS
from mivos_tpu.models.initializer import calibrate_frozen_bn as j_calibrate
from mivos_tpu.models.s2m import S2MNetwork as JS2M
from mivos_tpu.train import pretrain as jpt
from mivos_tpu_torch.checkpoint.from_jax import (fbrs_state_dict_from_flax,
                                                 state_dict_from_flax)
from mivos_tpu_torch.models import fbrs
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.initializer import calibrate_frozen_bn, init_params
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.train import pretrain
from test_torch_models import _random_tree
from test_torch_pretrain import LR, _compare_runs, _reset

SH, SW = 48, 64
FH, FW, F_CH, F_POINTS, F_BATCH = 48, 48, 32, 4, 2
STATS = ("running_mean", "running_var")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


def _f64(tree):
    return jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), tree)


def _stats_close(got, want, rel=1e-5):
    """Every FrozenBatchNorm statistic of `got` within `rel` of `want`'s,
    relative to the input it summarizes: the means' error over the
    largest channel RMS sqrt(mean^2 + var) of the BN's input, the
    variances' over its square (a mean near zero has no scale of its
    own)."""
    n = 0
    for k, v in want.items():
        if k.endswith("running_mean"):
            var = want[k[:-len("mean")] + "var"].double()
            ms = float((v.double() ** 2 + var).max())
            for stat, scale in ((k, ms ** 0.5), (k[:-len("mean")] + "var", ms)):
                err = float((got[stat].double() - want[stat].double()).abs().max())
                assert err <= rel * scale, (stat, err, scale)
            n += 1
    assert n


def _fresh_fbrs(arch, ch):
    """A flax-style random init (the port's init_params) of an f-BRS
    model, and the same weights as a flax tree."""
    net = init_params(FBRSDeepLabModel(arch, ch=ch), torch.Generator().manual_seed(0))
    return net, convert_fbrs({k: v.numpy() for k, v in net.state_dict().items()})


# ---------------------------------------------------------------- s2m

def test_s2m_pretrainer_matches_jax():
    jnet = JS2M()
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                              jnp.zeros((2, SH, SW, 6)))
    tree = _random_tree(abstract, seed=6)
    jtr = jpt.S2MPretrainer(net=jnet, params=tree, lr=LR, hw=(SH, SW))
    sd = state_dict_from_flax(tree)
    tr = pretrain.S2MPretrainer(net=S2MNetwork(), params=sd, lr=LR,
                                hw=(SH, SW), device="cpu")
    (x, gt), (jx, jgt) = tr.make_batch(4), jtr.make_batch(4)
    np.testing.assert_array_equal(x, np.asarray(jx).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(gt, np.asarray(jgt).transpose(0, 3, 1, 2))
    _compare_runs(jtr, tr, state_dict_from_flax, (4, 5, 6), (sd, sd))


# ---------------------------------------------------------------- fbrs

# A 1-block-a-stage basic-block ResNetV1b, added to both packages' arch
# tables for these tests: 10 calibration iterations converge on it (on a
# ResNet-50 they leave the deep statistics measured on exploded inputs,
# which amplifies rounding; see
# test_calibrate_frozen_bn_matches_jax_per_iteration). The bottleneck
# ResNet-50's forward is held to JAX in tests/test_torch_fbrs.py.
RESNET10 = dict(layers=(1, 1, 1, 1), block="basic", deep_stem=False)


@pytest.fixture(scope="module")
def fbrs_setup():
    """The JAX trainer of the f-BRS cases (its compiled step is shared)
    and a random tree for it, float64."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(j_fbrs.RESNETV1B_ARCHS, "resnet10", RESNET10)
        jnet = JFBRS(arch="resnet10", ch=F_CH)
        abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                  jnp.zeros((1, FH, FW, 3)),
                                  jnp.full((1, 2 * F_POINTS, 2), -1.0))
    tree = _f64(_random_tree(abstract, seed=8))
    with jax.enable_x64(True):
        jtr = jpt.FBRSPretrainer(net=jnet, params=tree, lr=LR, hw=(FH, FW),
                                 n_points=F_POINTS, batch=F_BATCH)
    return jtr, tree


@pytest.fixture
def resnet10(monkeypatch):
    monkeypatch.setitem(j_fbrs.RESNETV1B_ARCHS, "resnet10", RESNET10)
    monkeypatch.setitem(fbrs.RESNETV1B_ARCHS, "resnet10", RESNET10)


def _check_batch(tr, jtr, seed):
    imgs, pts, gts = tr.make_batch(seed)
    jimgs, jpts, jgts = jtr.make_batch(seed)
    np.testing.assert_array_equal(imgs, np.asarray(jimgs).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(pts, np.asarray(jpts))
    np.testing.assert_array_equal(gts, np.asarray(jgts).transpose(0, 3, 1, 2))


def test_fbrs_pretrainer_matches_jax(fbrs_setup, resnet10):
    jtr, tree = fbrs_setup
    sd = fbrs_state_dict_from_flax(tree)
    with jax.enable_x64(True):
        _reset(jtr, tree)
        tr = pretrain.FBRSPretrainer(
            net=FBRSDeepLabModel("resnet10", ch=F_CH).double(), params=sd,
            lr=LR, hw=(FH, FW), n_points=F_POINTS, batch=F_BATCH, device="cpu")
        _check_batch(tr, jtr, 11)
        _compare_runs(jtr, tr, fbrs_state_dict_from_flax, (11, 12, 13), (sd, sd))


def test_fbrs_pretrainer_calibrate_bn_matches_jax(fbrs_setup, resnet10,
                                                  monkeypatch):
    """calibrate_bn=True on a fresh flax-style init (the port's draw; the
    JAX trainer gets the same weights from a patched init_params), 10
    iterations on the first batch in each package's own trainer:
    statistics within 1e-5 of the input's scale, then 3 steps from the
    port's calibrated weights."""
    fresh, tree = _fresh_fbrs("resnet10", F_CH)
    fresh_sd = {k: v.clone() for k, v in fresh.state_dict().items()}
    tree = _f64(tree)
    monkeypatch.setattr(j_fbrs, "init_params", lambda *a, **k: tree)
    monkeypatch.setattr(pretrain, "init_params",
                        lambda module, gen, *flavor: module.load_state_dict(fresh_sd))
    seed, kw = 11, dict(lr=LR, hw=(FH, FW), n_points=F_POINTS, batch=F_BATCH)
    with jax.enable_x64(True):
        jtr = jpt.FBRSPretrainer(net=JFBRS(arch="resnet10", ch=F_CH),
                                 seed=seed, calibrate_bn=True, **kw)
        jtr._step = fbrs_setup[0]._step   # the same program, compiled once
        tr = pretrain.FBRSPretrainer(
            net=FBRSDeepLabModel("resnet10", ch=F_CH).double(), seed=seed,
            calibrate_bn=True, device="cpu", **kw)
        calibrated = {k: v.clone() for k, v in tr.state_dict().items()}
        _stats_close(calibrated, fbrs_state_dict_from_flax(jtr.params))
        for k, v in fresh_sd.items():
            assert torch.equal(v.double(), calibrated[k]) != k.endswith(STATS), k
        tree = _f64(convert_fbrs({k: v.numpy() for k, v in calibrated.items()}))
        _reset(jtr, tree)
        _check_batch(tr, jtr, seed)
        _compare_runs(jtr, tr, fbrs_state_dict_from_flax, (seed, 12, 13),
                      (fbrs_state_dict_from_flax(tree), calibrated))


def test_fbrs_pretrainer_refuses_the_gluon_init(resnet10):
    """The gluon flavour, once refused, now builds and steps: XavierGluon
    kernels within their bounds, unit BN gammas, a finite step that moves
    the weights; an unknown flavour is refused."""
    tr = pretrain.FBRSPretrainer(net=FBRSDeepLabModel("resnet10", ch=F_CH),
                                 init_flavor="gluon", hw=(FH, FW),
                                 n_points=F_POINTS, batch=F_BATCH, device="cpu")
    before = {k: v.clone() for k, v in tr.net.state_dict().items()}
    w = before["feature_extractor.backbone.layer1.0.conv1.weight"]
    fan = w.shape[1] * w[0, 0].numel(), w.shape[0] * w[0, 0].numel()
    assert float(w.abs().max()) <= (3.0 / (sum(fan) / 2)) ** 0.5
    assert torch.all(before["feature_extractor.backbone.bn1.weight"] == 1)
    loss, iou = tr.step(0)
    assert np.isfinite(loss) and 0.0 <= iou <= 1.0
    assert not torch.equal(tr.net.state_dict()["head.layers.2.weight"],
                           before["head.layers.2.weight"])
    with pytest.raises(ValueError):
        pretrain.FBRSPretrainer(init_flavor="lecun", device="cpu")


# ---------------------------------------------------------------- calibrate

def test_calibrate_frozen_bn_matches_jax_per_iteration():
    """A narrow basic-block tower (ResNet-34, ch 16) from a flax-style
    init, whose uncalibrated activations grow block by block. Three
    iterations, each from JAX's previous result in both packages (the
    iteration is a map from statistics to statistics, and far from
    convergence it amplifies float32 differences): means and variances
    within 1e-5 of the input's scale; every other tensor bit-equal to
    the input, a buffer outside FrozenBatchNorm included (the JAX version
    returns only the params collection, initializer.py:152); `iters`
    forwards; the hooks gone, also after a forward that raises."""
    net, tree = _fresh_fbrs("resnet34", 16)
    jnet = JFBRS(arch="resnet34", ch=16)
    rng = np.random.RandomState(3)
    image = rng.randn(2, 32, 48, 3).astype(np.float32)
    points = np.full((2, 4, 2), -1.0, np.float32)
    points[:, 0] = (10, 20)
    x, p = torch.from_numpy(image).permute(0, 3, 1, 2), torch.from_numpy(points)
    net.register_buffer("extra", torch.arange(5.0))
    for _ in range(3):
        net.load_state_dict(fbrs_state_dict_from_flax(tree), strict=False)
        before = {k: v.clone() for k, v in net.state_dict().items()}
        tree = j_calibrate(jnet, tree, (image, points), iters=1)
        assert calibrate_frozen_bn(net, lambda: net(x, p), iters=1) is net
        after = net.state_dict()
        _stats_close(after, fbrs_state_dict_from_flax(tree))
        for k, v in before.items():
            if not k.endswith(STATS):
                assert torch.equal(after[k], v), k
        assert not any(torch.equal(after[k], v) for k, v in before.items()
                       if k.endswith("running_var"))

    forwards = []
    calibrate_frozen_bn(net, lambda: forwards.append(net(x, p)), iters=4)
    assert len(forwards) == 4

    def broken():
        net(x, p)
        raise RuntimeError("forward failed")

    with pytest.raises(RuntimeError):
        calibrate_frozen_bn(net, broken)
    assert all(not m._forward_pre_hooks for m in net.modules())
