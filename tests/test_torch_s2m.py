"""The PyTorch port's S2M (scribble-to-mask) path against the JAX package.

One flax parameter tree for `S2MNetwork`, with the JAX module's exact
structure and random values drawn with numpy (non-trivial frozen-BN
statistics included), carried into the port by
checkpoint/from_jax.py; the same numpy inputs then go through both. fp32
on the CPU with TF32 off. At 64x96 the 1/16 map is 4x6, smaller than
the ASPP dilations (6, 12, 18), so the zero padding of both frameworks
is on the line.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import assert_tree_matches, convert_s2m
from mivos_tpu.interactive.s2m_controller import S2MController as JS2MController
from mivos_tpu.models.resnet import ResNet50 as JResNet50
from mivos_tpu.models.s2m import S2MNetwork as JS2MNetwork
from mivos_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.interactive.s2m_controller import S2MController
from mivos_tpu_torch.interactive.scribbles import scribbles2mask
from mivos_tpu_torch.models.resnet import ResNet50
from mivos_tpu_torch.models.s2m import S2MNetwork
from test_torch_models import _random_tree

K, H, W = 2, 64, 96
RH, RW = 45, 62            # controller: raw grid, padded to 48x64
REL = 1e-4                 # of each output's largest magnitude
PROB_ATOL = 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))


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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jnet = JS2MNetwork()
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                              jnp.zeros((K, H, W, 6)))
    tree = _random_tree(abstract, seed=3)
    net = S2MNetwork().eval()
    net.load_state_dict(state_dict_from_flax(tree), strict=True)
    return jnet, abstract, tree, net


@pytest.fixture(scope="module")
def x6():
    rng = np.random.RandomState(11)
    x = rng.randn(K, H, W, 6).astype(np.float32)
    x[..., 3:] = (rng.rand(K, H, W, 3) > 0.7)   # mask and scribble planes
    return x


def test_dilated_resnet50_matches_jax(nets, x6):
    _, _, tree, _ = nets
    jnet = JResNet50(in_chans=6, num_stages=4, layer4_dilation=2)
    ref = jnet.apply({"params": tree["params"]["backbone"]}, jnp.asarray(x6))
    port = ResNet50(in_chans=6, num_stages=4, layer4_dilation=2).eval()
    sd = {k[len("backbone."):]: v
          for k, v in state_dict_from_flax(tree).items()
          if k.startswith("backbone.")}
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = port(_t(x6).movedim(-1, 1))
    assert len(out) == len(ref) == 4
    # layer4 keeps 1/16: stride replaced by dilation.
    assert out[0].shape[-2:] == out[1].shape[-2:] == (H // 16, W // 16)
    assert out[0].shape[1] == 2048
    for o, r in zip(out, ref):
        _close(_nhwc(o), r)


def test_resnet50_rejects_unsupported_stages():
    with pytest.raises(ValueError):
        ResNet50(num_stages=5)
    with pytest.raises(ValueError):
        ResNet50(num_stages=4, layer4_dilation=4)


def test_s2m_network_matches_jax(nets, x6):
    jnet, _, tree, net = nets
    ref = np.asarray(jnet.apply(tree, jnp.asarray(x6)))
    with torch.no_grad():
        out = _nhwc(net(_t(x6).movedim(-1, 1)))
    assert out.shape == ref.shape == (K, H, W, 1)
    assert out.dtype == np.float32
    err = np.abs(out - ref).max()
    assert err <= 1e-4 * np.abs(ref).mean(), (err, np.abs(ref).mean())
    prob, jprob = 1 / (1 + np.exp(-out)), 1 / (1 + np.exp(-ref))
    np.testing.assert_allclose(prob, jprob, atol=PROB_ATOL, rtol=0)


def test_state_dict_converts_onto_the_jax_tree(nets):
    _, abstract, _, net = nets
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    converted = convert_s2m(sd)
    assert_tree_matches(converted, abstract)
    assert (len(jax.tree_util.tree_leaves(converted))
            == len(jax.tree_util.tree_leaves(abstract)) == len(sd))


def test_reference_names(nets):
    names = set(nets[3].state_dict())
    for key in ("backbone.conv1.weight", "backbone.layer4.0.downsample.0.weight",
                "backbone.layer4.2.bn3.running_var",
                "classifier.project.0.weight", "classifier.project.1.running_mean",
                "classifier.aspp.convs.0.1.weight", "classifier.aspp.convs.3.0.weight",
                "classifier.aspp.convs.4.1.weight", "classifier.aspp.convs.4.2.bias",
                "classifier.aspp.project.0.weight", "classifier.aspp.project.1.bias",
                "classifier.classifier.0.weight", "classifier.classifier.1.weight",
                "classifier.classifier.3.weight", "classifier.classifier.3.bias"):
        assert key in names, key
    assert all("bn" not in k or ".bn" in k for k in names)  # bn only on BN
    # Only the final classifier conv carries a bias.
    biased = {k for k in names if k.endswith(".bias")
              and k.replace(".bias", ".running_mean") not in names}
    assert biased == {"classifier.classifier.3.bias"}


def test_bridge_round_trip_and_equal_outputs(nets, x6):
    _, _, tree, net = nets
    back = convert_s2m({k: v.numpy() for k, v in net.state_dict().items()})
    orig = jax.tree_util.tree_leaves_with_path(tree)
    back_leaves = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(orig) == len(back_leaves)
    for path, leaf in orig:
        np.testing.assert_array_equal(back_leaves[path], np.asarray(leaf))
    twin = S2MNetwork().eval()
    missing, unexpected = twin.load_state_dict(state_dict_from_flax(back),
                                               strict=True)
    assert not missing and not unexpected
    with torch.no_grad():
        x = _t(x6).movedim(-1, 1)
        assert torch.equal(twin(x), net(x))


@pytest.mark.parametrize("nested", [False, True])
def test_load_reference_pth_drops_bn_counters(nets, tmp_path, nested):
    net = nets[3]
    sd = dict(net.state_dict())
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    path = tmp_path / "s2m.pth"
    torch.save({"network": sd} if nested else sd, path)
    loaded = load_reference_pth(S2MNetwork(), str(path))
    for k, v in net.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    del sd["classifier.classifier.3.bias"]
    torch.save(sd, path)
    with pytest.raises(RuntimeError):
        load_reference_pth(S2MNetwork(), str(path))   # strict


def _scribble_map(ignore_class):
    """Random polylines of objects 0..K on the raw grid, rasterized with
    the port's scribbles2mask (-1 = no scribble), ignore -> ignore_class."""
    rng = np.random.RandomState(5)
    lines = [{"path": rng.rand(rng.randint(2, 6), 2).tolist(), "object_id": o}
             for o in (0, 1, 2, 1)]
    scr = scribbles2mask({"scribbles": [lines]}, (RH, RW))[0]
    assert {-1, 0, 1, 2} <= set(np.unique(scr))
    return np.where(scr == -1, ignore_class, scr).astype(np.int32)


@pytest.fixture(scope="module")
def controller_inputs():
    rng = np.random.RandomState(9)
    image = rng.randn(48, 64, 3).astype(np.float32)
    prev = rng.randint(0, K + 1, (48, 64)).astype(np.uint8)
    return image, prev


@pytest.mark.parametrize("ignore_class,dilate_radius",
                         [(-1, 0), (-1, 1), (255, 0), (255, 1)])
def test_controller_matches_jax(nets, controller_inputs, ignore_class,
                                dilate_radius):
    jnet, _, tree, net = nets
    image, prev = controller_inputs
    scr = _scribble_map(ignore_class)
    jc = JS2MController(jnet, tree, K, ignore_class=ignore_class,
                        dilate_radius=dilate_radius)
    tc = S2MController(net, K, ignore_class=ignore_class,
                       dilate_radius=dilate_radius)
    # The scribble planes: the port's 3x3 max-pool against cv2.dilate.
    ref_srb = np.moveaxis(jc._scribble_channels(scr), -1, 1)
    np.testing.assert_array_equal(tc._scribble_channels(scr).numpy(), ref_srb)
    jprob = np.asarray(jc.interact(jnp.asarray(image), prev, scr))
    prob = tc.interact(_t(image), prev, scr)
    assert tuple(prob.shape) == (K, 48, 64, 1)
    np.testing.assert_allclose(prob.numpy(), jprob, atol=PROB_ATOL, rtol=0)
    jhard = np.asarray(jc.interact(jnp.asarray(image), prev, scr,
                                   aggregate_hard=True))
    hard = tc.interact(_t(image), prev, scr, aggregate_hard=True).numpy()
    assert hard.shape == (K + 1, 48, 64, 1)
    np.testing.assert_allclose(hard.sum(0), 1.0, atol=1e-5)
    # The hard aggregate is a softmax of 1000x the logits of
    # (prod(1 - p), p_1..p_K): where JAX's top two logits are 0.02 apart
    # it is one-hot to e^-20 in both frameworks.
    p = np.clip(np.concatenate([np.prod(1 - jprob, 0, keepdims=True), jprob]),
                1e-7, 1 - 1e-7)
    top2 = np.sort(np.log(p / (1 - p)), axis=0)[-2:]
    decided = (top2[1] - top2[0]) > 0.02
    assert decided.mean() > 0.9
    np.testing.assert_allclose(hard[:, decided], jhard[:, decided], atol=1e-6,
                               rtol=0)
