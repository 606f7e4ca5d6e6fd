"""The PyTorch port's networks and weight bridge against the JAX package.

One flax parameter tree per network, with the JAX modules' exact
structure (from `jax.eval_shape` of their init) and random values drawn
with numpy -- including non-trivial frozen-BN statistics, so a mixed-up
BN mapping cannot pass. The bridge (checkpoint/from_jax.py) carries the
tree into the port; the same numpy inputs then go through both. fp32 on
the CPU; each output must agree to 1e-4 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import convert_fusion_net, convert_prop_net
from mivos_tpu.models.fusion import FusionNet as JFusionNet
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.models.resnet import ResNet50 as JResNet50
from mivos_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.propagation import PropagationNetwork

K, H, W = 2, 48, 64
REL = 1e-4


def _random_tree(abstract, seed):
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        shape = leaf.shape
        if any("bn" in n for n in names[:-1]):
            kind = names[-1]
            if kind in ("scale", "var"):
                return rng.uniform(0.5, 1.5, shape).astype(np.float32)
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        if names[-1] == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)
        return (rng.randn(*shape) * 0.05).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, abstract)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.abs(ref).max()
    assert scale > 0
    err = np.abs(out - ref).max()
    assert err <= REL * scale, (err, scale)


def _t(x):
    return torch.from_numpy(np.array(x))


def _nhwc(x):
    return x.movedim(1, -1).numpy()


@pytest.fixture(scope="module")
def nets():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jprop = JPropagation(top_k=10, read_backend="xla_exact")
    jfuse = JFusionNet()
    f0, m0 = jnp.zeros((H, W, 3)), jnp.zeros((K, H, W, 1))
    pp = _random_tree(jax.eval_shape(jprop.init, jax.random.PRNGKey(0),
                                     f0, m0, f0), seed=0)
    fp = _random_tree(jax.eval_shape(
        jfuse.init, jax.random.PRNGKey(1), jnp.zeros((K, H, W, 3)), m0, m0,
        jnp.zeros((K, H, W, 2)), jnp.zeros((K, 2))), seed=1)
    prop = PropagationNetwork(top_k=10, read_backend="exact").eval()
    fuse = FusionNet().eval()
    prop.load_state_dict(state_dict_from_flax(pp), strict=True)
    fuse.load_state_dict(state_dict_from_flax(fp), strict=True)
    return jprop, pp, prop, jfuse, fp, fuse


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(7)
    return {"frame": rng.randn(H, W, 3).astype(np.float32),
            "frames": rng.randn(3, H, W, 3).astype(np.float32),
            "masks": rng.rand(K, H, W, 1).astype(np.float32),
            "pos": rng.rand(K, H, W, 1).astype(np.float32),
            "neg": rng.rand(K, H, W, 1).astype(np.float32)}


# ---------------------------------------------------------------- (e)

@pytest.mark.parametrize("which", ["prop", "fusion"])
def test_bridge_loads_strict_and_round_trips(nets, which):
    jprop, pp, prop, jfuse, fp, fuse = nets
    tree, module, convert = ((pp, prop, convert_prop_net) if which == "prop"
                             else (fp, fuse, convert_fusion_net))
    sd = state_dict_from_flax(tree)
    missing, unexpected = module.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    assert all("bn" not in k or ".bn" in k for k in sd)  # bn only on BN
    back = convert({k: v.numpy() for k, v in module.state_dict().items()})
    orig = jax.tree_util.tree_leaves_with_path(tree)
    back = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(orig) == len(back)
    for path, leaf in orig:
        np.testing.assert_array_equal(back[path], np.asarray(leaf))


def test_bridge_uses_reference_names(nets):
    prop, fuse = nets[2], nets[5]
    names = set(prop.state_dict()) | set(fuse.state_dict())
    for key in ("rgb_encoder.res2.0.conv1.weight",
                "mask_rgb_encoder.layer1.0.downsample.0.weight",
                "mask_rgb_encoder.layer1.0.downsample.1.running_var",
                "mask_rgb_encoder.bn1.running_mean",
                "decoder.up_16_8.skip_conv2.conv1.weight",
                "conv1.0.weight", "conv2.2.bias", "conv3.0.weight",
                "final_conv.weight"):
        assert key in names, key


# ---------------------------------------------------------------- (f)

@pytest.mark.parametrize("which", ["rgb_encoder", "mask_rgb_encoder"])
def test_resnet50_matches_jax(nets, inputs, which):
    jprop, pp, prop = nets[:3]
    chans = 3 if which == "rgb_encoder" else 5
    x = np.concatenate([inputs["frames"][:2]] + [inputs["masks"]] * (chans - 3),
                       axis=-1)[:, :, :, :chans]
    jnet = JResNet50(in_chans=chans, conv_bias=which != "rgb_encoder")
    ref = jnet.apply({"params": pp["params"][which]}, jnp.asarray(x))
    with torch.no_grad():
        out = getattr(prop, which)(_t(x).movedim(-1, 1))
    assert len(out) == len(ref) == 3
    for o, r in zip(out, ref):
        _close(_nhwc(o), r)


def test_memorize_matches_jax(nets, inputs):
    jprop, pp, prop = nets[:3]
    jk, jv = jprop.apply(pp, jnp.asarray(inputs["frame"]),
                         jnp.asarray(inputs["masks"]), method="memorize")
    with torch.no_grad():
        tk, tv = prop.memorize(_t(inputs["frame"]), _t(inputs["masks"]))
    assert tuple(tk.shape) == (K, (H // 16) * (W // 16), 128)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)


def test_query_values_match_jax(nets, inputs):
    jprop, pp, prop = nets[:3]
    ref = jprop.apply(pp, jnp.asarray(inputs["frame"]),
                      method="get_query_values")
    with torch.no_grad():
        out = prop.get_query_values(_t(inputs["frame"]))
    for o, r in zip(out, ref):
        _close(_nhwc(o), r)
    ref_b = jprop.apply(pp, jnp.asarray(inputs["frames"]),
                        method="get_query_values_batched")
    with torch.no_grad():
        out_b = prop.get_query_values_batched(_t(inputs["frames"]))
    for o, r in zip(out_b, ref_b):
        _close(_nhwc(o), r)


@pytest.mark.parametrize("preskip", [False, True])
def test_segment_with_query_matches_jax(nets, inputs, preskip):
    jprop, pp, prop = nets[:3]
    frame, masks = jnp.asarray(inputs["frame"]), jnp.asarray(inputs["masks"])
    mk, mv = jprop.apply(pp, frame, masks, method="memorize")
    m = mk.shape[1]
    valid = np.arange(m) < m - 3
    q = jprop.apply(pp, jnp.asarray(inputs["frames"][0]),
                    method="get_query_values")
    f16, f8, f4, k16, v16 = q
    if preskip:
        f8, f4 = jprop.apply(pp, f8, f4, method="query_skips")
    ref = jprop.apply(pp, mk, mv, jnp.asarray(valid), f16, f8, f4, k16, v16,
                      preskip=preskip, method="segment_with_query")
    tq = [_t(x).movedim(-1, 1) for x in (f16, f8, f4, k16, v16)]
    with torch.no_grad():
        out = prop.segment_with_query(_t(mk), _t(mv), _t(valid), *tq,
                                      preskip=preskip)
    assert tuple(out.shape) == (K, H, W, 1)
    _close(out.numpy(), ref)


def test_get_attention_matches_jax(nets, inputs):
    jprop, pp, prop = nets[:3]
    mk, _ = jprop.apply(pp, jnp.asarray(inputs["frame"]),
                        jnp.asarray(inputs["masks"]), method="memorize")
    k16 = jprop.apply(pp, jnp.asarray(inputs["frames"][1]),
                      method="get_query_values")[3]
    ref = jprop.apply(pp, mk, jnp.asarray(inputs["pos"]),
                      jnp.asarray(inputs["neg"]), k16, method="get_attention")
    with torch.no_grad():
        out = prop.get_attention(_t(mk), _t(inputs["pos"]), _t(inputs["neg"]),
                                 _t(k16).movedim(-1, 1))
    assert tuple(out.shape) == (K, 2, H, W)
    _close(_nhwc(out), ref)


def test_fusion_net_matches_jax(nets, inputs):
    jfuse, fp, fuse = nets[3:]
    rng = np.random.RandomState(8)
    im = rng.randn(K, H, W, 3).astype(np.float32)
    seg1, seg2 = inputs["masks"], inputs["pos"]
    attn = rng.rand(K, H, W, 2).astype(np.float32)
    tc = rng.rand(K, 2).astype(np.float32)
    ref = jfuse.apply(fp, *(jnp.asarray(x) for x in (im, seg1, seg2, attn, tc)))
    with torch.no_grad():
        out = fuse(*(_t(x).movedim(-1, 1) for x in (im, seg1, seg2, attn)),
                   _t(tc))
    _close(_nhwc(out), ref)
