"""The slim decoder (`dec_width`) and the biased ResNet stem
(`stem_bias`) of the PyTorch port against the JAX package.

Flax trees of the JAX modules' exact structure (`jax.eval_shape` of
their init) with random numpy values (tests/test_torch_models.py's
`_random_tree`), carried into the port by checkpoint/from_jax.py; the
same numpy inputs through both, fp32 on the CPU, each output within
1e-4 of its largest magnitude (as tests/test_torch_models.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import REL, _close, _nhwc, _random_tree, _t

from mivos_tpu.checkpoint.convert import convert_prop_net
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.models.resnet import ResNet50 as JResNet50
from mivos_tpu_torch.checkpoint.from_jax import (resnet_state_dict_from_flax,
                                                 state_dict_from_flax)
from mivos_tpu_torch.models.propagation import Decoder, PropagationNetwork
from mivos_tpu_torch.models.resnet import ResNet50

K, H, W = 2, 48, 64
WIDTH = 0.5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_serve.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def slim():
    jprop = JPropagation(top_k=10, read_backend="xla_exact", dec_width=WIDTH)
    f0, m0 = jnp.zeros((H, W, 3)), jnp.zeros((K, H, W, 1))
    pp = _random_tree(jax.eval_shape(jprop.init, jax.random.PRNGKey(0), f0, m0, f0), seed=3)
    prop = PropagationNetwork(top_k=10, read_backend="exact", dec_width=WIDTH).eval()
    prop.load_state_dict(state_dict_from_flax(pp), strict=True)
    return jprop, pp, prop


def test_slim_decoder_channels_and_bridge(slim):
    jprop, pp, prop = slim
    assert Decoder.chan(512, WIDTH) == 256 and Decoder.chan(20, 0.5) == 16
    assert prop.decoder.compress.conv1.weight.shape[0] == 256
    assert prop.decoder.pred.weight.shape[1] == 128
    with pytest.raises(RuntimeError):   # a width-1.0 net refuses the slim tree
        PropagationNetwork().load_state_dict(state_dict_from_flax(pp), strict=True)
    back = convert_prop_net({k: v.numpy() for k, v in prop.state_dict().items()})
    flat = jax.tree_util.tree_leaves_with_path(back["params"])
    ref = dict(jax.tree_util.tree_leaves_with_path(pp["params"]))
    assert len(flat) == len(ref)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(ref[path]))


@pytest.mark.parametrize("preskip", [False, True])
def test_slim_segment_with_query_matches_jax(slim, preskip):
    jprop, pp, prop = slim
    rng = np.random.RandomState(7)
    frame = jnp.asarray(rng.randn(H, W, 3).astype(np.float32))
    masks = jnp.asarray(rng.rand(K, H, W, 1).astype(np.float32))
    mk, mv = jprop.apply(pp, frame, masks, method="memorize")
    f16, f8, f4, k16, v16 = jprop.apply(pp, jnp.asarray(rng.randn(H, W, 3).astype(np.float32)),
                                        method="get_query_values")
    if preskip:
        f8, f4 = jprop.apply(pp, f8, f4, method="query_skips")
    ref = jprop.apply(pp, mk, mv, None, f16, f8, f4, k16, v16, preskip=preskip,
                      method="segment_with_query")
    tq = [_t(x).movedim(-1, 1) for x in (f16, f8, f4, k16, v16)]
    with torch.no_grad():
        out = prop.segment_with_query(_t(mk), _t(mv), None, *tq, preskip=preskip)
    _close(out.numpy(), ref)
    if preskip:   # the skip towers at the slim widths
        assert tq[1].shape[1] == 256 and tq[2].shape[1] == 128


@pytest.mark.parametrize("conv_bias,stem_bias", [(False, True), (True, False)])
def test_stem_bias_resnet_matches_jax(conv_bias, stem_bias):
    jnet = JResNet50(in_chans=3, conv_bias=conv_bias, stem_bias=stem_bias)
    x = np.random.RandomState(9).randn(2, H, W, 3).astype(np.float32)
    tree = _random_tree(jax.eval_shape(jnet.init, jax.random.PRNGKey(0), jnp.asarray(x)),
                        seed=4)
    net = ResNet50(in_chans=3, conv_bias=conv_bias, stem_bias=stem_bias).eval()
    net.load_state_dict(resnet_state_dict_from_flax(tree), strict=True)
    assert (net.conv1.bias is not None) == stem_bias
    ref = jnet.apply(tree, jnp.asarray(x))
    with torch.no_grad():
        out = net(_t(x).movedim(-1, 1))
    for o, r in zip(out, ref):
        _close(_nhwc(o), r)
    assert REL == 1e-4
