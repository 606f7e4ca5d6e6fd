"""The PyTorch port's gluon init flavour (models/initializer.py) against
the JAX one, by distribution: the draws come from a torch.Generator and
jax.random, so they cannot be equal bit for bit. Held: every kernel
within its XavierGluon bound, each large kernel's deviation within 5% of
the JAX draw's, the zero and one leaves exact; deterministic per seed and
distinct per layer; running statistics left alone.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import convert_fbrs, convert_fbrs_hrnet
from mivos_tpu.models.fbrs import FBRSDeepLabModel as JFBRS
from mivos_tpu.models.hrnet import FBRSHRNetModel as JHRNet
from mivos_tpu.models.initializer import apply_initializer as j_apply_initializer
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.hrnet import FBRSHRNetModel
from mivos_tpu_torch.models.initializer import apply_initializer, init_params


def _jax_gluon(jnet, hw):
    """The JAX gluon flavour of jnet's parameters: its own rule,
    `apply_initializer`, on flax's default tree, as `init_model_params`
    applies it after `init` (mivos_tpu/models/initializer.py:100-117).
    The tree comes from the parameter shapes (only the BN statistics of
    `init` survive the rule: mean 0, var 1), which spares the flax init's
    op-by-op pass over the network."""
    key = jax.random.PRNGKey(0)
    abstract = jax.eval_shape(jnet.init, key, jnp.zeros((1, *hw, 3)),
                              jnp.zeros((1, 2, 2)))

    def default(path, leaf):
        fill = jnp.ones if path[-1].key == "var" else jnp.zeros
        return fill(leaf.shape, leaf.dtype)

    tree = jax.tree_util.tree_map_with_path(default, abstract)
    return j_apply_initializer(tree, jax.random.fold_in(key, 0x9107))


def _kernel_leaves(params):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        out["/".join(str(p.key) for p in path if hasattr(p, "key"))] = np.asarray(leaf)
    return out


def _gluon_scale(w):
    rf = w.shape[0] * w.shape[1] if w.ndim == 4 else 1
    fan_in, fan_out = w.shape[-2] * rf, w.shape[-1] * rf
    return math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))


@pytest.mark.parametrize("family", ["deeplab", "hrnet"])
def test_gluon_flavor_matches_jax_by_distribution(family):
    """The port's gluon flavour (torch.Generator) against the JAX one
    (jax.random) on the same architecture, leaf by leaf in the flax tree:
    every kernel within its XavierGluon bound s = sqrt(3 / ((fan_in +
    fan_out) / 2)); where a kernel has 2000 or more entries, its standard
    deviation within 5% of the JAX kernel's and its mean within 0.05 s of
    0; every bias and BN beta 0, every BN gamma 1, the running statistics
    the default's (0 and 1) in both."""
    if family == "deeplab":
        jnet, net = JFBRS(arch="resnet34", ch=128), FBRSDeepLabModel("resnet34", ch=128)
        convert, hw = convert_fbrs, (32, 32)
    else:
        jnet, net = JHRNet(width=18, ocr_width=64, small=True), FBRSHRNetModel(18, 64, True)
        convert, hw = convert_fbrs_hrnet, (64, 64)
    jparams = _jax_gluon(jnet, hw)
    init_params(net, torch.Generator().manual_seed(0), "gluon")
    ours = _kernel_leaves(convert({k: v.numpy() for k, v in net.state_dict().items()})["params"])
    ref = _kernel_leaves(jparams["params"])
    assert ours.keys() == ref.keys()
    checked = 0
    for name, w in ours.items():
        jw, leaf = ref[name], name.rsplit("/", 1)[-1]
        assert w.shape == jw.shape, name
        if leaf == "kernel":
            s = _gluon_scale(w)
            assert np.abs(w).max() <= s * (1 + 1e-6), name
            assert np.abs(jw).max() <= s * (1 + 1e-6), name
            if w.size >= 2000:
                assert abs(w.std() - jw.std()) < 0.05 * jw.std(), (name, w.std(), jw.std())
                assert abs(w.mean()) < 0.05 * s, name
                checked += 1
        else:
            want = {"bias": 0.0, "scale": 1.0, "mean": 0.0, "var": 1.0}[leaf]
            assert (w == want).all() and (jw == want).all(), name
    assert checked >= 10


def test_gluon_flavor_is_deterministic_and_distinct_per_layer():
    """The same generator seed draws the same weights; kernels of the same
    shape in different layers draw different values; the running
    statistics are left as they were."""
    nets = [FBRSHRNetModel(18, 64, True) for _ in range(2)]
    for net in nets:
        init_params(net, torch.Generator().manual_seed(3), "gluon")
    a, b = (n.state_dict() for n in nets)
    assert all(torch.equal(a[k], b[k]) for k in a)
    seen = {}
    for k, v in a.items():
        if k.endswith("weight") and v.ndim == 4:
            if v.shape in seen:
                assert not torch.equal(v, seen[v.shape]), k
            seen[v.shape] = v
    net = nets[0]
    bn = net.feature_extractor.bn1
    bn.running_mean.fill_(0.3)
    apply_initializer(net, torch.Generator().manual_seed(4))
    assert torch.all(bn.running_mean == 0.3) and torch.all(bn.weight == 1)
    with pytest.raises(ValueError):
        init_params(net, torch.Generator(), "lecun")
