"""The PyTorch port's PropPretrainer against the JAX package's, on the
CPU (S2M and f-BRS: tests/test_torch_pretrain_nets.py, which shares
these helpers).

Each case builds one flax tree (numpy random values, non-trivial
FrozenBatchNorm statistics), carries it into the port through
checkpoint/from_jax.py, and takes 3 steps in both packages on the same
step seeds (the port's batches equal the JAX ones bit for bit). Checks,
fp32 with TF32 off:
- the first step's loss and IoU within 1e-5 relative;
- the first step's clipped gradient (Adam's first moment over 1 - beta1,
  in both packages) within 1e-4 of its global norm;
- after 3 steps every tensor of the state_dict, FrozenBatchNorm's
  weight, bias, running_mean and running_var included, within 3 * lr of
  JAX's (the most Adam moves a tensor whose gradient is rounding
  noise), and the same set of tensors changed.
The JAX trainers' compiled steps are shared across the cases of a net
(their weights and optimizer state are reset per case), since each
compile of a ResNet-50 training step takes tens of seconds here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.models.propagation import PropagationNetwork as JProp
from mivos_tpu.train import pretrain as jpt
from mivos_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.train import pretrain
from test_torch_models import _random_tree

LR = 1e-4
PH, PW, TOP_K = 64, 64, 5          # M = 16 a memorized frame: top_k below M


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


def _reset(jtr, tree):
    """A JAX trainer restarted from `tree` with a fresh optimizer; its
    compiled steps are kept."""
    jtr.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jtr.opt_state = jtr.tx.init(jtr.params)


def _jax_grad(jtr, convert):
    """The clipped gradient of JAX's first step, by port name: Adam's
    first moment over 1 - beta1."""
    mu = jtr.opt_state[1][0].mu
    return {k: v / 0.1 for k, v in convert(jax.device_get(mu)).items()}


def _port_grad(tr):
    names = {id(t): n for n, t in list(tr.net.named_parameters())
             + list(tr.net.named_buffers())}
    state = tr.opt.adam.state
    return {names[id(t)]: state[t]["exp_avg"] / 0.1 for t in tr.opt.tensors}


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _compare_runs(jtr, tr, convert, seeds, init_sd):
    """Steps both trainers on `seeds` and holds the port to JAX. init_sd:
    (JAX's, the port's) starting state_dicts."""
    j_init, t_init = init_sd
    for i, seed in enumerate(seeds):
        jl, ji = jtr.step(seed)
        tl, ti = tr.step(seed)
        assert np.isfinite(jl) and np.isfinite(tl), (jl, tl)
        if i == 0:
            assert _rel(tl, jl) <= 1e-5, (tl, jl)
            assert _rel(ti, ji) <= 1e-5, (ti, ji)
            jg, tg = _jax_grad(jtr, convert), _port_grad(tr)
            assert set(jg) == set(tg)
            norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                               for g in (np.asarray(v) for v in jg.values())))
            err = max(float((tg[k] - v).abs().max()) for k, v in jg.items())
            assert err <= 1e-4 * norm, (err, norm)
    want = convert(jax.device_get(jtr.params))            # float32
    got = {k: v.float() for k, v in tr.state_dict().items()}
    assert set(want) == set(got)
    worst = max(float((got[k] - v).abs().max()) for k, v in want.items())
    assert worst <= 3 * LR, worst
    changed = {k for k, v in want.items() if not torch.equal(v, j_init[k])}
    changed_port = {k for k, v in got.items()
                    if not torch.equal(v, t_init[k].float())}
    assert changed == changed_port, changed ^ changed_port
    assert changed


# ---------------------------------------------------------------- prop

@pytest.fixture(scope="module")
def prop_setup():
    jnet = JProp(top_k=TOP_K, read_backend="xla_exact")
    f0 = jnp.zeros((PH, PW, 3))
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0), f0,
                              jnp.zeros((2, PH, PW, 1)), f0)
    tree = _random_tree(abstract, seed=5)
    jtr = jpt.PropPretrainer(net=jnet, params=tree, lr=LR, hw=(PH, PW),
                             chain_mix=(1, 2))
    return jtr, tree


@pytest.mark.parametrize("mix", [(1,), (2,), (1, 2)],
                         ids=["chain1", "chain2", "mix12"])
def test_prop_pretrainer_matches_jax(prop_setup, mix):
    jtr, tree = prop_setup
    _reset(jtr, tree)
    jtr.mix = mix        # picks among the compiled chain-1 and chain-2 steps
    sd = state_dict_from_flax(tree)
    tr = pretrain.PropPretrainer(
        net=PropagationNetwork(top_k=TOP_K, read_backend="exact"),
        params=sd, lr=LR, hw=(PH, PW), chain_mix=mix, device="cpu")
    seeds = (7, 8, 9)
    assert [tr.pick_chain(s) for s in seeds] == [jtr.pick_chain(s) for s in seeds]
    for got, want in zip(tr.make_batch(7, 2), jtr.make_batch(7, 2)):
        np.testing.assert_array_equal(got, np.asarray(want))
    _compare_runs(jtr, tr, state_dict_from_flax, seeds, (sd, sd))


def test_prop_pretrainer_refuses_a_kernel_read():
    with pytest.raises(AssertionError):
        pretrain.PropPretrainer(net=PropagationNetwork(read_backend="auto"),
                                hw=(32, 32), device="cpu")
