"""The PyTorch port's InferenceCore against the JAX InferenceCore.

A two-round session on the fixture of tests/test_inference_core.py
(T=8, 45x62 raw frames padded to 48x64, K=2, top_k=10, mem_freq=2):
round 1 interacts on frame 3 and propagates both ways, round 2 on frame
7 propagates back into round 1's frames and runs the fusion pass. The
JAX side reads with the exact top-k oracle ('xla_exact'), the port with
its torch.topk counterpart ('exact'); both get the same weights (the
port's random init, carried to flax by mivos_tpu's own .pth converter)
and the same numpy inputs. All in fp32 on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import convert_fusion_net, convert_prop_net
from mivos_tpu.config import MemoryConfig as JMemoryConfig
from mivos_tpu.core.inference import InferenceCore as JInferenceCore
from mivos_tpu.models.fusion import FusionNet as JFusionNet
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork

T, RH, RW, K = 8, 45, 62, 2
TOP_K, MEM_FREQ = 10, 2
ROUNDS = (3, 7)
PROB_ATOL = 1e-4      # fp32 conv/matmul summation order, two rounds deep
MARGIN = 1e-3         # labels must agree where JAX decides by more than this


def _mask(rng):
    labels = rng.randint(0, K + 1, (RH, RW))
    fg = (labels[None] == np.arange(1, K + 1)[:, None, None])
    fg = fg.astype(np.float32)[..., None]
    return np.concatenate([1.0 - fg.sum(0, keepdims=True), fg], 0)


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def sessions():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    prop = init_params(PropagationNetwork(top_k=TOP_K, read_backend="exact"),
                       gen)
    fuse = init_params(FusionNet(), gen)
    rng = np.random.RandomState(0)
    images = rng.rand(T, RH, RW, 3).astype(np.float32)
    masks = [_mask(rng) for _ in ROUNDS]

    jcore = JInferenceCore(
        JPropagation(top_k=TOP_K, read_backend="xla_exact"),
        convert_prop_net(_numpy_sd(prop)), JFusionNet(),
        convert_fusion_net(_numpy_sd(fuse)), images, K,
        mem=JMemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ))
    core = InferenceCore(prop, fuse, images, K,
                         mem=MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ))
    out = []
    for idx, mask in zip(ROUNDS, masks):
        jlab = jcore.interact(jnp.asarray(mask), idx)
        jprob = np.stack([np.asarray(jcore.get_prob(t))[..., 0]
                          for t in range(T)])
        lab = core.interact(mask, idx).copy()
        prob = np.stack([core.get_prob(t)[:, 0].numpy() for t in range(T)])
        out.append((np.array(jlab), jprob, lab, prob))
    return core, out


@pytest.mark.parametrize("round_i", [0, 1])
def test_probabilities_match_jax(sessions, round_i):
    _, out = sessions
    _, jprob, _, prob = out[round_i]
    assert prob.shape == jprob.shape == (T, K + 1, 48, 64)
    np.testing.assert_allclose(prob, jprob, atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("round_i", [0, 1])
def test_labels_match_jax_where_decided(sessions, round_i):
    core, out = sessions
    jlab, jprob, lab, _ = out[round_i]
    assert lab.shape == (T, RH, RW) and lab.dtype == np.uint8
    top2 = np.sort(jprob, axis=1)[:, -2:]
    lw, uw, lh, uh = core.pad
    margin = (top2[:, 1] - top2[:, 0])[:, lh:48 - uh, lw:64 - uw]
    decided = margin > MARGIN
    assert decided.mean() > 0.5, decided.mean()
    np.testing.assert_array_equal(lab[decided], jlab[decided])


def test_session_invariants(sessions):
    core, out = sessions
    _, _, lab, prob = out[-1]
    assert np.isfinite(prob).all()
    lw, uw, lh, uh = core.pad
    # Interacted frames hold the padded user mask: zero in the pad band.
    np.testing.assert_allclose(prob[:, :, lh:48 - uh, lw:64 - uw].sum(1), 1.0,
                               atol=1e-5)
    assert lab.max() <= K
    assert core.interacted == set(ROUNDS)
    assert core.bank.num_slots >= 1


def test_update_mask_only_touches_one_frame():
    gen = torch.Generator().manual_seed(1)
    prop = init_params(PropagationNetwork(top_k=TOP_K), gen)
    rng = np.random.RandomState(3)
    images = rng.rand(T, RH, RW, 3).astype(np.float32)
    core = InferenceCore(prop, None, images, K,
                         mem=MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ))
    mask = _mask(rng)
    out = core.update_mask_only(mask, 5)
    assert core.prob[5] is not None
    assert all(core.prob[t] is None for t in range(T) if t != 5)
    np.testing.assert_array_equal(out[5], mask[..., 0].argmax(0))
    assert out[4].max() == 0
