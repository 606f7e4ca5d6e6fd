"""The fusion-training path on the card against the CPU.

Needs an NVIDIA GPU and nvcc: marked `cuda`, skipped without a card.
Run on the card with
`python -m pytest tests/test_torch_train_card.py --noconftest -q`.

(a) One FusionTrainer.train_step at batch 2, 64x64, on the card and on
the CPU from the same weights and batch. (b) FusionGenerator's reads
launch the memory-read kernels: the launch counters rise by its reads
times `launches_per_read`.
"""
import numpy as np
import pytest
import torch

from mivos_tpu_torch.config import TrainConfig
from mivos_tpu_torch.core.fusion_generator import FusionGenerator
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.train.trainer import FusionTrainer

pytestmark = pytest.mark.cuda

# Loss: fp32 convolutions in cuDNN's order against the CPU's. Weights
# after one Adam step, whose elements are ~lr = 1e-4 in size: 1% of it.
LOSS_RTOL, WEIGHT_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _card_and_full_fp32():
    # Decided here, not at import or collection: every pytest-xdist
    # worker must collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _batch(b=2, h=64, w=64):
    rng = np.random.RandomState(0)
    m = lambda: rng.rand(b, h, w, 1).astype(np.float32)  # noqa: E731
    batch = {"rgb": rng.randn(b, h, w, 3).astype(np.float32),
             "src2_ref_im": rng.randn(b, h, w, 3).astype(np.float32),
             "cls_gt": rng.randint(0, 3, (b, h, w)).astype(np.int32),
             "dist": rng.rand(b, 2).astype(np.float32),
             "selector": np.ones((b, 2), np.float32)}
    for k in ("seg1", "seg2", "src2_ref", "seg12", "seg22", "src2_ref2"):
        batch[k] = m()
    for k in ("gt", "gt2", "src2_ref_gt", "src2_ref_gt2"):
        batch[k] = (m() > 0.5).astype(np.float32)
    return batch


def test_train_step_card_matches_cpu():
    cfg = TrainConfig(iterations=10, steps=(5,), batch_size=2)
    cpu = FusionTrainer(cfg, device="cpu")
    card = FusionTrainer(cfg, {k: v for k, v in cpu.attn_net.state_dict().items()},
                         device="cuda")
    card.fuse_net.load_state_dict(cpu.fuse_net.state_dict())
    batch = _batch()
    ref, got = cpu.train_step(batch), card.train_step(batch)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    for k, v in cpu.fuse_net.state_dict().items():
        np.testing.assert_allclose(card.fuse_net.state_dict()[k].cpu().numpy(),
                                   v.numpy(), atol=WEIGHT_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fusion_generator_launches_the_read_kernels(dtype):
    t, h, w, k = 8, 96, 128, 2
    net = init_params(PropagationNetwork(dtype=dtype),
                      torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    images = rng.randn(t, h, w, 3).astype(np.float32)
    mask = np.zeros((k, h, w, 1), np.float32)
    mask[0, 10:50, 10:60] = 1.0
    mask[1, 50:90, 70:120] = 1.0
    gen = FusionGenerator(net, images, mem_freq=2, device="cuda")
    gen.reset(k)
    cmr.reset_launch_counts()
    probs = gen.interact_mask(mask, 3, 0, t - 1)
    reads = t - 1
    assert cmr.launch_counts() == {
        name: n * reads for name, n in cmr.launches_per_read(dtype, 0).items()}
    assert probs.shape == (k + 1, t, h, w) and np.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(0), 1.0, atol=1e-5)
