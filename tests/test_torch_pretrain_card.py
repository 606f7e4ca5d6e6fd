"""Synthetic pretraining on the card against the CPU.

Needs an NVIDIA GPU: marked `cuda`, skipped without a card. Run on the
card with
`python -m pytest tests/test_torch_pretrain_card.py --noconftest -q`.

The same random-init weights in a PropPretrainer on the card and on the
CPU, 48x48, 3 steps of chain_mix (1, 2) with TF32 off: losses within
1e-4 relative (fp32 convolutions in cuDNN's order against the CPU's),
every trained tensor within 3 * lr (the most Adam moves a tensor whose
gradient is rounding noise); the FrozenBatchNorm tensors moved on both.
"""
import pytest
import torch

from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.train.pretrain import PropPretrainer

pytestmark = pytest.mark.cuda

LR = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _card_and_full_fp32():
    # Decided here, not at import or collection: every pytest-xdist
    # worker must collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = deterministic


def test_prop_pretrainer_card_matches_cpu():
    net = init_params(PropagationNetwork(top_k=50, read_backend="exact"),
                      torch.Generator().manual_seed(4))
    sd = {k: v.clone() for k, v in net.state_dict().items()}
    trainers = {d: PropPretrainer(params=sd, hw=(48, 48), lr=LR,
                                  chain_mix=(1, 2), device=d)
                for d in ("cuda", "cpu")}
    for seed in range(3):
        card, cpu = (trainers[d].step(seed) for d in ("cuda", "cpu"))
        assert abs(card[0] - cpu[0]) <= 1e-4 * abs(cpu[0]), (seed, card, cpu)
    cpu_sd = trainers["cpu"].state_dict()
    for k, v in trainers["cuda"].state_dict().items():
        assert float((v.cpu() - cpu_sd[k]).abs().max()) <= 3 * LR, k
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(cpu_sd[k], sd[k]), k
