"""The memory-read kernels at a long video's bank: K = 2, N = 1620 and
M = 779220, the largest read of `long_video_bench --limit` (960 frames
of 480x854, commits thinned to 481 slots of 1620 rows).

Needs an NVIDIA Hopper GPU and nvcc: marked `cuda`, skipped without a
card. Run on the card with
`python -m pytest tests/test_torch_long_video_card.py --noconftest -q`.
The bank holds the peaked keys of tests/test_torch_kernels.py. The
kernels read both objects at once; the plain version and the exact read
are computed one object at a time (a dense fp32 affinity of one object
is 5 GB here). The bounds are the kernel gate's: against plain, mean
error <= 1e-4 of the readout scale; against the exact read, mean < 1e-3
and max < 0.3 of it.
"""
import numpy as np
import pytest
import torch
from test_torch_kernels import _peaky

from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.ops.memory_read import memory_read

pytestmark = pytest.mark.cuda
K, N, M = 2, 1620, 779220


@pytest.fixture(scope="module", autouse=True)
def _card_and_full_fp32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_kernel_read_at_the_long_video_bank(dtype):
    mk, mv, q = _peaky(np.random.RandomState(5), K, M, N)
    mk, mv = (torch.from_numpy(x).cuda().to(dtype) for x in (mk, mv))
    q = torch.from_numpy(q).cuda()
    before = cmr.launch_counts()
    out = cmr.memory_read_threshold_cuda(mk, mv, q, top_k=50)
    torch.cuda.synchronize()
    after = cmr.launch_counts()
    assert {n: after[n] - before[n] for n in after} == cmr.launches_per_read(dtype, 0)
    assert out.shape == (K, N, 512) and torch.isfinite(out).all()
    for j in range(K):
        plain = cmr.memory_read_threshold_plain(mk[j:j + 1], mv[j:j + 1], q, top_k=50)
        exact = memory_read(mk[j:j + 1], mv[j:j + 1], q, top_k=50, backend="exact")
        scale = exact.abs().mean().item()
        assert (out[j] - plain[0]).abs().mean().item() <= 1e-4 * scale
        assert (out[j] - exact[0]).abs().mean().item() < 1e-3 * scale
        assert (out[j] - exact[0]).abs().max().item() < 0.3 * scale
        del plain, exact
