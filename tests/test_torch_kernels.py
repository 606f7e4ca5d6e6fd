"""The CUDA memory-read kernels against their plain PyTorch version.

Needs an NVIDIA Hopper GPU and nvcc: every test here is marked `cuda`
and skips on machines without a card. Run on the card with
`python -m pytest tests/test_torch_kernels.py --noconftest -q`
(`--noconftest` where jax is not installed: tests/conftest.py imports it).

Both sides run the same algorithm on the same inputs; the kernels'
affinities are bf16 passes of the split query (two on bf16 banks, three
of the split query and keys on fp32 banks) summed in fp32 on the tensor
cores, while the plain version sums cuBLAS fp32 matmuls of the same bf16
operands, so their affinities differ by ~1e-6 relative and a few
near-tie boundary entries may fall on different sides of the threshold.
Hence the gate on the MEAN error (1e-4 of the readout scale) plus the
exact-read gate of the JAX kernel check (max 0.3, mean 1e-3).
"""
import numpy as np
import pytest
import torch

from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.ops.memory_read import memory_read

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _card_and_full_fp32():
    # Decided here, not at import or collection: every pytest-xdist
    # worker must collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _peaky(rng, k, m, n):
    lat = rng.randn(32, 128).astype(np.float32)
    mk = (rng.randn(k, m, 32).astype(np.float32) ** 3) @ lat * 0.15
    q = (rng.randn(n, 32).astype(np.float32) ** 3) @ lat * 0.15
    mv = rng.randn(k, m, 512).astype(np.float32)
    return mk, mv, q


def _iid(rng, k, m, n):
    return (rng.randn(k, m, 128).astype(np.float32),
            rng.randn(k, m, 512).astype(np.float32),
            rng.randn(n, 128).astype(np.float32))


def _to_cuda(mk, mv, q, dtype):
    return (torch.from_numpy(mk).cuda().to(dtype),
            torch.from_numpy(mv).cuda().to(dtype), torch.from_numpy(q).cuda())


CASES = [
    # (inputs, K, M, N, live)  M ragged against every tile (128/256/1024)
    ("peaky", 3, 2777, 1620, 2500),
    ("peaky", 2, 1000, 37, None),
    ("iid", 1, 5013, 300, 4213),
]


@pytest.mark.parametrize("n_refine", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-M{c[2]}-N{c[3]}")
def test_kernel_matches_plain(case, dtype, n_refine):
    kind, k, m, n, live = case
    rng = np.random.RandomState(m)
    mk, mv, q = _to_cuda(*(_peaky if kind == "peaky" else _iid)(rng, k, m, n),
                         dtype)
    valid = None if live is None else torch.arange(m, device="cuda") < live
    before = cmr.launch_counts()
    out = cmr.memory_read_threshold_cuda(mk, mv, q, top_k=50, valid=valid,
                                         n_refine=n_refine)
    torch.cuda.synchronize()
    after = cmr.launch_counts()
    assert {name: after[name] - before[name] for name in after} == (
        cmr.launches_per_read(dtype, n_refine))
    ref = cmr.memory_read_threshold_plain(mk, mv, q, top_k=50, valid=valid,
                                          n_refine=n_refine)
    exact = memory_read(mk, mv, q, top_k=50, valid=valid, backend="exact")
    assert out.shape == (k, n, 512) and out.dtype == torch.float32
    assert torch.isfinite(out).all()
    scale = exact.abs().mean().item()
    assert (out - ref).abs().mean().item() <= 1e-4 * scale
    if kind == "peaky":  # the JAX gate's limits; iid ties are ungated there
        assert (out - exact).abs().mean().item() < 1e-3 * scale
        assert (out - exact).abs().max().item() < 0.3 * scale


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_full_softmax_when_topk_geq_live(dtype):
    rng = np.random.RandomState(1)
    mk, mv, q = _to_cuda(*_peaky(rng, 1, 1500, 200), dtype)
    valid = torch.arange(1500, device="cuda") < 1200
    out = cmr.memory_read_threshold_cuda(mk, mv, q, top_k=1500, valid=valid)
    plain = cmr.memory_read_threshold_plain(mk, mv, q, top_k=1500, valid=valid)
    torch.testing.assert_close(out, plain, atol=1e-4, rtol=0)
    # The full softmax, written out here in float64 on the JAX kernel's
    # split affinity (`_affinity`): bf16 halves of the scaled query times
    # the bank's keys, on fp32 banks times the keys' bf16 halves with the
    # q_lo.k_lo term dropped (~1e-5 relative, which alone moves these
    # readouts by up to 2.5e-4 against the full fp32 product).
    qs = q * (1.0 / 128 ** 0.5)
    q_hi = qs.to(torch.bfloat16).double()
    q_lo = (qs - qs.to(torch.bfloat16).float()).to(torch.bfloat16).double()
    if dtype == torch.bfloat16:
        k64 = mk.double()
        aff = q_hi @ k64.transpose(1, 2) + q_lo @ k64.transpose(1, 2)
    else:
        k_hi = mk.to(torch.bfloat16).double()
        k_lo = (mk - mk.to(torch.bfloat16).float()).to(torch.bfloat16).double()
        aff = (q_hi @ k_hi.transpose(1, 2) + q_hi @ k_lo.transpose(1, 2)
               + q_lo @ k_hi.transpose(1, 2))
    w = torch.softmax(aff.masked_fill(~valid, float("-inf")), dim=-1)
    # The weights rounded to the bank dtype after the normalization, as
    # the exact read rounds them, the threshold read before it: equal in
    # fp32, within bf16 resolution (2^-8 relative per weight) for bf16.
    full = (w.to(dtype).double() @ mv.double()).float()
    atol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, full, atol=atol, rtol=0)


SPLIT_CASES = [
    # (K, M, N, live): M below one 256-key range, at range boundaries, and
    # ragged against 64/128/256/1024; N ragged against the 32- and 64-row
    # tiles; small K x N grids take the most M ranges (up to 4 and 8).
    (1, 200, 37, None),
    (1, 1024, 37, None),
    (1, 2049, 37, 2000),
    (2, 4097, 1620, None),
    (3, 21060, 1620, 20260),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", SPLIT_CASES,
                         ids=lambda c: f"K{c[0]}-M{c[1]}-N{c[2]}")
def test_split_kernels_match_plain_and_repeat_bitwise(case, dtype):
    """The phase A, refine and phase B kernels alone against their plain
    phases on the same query split, over the M ranges the wrapper picks;
    two calls give equal bits (the merges sum in a fixed order); each call
    launches each kernel and its merge once (on fp32 banks after the
    bank's bf16 planes, made once for all three phases)."""
    k, m, n, live = case
    rng = np.random.RandomState(m)
    mk, mv, q = _to_cuda(*_peaky(rng, k, m, n), dtype)
    valid = None if live is None else torch.arange(m, device="cuda") < live
    rq = cmr.read_query(q)
    mask = cmr.additive_mask(valid)
    aff = cmr.read_affinity(rq, mk, mask)
    before = cmr.launch_counts()
    planes = None if dtype == torch.bfloat16 else cmr.bank_planes_cuda(mk, mv)
    st = cmr.candidates_cuda(rq, mk, mask, 50, planes)
    refined = cmr.refine_cuda(rq, mk, mask, st, 50, planes)
    out = cmr.readout_cuda(rq, mk, mv, mask, st, planes)
    torch.cuda.synchronize()
    after = cmr.launch_counts()
    assert {name: after[name] - before[name] for name in after} == (
        cmr.launches_per_read(dtype, 1))
    # 1e-3 nats as chip_smoke's gate, plus fp32 rounding at these inputs'
    # affinities (up to ~900 at M = 21060, where one ulp is 6e-5): the
    # tensor cores add the products in another order than cuBLAS.
    plain = cmr.candidates_plain(aff, 50)
    assert ((st - plain).abs() <= 1e-3 + 4e-6 * plain.abs()).all()
    plain = cmr.refine_plain(aff, st, 50)
    assert ((refined - plain).abs() <= 1e-3 + 4e-6 * plain.abs()).all()
    ref = cmr.readout_plain(aff, mv, st)
    scale = ref.abs().mean().item()
    assert torch.isfinite(out).all()
    assert (out - ref).abs().mean().item() <= 1e-4 * scale
    assert (out - ref).abs().max().item() < 0.3 * scale
    assert torch.equal(cmr.candidates_cuda(rq, mk, mask, 50, planes), st)
    assert torch.equal(cmr.refine_cuda(rq, mk, mask, st, 50, planes), refined)
    assert torch.equal(cmr.readout_cuda(rq, mk, mv, mask, st, planes), out)


def _bin_collisions(rng):
    """tests/test_pallas_memory_read.py:76-83: 60 strong matches for every
    query at a stride of 256 keys, all in one partition-1 bin."""
    mk = rng.randn(1, 16384, 128).astype(np.float32) * 0.02
    q = rng.randn(64, 128).astype(np.float32)
    hot = np.arange(60) * 256 + 7
    mk[0, hot] = (q.mean(0) / np.linalg.norm(q.mean(0)) * 4.0
                  + rng.randn(60, 128).astype(np.float32) * 0.05)
    return mk, rng.randn(1, 16384, 512).astype(np.float32), q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_refine_passes_tighten_on_bin_collisions(dtype):
    """The input the refine passes exist for: phase A's bins undercount,
    and each pass brings the read closer to the exact top-k read, as the
    JAX kernel's test asserts (tests/test_pallas_memory_read.py:94-100)."""
    mk, mv, q = _to_cuda(*_bin_collisions(np.random.RandomState(0)), dtype)
    exact = memory_read(mk, mv, q, top_k=50, backend="exact")
    full = memory_read(mk, mv, q, top_k=None, backend="exact")
    errs = [(cmr.memory_read_threshold_cuda(mk, mv, q, top_k=50, n_refine=nr)
             - exact).abs().mean().item() for nr in (0, 1, 2)]
    assert errs[0] < 0.8 * (full - exact).abs().mean().item(), errs
    assert errs[1] < 0.75 * errs[0], errs
    assert errs[2] < errs[1], errs


def test_strided_bank_prefix_view():
    """A bank's live prefix (object axis striding over the full buffer)
    reads like the same rows copied out contiguously."""
    rng = np.random.RandomState(2)
    mk, mv, q = _to_cuda(*_peaky(rng, 3, 3000, 1620), torch.bfloat16)
    view_k, view_v = mk[:, :2100], mv[:, :2100]
    assert not view_k.is_contiguous()
    a = cmr.memory_read_threshold_cuda(view_k, view_v, q, top_k=50)
    b = cmr.memory_read_threshold_cuda(view_k.contiguous(),
                                       view_v.contiguous(), q, top_k=50)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_hilo_planes_match_plain_bitwise():
    """The bf16 planes of an fp32 bank's live prefix (the object axis
    striding over a longer buffer) equal hilo_planes_plain bit for bit,
    contiguous."""
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 1500, 512).astype(np.float32) * 3).cuda()
    view = x[:, :1100]
    hi, lo = cmr.hilo_planes_cuda(view)
    ref_hi, ref_lo = cmr.hilo_planes_plain(view)
    assert hi.is_contiguous() and lo.is_contiguous()
    assert torch.equal(hi, ref_hi) and torch.equal(lo, ref_lo)


def test_bad_inputs_raise():
    mk = torch.zeros(2, 100, 128, device="cuda")
    mv = torch.zeros(2, 100, 512, device="cuda")
    q = torch.zeros(30, 128, device="cuda")
    with pytest.raises(ValueError):
        cmr.memory_read_threshold_cuda(mk.half(), mv.half(), q)
    with pytest.raises(ValueError):
        cmr.memory_read_threshold_cuda(mk, mv[:, :, :256], q)
    with pytest.raises(ValueError):
        cmr.memory_read_threshold_cuda(mk.transpose(0, 1).contiguous()
                                       .transpose(0, 1)[:, :, :128], mv, q)
    # fp32 banks: each phase needs the bank's bf16 planes, and launches
    # nothing without them.
    rq, stats = cmr.read_query(q), torch.zeros(2, 3, 30, device="cuda")
    before = cmr.launch_counts()
    with pytest.raises(ValueError):
        cmr.candidates_cuda(rq, mk, None, 50)
    with pytest.raises(ValueError):
        cmr.refine_cuda(rq, mk, None, stats, 50)
    with pytest.raises(ValueError):
        cmr.readout_cuda(rq, mk, mv, None, stats)
    assert cmr.launch_counts() == before
