"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side of the fused memory read runs `memory_read_pallas(interpret=True)`,
as tests/test_pallas_memory_read.py does; the port's side is the CUDA
kernels' plain PyTorch version, which is what a CPU tensor reaches.
"""
import inspect
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.ops import aggregate as jagg
from mivos_tpu.ops.memory_read import affinity_matrix as j_affinity
from mivos_tpu.ops.memory_read import full_softmax_affinity as j_full_softmax
from mivos_tpu.ops.memory_read import memory_read as j_memory_read
from mivos_tpu.ops import resize as jrs
from mivos_tpu.ops.pallas.memory_read import _affinity as j_split_affinity
from mivos_tpu.ops.pallas.memory_read import memory_read_pallas
from mivos_tpu.utils import tensor as jtu
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.davis_processor import DAVISProcessor
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.core.memory_bank import MemoryBank
from mivos_tpu_torch.eval import davis_interactive, davis_metrics
from mivos_tpu_torch.eval.robot import LocalInteractiveSession
from mivos_tpu_torch import click_to_mask
from mivos_tpu_torch.interactive import fbrs_controller, fbrs_predictor
from mivos_tpu_torch.interactive.s2m_controller import S2MController
from mivos_tpu_torch.ops import aggregate, memory_read as mr, resize
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.utils import tensor as tu

REPO = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.movedim(-3, -1).numpy()


# ---------------------------------------------------------------- (a)

def test_port_imports_no_jax_and_no_mivos_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import mivos_tpu_torch\n"
        "for m in pkgutil.walk_packages(mivos_tpu_torch.__path__, "
        "'mivos_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'mivos_tpu', 'cv2', 'PIL'))\n"
        "print(len([m for m in sys.modules if m.startswith('mivos_tpu_torch')]))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 100  # every module was imported


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("out_hw", [(10, 14), (32, 48)])
def test_bilinear_resize_matches_jax(out_hw):
    x = np.random.RandomState(0).randn(2, 5, 7, 3).astype(np.float32)
    ref = np.asarray(jrs.bilinear_resize(jnp.asarray(x), out_hw))
    out = resize.bilinear_resize(_t(x).movedim(-1, 1), out_hw)
    np.testing.assert_allclose(_nhwc(out), ref, atol=1e-6, rtol=0)


def test_upsample2x_and_area_downsample_match_jax():
    x = np.random.RandomState(1).randn(3, 32, 48, 2).astype(np.float32)
    xt = _t(x).movedim(-1, 1)
    np.testing.assert_allclose(_nhwc(resize.upsample2x(xt)),
                               np.asarray(jrs.upsample2x(jnp.asarray(x))),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(_nhwc(resize.area_downsample(xt, 16)),
                               np.asarray(jrs.area_downsample(jnp.asarray(x), 16)),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        resize.area_downsample(xt, 5)


@pytest.mark.parametrize("keep_bg,hard", [(True, False), (False, False),
                                          (True, True)])
def test_aggregate_wbg_matches_jax(keep_bg, hard):
    p = np.random.RandomState(2).rand(3, 9, 11, 1).astype(np.float32)
    p[0, 0, 0] = 0.0   # exercises the 1e-7 clamp
    p[1, 0, 1] = 1.0
    ref = np.asarray(jagg.aggregate_wbg(jnp.asarray(p), keep_bg, hard))
    out = aggregate.aggregate_wbg(_t(p), keep_bg, hard).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("h,w", [(45, 62), (48, 64), (480, 854), (1, 17)])
def test_pad_divide_by_and_unpad_match_jax(h, w):
    assert tu.compute_pad(h, w) == jtu.compute_pad(h, w)
    x = np.random.RandomState(3).randn(2, h, w, 3).astype(np.float32)
    jp, jpad = jtu.pad_divide_by(jnp.asarray(x), 16)
    tp, tpad = tu.pad_divide_by(_t(x), 16)
    assert tpad == jpad
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tu.unpad(tp, tpad).numpy(), x)
    # NCHW axes through the same functions.
    cp, cpad = tu.pad_divide_by(_t(x).movedim(-1, 1), 16, hw_axes=(-2, -1))
    assert cpad == jpad
    np.testing.assert_array_equal(_nhwc(cp), np.asarray(jp))
    np.testing.assert_array_equal(
        _nhwc(tu.unpad(cp, cpad, hw_axes=(-2, -1))), x)


def test_one_hot_mask_matches_jax():
    lab = np.random.RandomState(4).randint(0, 4, (13, 17))
    np.testing.assert_array_equal(
        tu.one_hot_mask(_t(lab), 3).numpy(),
        np.asarray(jtu.one_hot_mask(jnp.asarray(lab), 3)))


# ---------------------------------------------------------------- (c)

def _iid(seed, k, m, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, m, 128).astype(np.float32),
            rng.randn(k, m, 512).astype(np.float32),
            rng.randn(n, 128).astype(np.float32))


@pytest.mark.parametrize("top_k,live", [(50, 500), (50, None), (None, 450),
                                        (700, 500)])
def test_exact_read_matches_xla_exact(top_k, live):
    mk, mv, q = _iid(5, 2, 600, 100)
    valid = None if live is None else np.arange(600) < live
    ref = np.asarray(j_memory_read(
        jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(q), top_k=top_k,
        valid=None if valid is None else jnp.asarray(valid),
        backend="xla_exact"))
    out = mr.memory_read(_t(mk), _t(mv), _t(q), top_k=top_k,
                         valid=None if valid is None else _t(valid),
                         backend="exact")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


def test_affinity_and_full_softmax_match_jax():
    mk, _, q = _iid(6, 2, 300, 80)
    np.testing.assert_allclose(
        mr.affinity_matrix(_t(mk), _t(q)).numpy(),
        np.asarray(j_affinity(jnp.asarray(mk), jnp.asarray(q))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        mr.full_softmax_affinity(_t(mk), _t(q)).numpy(),
        np.asarray(j_full_softmax(jnp.asarray(mk), jnp.asarray(q))),
        atol=1e-6, rtol=0)


# ---------------------------------------------------------------- (d)

def _peaky(seed, k, m, n):
    """tests/test_pallas_memory_read.py:16-24: clustered affinity spectra
    like trained STM keys."""
    rng = np.random.RandomState(seed)
    lat = rng.randn(32, 128).astype(np.float32)
    mk = (rng.randn(k, m, 32).astype(np.float32) ** 3) @ lat * 0.15
    q = (rng.randn(n, 32).astype(np.float32) ** 3) @ lat * 0.15
    mv = rng.randn(k, m, 512).astype(np.float32)
    return mk, mv, q


@pytest.mark.parametrize("top_k,n_refine,bf16", [
    (50, 0, False), (50, 1, False), (50, 0, True), (50, 1, True),
    (2000, 0, False),   # top_k >= live: full softmax over the live slots
])
def test_threshold_plain_matches_pallas_interpret(top_k, n_refine, bf16):
    mk, mv, q = _peaky(0, k=2, m=2500, n=300)
    valid = np.arange(2500) < 1900
    jk, jv = jnp.asarray(mk), jnp.asarray(mv)
    tk, tv = _t(mk), _t(mv)
    if bf16:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    ref = np.asarray(memory_read_pallas(jk, jv, jnp.asarray(q), top_k=top_k,
                                        valid=jnp.asarray(valid),
                                        interpret=True, n_refine=n_refine))
    out = cmr.memory_read_threshold_plain(tk, tv, _t(q), top_k=top_k,
                                          valid=_t(valid),
                                          n_refine=n_refine).numpy()
    err = np.abs(out - ref)
    assert err.max() <= 2e-3, err.max()
    assert err.mean() <= 1e-4, err.mean()


def test_threshold_plain_stats_match_phase_by_phase():
    """Phase A and refine of the plain version land where the Pallas
    kernel's docstring says: t lower-bounds the k-th affinity (or sits
    at rowmax - 30 where the k-th is further down, weights below e^-30
    being invisible in fp32), and the refine pass never lowers it."""
    mk, _, q = _peaky(1, k=2, m=3000, n=64)
    aff = cmr.masked_affinity(cmr.scaled_query(_t(q)), _t(mk), None)
    stats = cmr.candidates_plain(aff, 50)
    rowmax = aff.amax(-1)
    bound = torch.maximum(torch.topk(aff, 50, dim=-1).values[..., -1],
                          rowmax - 30.0)
    assert stats.shape == (2, 3, 64)
    assert (stats[:, 0] <= bound).all()
    assert torch.equal(stats[:, 1], rowmax)
    refined = cmr.refine_plain(aff, stats, 50)
    assert (refined[:, 0] >= stats[:, 0]).all()
    assert (refined[:, 0] <= bound).all()
    assert (refined[:, 2] <= stats[:, 2]).all()


def test_bf16_split_affinity_matches_pallas_affinity():
    """bf16 banks: the read's affinity (q_hi.k + q_lo.k) against the JAX
    kernel's two-pass split on the same inputs, to 1e-5 of the largest
    affinity (fp32 sums of 128 products in another order)."""
    mk, _, q = _peaky(7, k=2, m=600, n=90)
    qs = cmr.scaled_query(_t(q))
    kb = jnp.asarray(mk).astype(jnp.bfloat16)
    ref = np.stack([np.asarray(j_split_affinity(jnp.asarray(qs.numpy()), kb[i]))
                    for i in range(2)])
    rq = cmr.read_query(_t(q))
    assert rq.hi.dtype == rq.lo.dtype == torch.bfloat16
    assert rq.rows == 90
    out = cmr.read_affinity(rq, _t(mk).to(torch.bfloat16), None).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    # q_hi + q_lo is the query to ~2^-17 relative; q_hi is q rounded to bf16.
    assert torch.allclose(rq.hi.float() + rq.lo.float(), qs, rtol=2 ** -16, atol=0)
    assert rq.hi.equal(qs.to(torch.bfloat16))


def test_fp32_split_affinity_matches_pallas_affinity():
    """fp32 banks: the read's affinity (q_hi.k_hi + q_hi.k_lo + q_lo.k_hi)
    against the JAX kernel's three-pass split on the same inputs, to 1e-5
    of the largest affinity (fp32 sums of 3 x 128 exact products in
    another order); and the split against the full fp32 product, to the
    ~1e-5 relative of the dropped q_lo.k_lo term and the operand splits."""
    mk, _, q = _peaky(8, k=2, m=600, n=90)
    qs = cmr.scaled_query(_t(q))
    ref = np.stack([np.asarray(j_split_affinity(jnp.asarray(qs.numpy()),
                                                jnp.asarray(mk[i])))
                    for i in range(2)])
    out = cmr.read_affinity(cmr.read_query(_t(q)), _t(mk), None).numpy()
    assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max()
    full = cmr.masked_affinity(qs, _t(mk), None).numpy()
    assert np.abs(out - full).max() <= 1e-4 * np.abs(full).max()
    k_hi, k_lo = cmr.hilo_planes_plain(_t(mk))
    assert k_hi.dtype == k_lo.dtype == torch.bfloat16
    assert torch.allclose(k_hi.float() + k_lo.float(), _t(mk), rtol=2 ** -16, atol=0)


def _split_cuts(m, splits, align):
    """M ranges cut at multiples of `align` as csrc/memory_read.cu's
    split_range cuts them (align = 256 there)."""
    nsl = -(-m // align)
    return [(s * nsl // splits * align, min((s + 1) * nsl // splits * align, m))
            for s in range(splits)]


def _pallas_split_affinity(q, mk, valid=None, bank=jnp.bfloat16):
    """(K, N, M) affinity of the JAX kernel's split (`_affinity`) for a
    bank of dtype `bank` (default bf16) on the port's scaled query, plus
    the additive mask of `valid`."""
    qs = jnp.asarray(cmr.scaled_query(_t(q)).numpy())
    kb = jnp.asarray(mk).astype(bank)
    aff = np.stack([np.asarray(j_split_affinity(qs, kb[i]))
                    for i in range(mk.shape[0])])
    if valid is not None:
        aff = aff + np.where(valid, 0.0, cmr.NEG_INF).astype(np.float32)
    return aff


@pytest.mark.parametrize("m,splits", [(2500, 3), (2049, 8), (1024, 4),
                                      (300, 2)])
def test_split_m_readout_sums_to_unsplit(m, splits):
    """Phase B over 256-aligned M ranges: partial (w.V, sum w) with the
    rowmax of phase A add up to the unsplit readout, here the definition
    in float64 (bf16-rounded weights times bf16 values over the sum of
    the fp32 weights), on the JAX kernel's affinity."""
    mk, mv, q = _peaky(9, k=2, m=m, n=70)
    aff = _t(_pallas_split_affinity(q, mk, np.arange(m) < m - 40))
    tv = _t(mv).to(torch.bfloat16)
    stats = cmr.candidates_plain(aff, 50)
    th, mx = stats[:, 0, :, None], stats[:, 1, :, None]
    acc = torch.zeros(2, 70, 512)
    wsum = torch.zeros(2, 70, 1)
    cuts = _split_cuts(m, splits, 256)
    assert all(j0 < j1 for j0, j1 in cuts) and cuts[-1][1] == m
    for j0, j1 in cuts:
        a = aff[..., j0:j1]
        w = torch.where(a >= th, torch.exp(a - mx), torch.zeros(()))
        acc += w.to(torch.bfloat16).float() @ tv[:, j0:j1].float()
        wsum += w.sum(-1, keepdim=True)
    w = torch.where(aff >= th, torch.exp(aff - mx), torch.zeros(()))
    ref = ((w.to(torch.bfloat16).double() @ tv.double())
           / w.double().sum(-1, keepdim=True))
    assert ((acc / wsum - ref).abs().max() / ref.abs().max()).item() <= 1e-6


@pytest.mark.parametrize("m,splits", [(2500, 3), (2049, 8), (1024, 4),
                                      (300, 2)])
def test_split_m_f32_readout_matches_unsplit_fp32_product(m, splits):
    """fp32 banks: phase B as its kernel computes it -- per 256-aligned M
    range the three bf16 passes w_hi.v_hi + w_lo.v_hi + w_hi.v_lo and
    sum(w) of the unrounded fp32 w, the ranges added in order, then one
    division -- against readout_plain, the unsplit fp32 product, on the
    read's three-pass affinity: to 1e-5 of the readout's largest entry
    (the dropped w_lo.v_lo term and the splits are ~2^-17 relative)."""
    mk, mv, q = _peaky(13, k=2, m=m, n=70)
    mask = cmr.additive_mask(_t(np.arange(m) < m - 40))
    aff = cmr.read_affinity(cmr.read_query(_t(q)), _t(mk), mask)
    stats = cmr.candidates_plain(aff, 50)
    th, mx = stats[:, 0, :, None], stats[:, 1, :, None]
    v_hi, v_lo = (p.float() for p in cmr.hilo_planes_plain(_t(mv)))
    acc = torch.zeros(2, 70, 512)
    wsum = torch.zeros(2, 70, 1)
    cuts = _split_cuts(m, splits, 256)
    assert all(j0 < j1 for j0, j1 in cuts) and cuts[-1][1] == m
    for j0, j1 in cuts:
        a = aff[..., j0:j1]
        w = torch.where(a >= th, torch.exp(a - mx), torch.zeros(()))
        w_hi, w_lo = (p.float() for p in cmr.hilo_planes_plain(w))
        acc += (w_hi @ v_hi[:, j0:j1] + w_lo @ v_hi[:, j0:j1]
                + w_hi @ v_lo[:, j0:j1])
        wsum += w.sum(-1, keepdim=True)
    ref = cmr.readout_plain(aff, _t(mv), stats)
    assert ((acc / wsum - ref).abs().max() / ref.abs().max()).item() <= 1e-5


def _top2_by_definition(aff):
    """Per bin, the two largest affinities over the whole memory axis,
    (K, N, 2, 256) for each partition, from the bin maps of the JAX
    kernel (`_candidates_kernel`): P1 bin(j) = j mod 256, P2 bin(j) =
    (j mod 256 + 85 s) mod 256 with s = (j mod 1024) div 256."""
    k, n, m = aff.shape
    j = np.arange(m)
    pairs = []
    for bins in (j % 256, (j % 256 + 85 * ((j % 1024) // 256)) % 256):
        pair = np.full((k, n, 2, 256), cmr.NEG_INF, np.float32)
        for b in range(256):
            top = -np.sort(-aff[..., bins == b], axis=-1)[..., :2]
            pair[:, :, :top.shape[-1], b] = top
        pairs.append(torch.from_numpy(pair))
    return pairs


@pytest.mark.parametrize("m", [2500, 4096, 2100])
def test_split_m_top2_bins_merge_exactly(m):
    """Phase A over 1024-aligned M ranges: per bin, the top-2 of the union
    of the ranges' top-2 pairs is the top-2 of the whole, bit for bit."""
    mk, _, q = _peaky(10, k=2, m=m, n=40)
    aff = _pallas_split_affinity(q, mk)
    whole = _top2_by_definition(aff)
    aff = _t(aff)
    merged = None
    for j0, j1 in _split_cuts(m, 3, 1024):
        part = cmr._top2_bins(aff[..., j0:j1])
        if merged is None:
            merged = part
            continue
        merged = tuple(
            torch.stack([torch.maximum(a[:, :, 0], b[:, :, 0]),
                         torch.maximum(torch.minimum(a[:, :, 0], b[:, :, 0]),
                                       torch.maximum(a[:, :, 1], b[:, :, 1]))],
                        dim=2)
            for a, b in zip(merged, part))
    for got, ref in zip(merged, whole):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("m,live,top_k", [
    (2500, 1700, 50),    # M ragged against 256; at S = 4 the last range
                         # [1792, 2500) is wholly masked
    (2049, None, 50),    # one key in the last 256-key slice
    (1500, 1000, 1200),  # top_k >= the live count
])
def test_refine_counts_over_split_ranges_sum_to_refine_plain(m, live, top_k, splits):
    """Refine over the 256-aligned M ranges of csrc's split_range, as the
    refine kernels and their merge split it: the ranges' counts summed,
    then the update, equal refine_plain bit for bit, for two passes on the
    JAX kernel's affinity of a bf16 bank."""
    _check_refine_over_split_ranges(m, live, top_k, splits, jnp.bfloat16)


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("m,live,top_k", [(2500, 1700, 50), (2049, None, 50),
                                          (1500, 1000, 1200)])
def test_fp32_refine_counts_over_split_ranges_sum_to_refine_plain(m, live, top_k,
                                                                  splits):
    """The test above on an fp32 bank: the JAX kernel's three-pass split
    affinity, which refine_hilo_kernel counts over the same ranges."""
    _check_refine_over_split_ranges(m, live, top_k, splits, jnp.float32)


def _check_refine_over_split_ranges(m, live, top_k, splits, bank):
    mk, _, q = _peaky(11, k=2, m=m, n=70)
    valid = None if live is None else np.arange(m) < live
    aff = _t(_pallas_split_affinity(q, mk, valid, bank))
    stats = cmr.candidates_plain(aff, top_k)
    cuts = _split_cuts(m, splits, 256)
    assert all(j0 < j1 for j0, j1 in cuts) and cuts[-1][1] == m
    for _ in range(2):
        counts = sum(cmr.refine_counts_plain(aff[..., j0:j1], stats)
                     for j0, j1 in cuts)
        refined = cmr.refine_update_plain(counts, stats, top_k)
        assert torch.equal(refined, cmr.refine_plain(aff, stats, top_k))
        stats = refined


def _bin_collisions(seed):
    """tests/test_pallas_memory_read.py:76-83: 60 strong matches for every
    query at a stride of 256 keys, so all share one partition-1 bin."""
    rng = np.random.RandomState(seed)
    mk = rng.randn(1, 16384, 128).astype(np.float32) * 0.02
    q = rng.randn(64, 128).astype(np.float32)
    hot = np.arange(60) * 256 + 7
    mk[0, hot] = (q.mean(0) / np.linalg.norm(q.mean(0)) * 4.0
                  + rng.randn(60, 128).astype(np.float32) * 0.05)
    return mk, rng.randn(1, 16384, 512).astype(np.float32), q


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_threshold_plain_matches_pallas_on_bin_collisions(bf16):
    """The plain read with two refine passes against the Pallas kernel on
    the input refine exists for (phase A's bins undercount)."""
    mk, mv, q = _bin_collisions(12)
    jk, jv = jnp.asarray(mk), jnp.asarray(mv)
    tk, tv = _t(mk), _t(mv)
    if bf16:
        jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
        tk, tv = tk.to(torch.bfloat16), tv.to(torch.bfloat16)
    ref = np.asarray(memory_read_pallas(jk, jv, jnp.asarray(q), top_k=50,
                                        interpret=True, n_refine=2))
    out = cmr.memory_read_threshold_plain(tk, tv, _t(q), top_k=50,
                                          n_refine=2).numpy()
    err = np.abs(out - ref)   # the limits of the peaky-input test above
    assert err.max() <= 2e-3, err.max()
    assert err.mean() <= 1e-4, err.mean()


def test_split_count_fills_the_waves():
    # The session's timing shape (K = 3, N = 1620) on 132 SMs: 78 readout
    # blocks of 64 rows and 153 candidates blocks of 32 rows -> 3 ranges;
    # 78 refine blocks of 64 rows, three an SM -> 5 ranges, on bf16 and
    # fp32 banks alike.
    assert cmr.range_blocks("readout", 3, 1620) == 78
    assert cmr.range_blocks("candidates", 3, 1620) == 153
    assert cmr.range_blocks("refine", 3, 1620) == 78
    assert cmr.range_blocks("refine_f32", 3, 1620) == 78
    assert cmr.kernel_splits("refine_f32", 3, 1620, 21060, 132) == 5
    assert cmr.split_count(78, 21060, 132, 8) == 3
    assert cmr.split_count(153, 21060, 132, 4) == 3
    assert cmr.split_count(78, 21060, 3 * 132, 8) == 5
    assert [cmr.kernel_splits(name, 3, 1620, 21060, 132)
            for name in ("candidates", "refine", "readout")] == [3, 5, 3]
    assert cmr.kernel_splits("refine", 3, 1620, 1620, 132) == 5   # 7 slices
    assert cmr.split_count(1, 200, 132, 8) == 1        # one 256-key slice
    assert cmr.split_count(1, 2049, 132, 8) == 8       # capped
    for base in range(1, 400, 7):
        for m in (256, 1620, 11340):
            s = cmr.split_count(base, m, 132, 8)
            assert 1 <= s <= min(8, -(-m // 256))


def test_entry_points_default_to_the_card():
    entry_points = [
        InferenceCore.__init__, DAVISProcessor.__init__,
        S2MController.__init__, davis_interactive.run_davis_interactive,
        davis_interactive.run_local_interactive,
        davis_interactive.run_local_interactive_davis,
        LocalInteractiveSession.__init__, davis_metrics.SequenceJF.__init__,
        davis_metrics.region_j, davis_metrics.batched_jf,
        davis_metrics.sequence_jf, davis_metrics.db_eval_boundary,
        fbrs_controller.FBRSController.__init__,
        fbrs_controller.InteractiveController.__init__,
        fbrs_predictor.FeatureBRSPredictor.__init__,
        fbrs_predictor.get_predictor]
    for fn in entry_points:
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert click_to_mask.parse_args(["--image", "x.png", "--clicks", "1,2,+"]
                                    ).device == "cuda"
    from mivos_tpu_torch import accuracy_envelope, full_protocol, long_video_bench
    for parse in (accuracy_envelope.parse_args, full_protocol.parse_args,
                  long_video_bench.parse_args):
        assert parse([]).device == "cuda"
    device = inspect.signature(MemoryBank.__init__).parameters["device"]
    assert device.default is inspect.Parameter.empty
    with pytest.raises(TypeError):
        MemoryBank(k=1, n=1)


# ---------------------------------------------------------------- dispatch

def test_dispatcher_routes_cpu_tensors_to_plain():
    mk, mv, q = _peaky(2, k=1, m=700, n=50)
    auto = mr.memory_read(_t(mk), _t(mv), _t(q), top_k=30)
    plain = cmr.memory_read_threshold_plain(_t(mk), _t(mv), _t(q), top_k=30)
    torch.testing.assert_close(auto, plain, atol=0, rtol=0)
    with pytest.raises(ValueError):
        mr.memory_read(_t(mk), _t(mv), _t(q), backend="pallas")


def test_cuda_wrapper_refuses_cpu_tensors():
    mk, mv, q = _peaky(3, k=1, m=300, n=20)
    before = cmr.launch_counts()
    with pytest.raises(ValueError):
        mr.memory_read(_t(mk), _t(mv), _t(q), top_k=30, backend="cuda")
    with pytest.raises(ValueError):
        cmr.candidates_cuda(cmr.read_query(_t(q)), _t(mk), None, 30)
    with pytest.raises(ValueError):
        cmr.hilo_planes_cuda(_t(mk))
    with pytest.raises(ValueError):
        cmr.bank_planes_cuda(_t(mk), _t(mv))
    stats = torch.zeros(1, 3, 20)
    planes = cmr.BankPlanes(*cmr.hilo_planes_plain(_t(mk)),
                            *cmr.hilo_planes_plain(_t(mv)))
    for bank in (_t(mk), _t(mk).to(torch.bfloat16)):
        with pytest.raises(ValueError):
            cmr.refine_cuda(cmr.read_query(_t(q)), bank, None, stats, 30, planes)
    assert cmr.launch_counts() == before


@pytest.mark.parametrize("n_refine", [0, 1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_launches_per_read_count_each_kernel_and_merge(dtype, n_refine):
    """One read launches phases A and B with their merges once and each
    refine pass's kernel with its merge, on either bank dtype; fp32 banks
    add the planes of keys and values."""
    per = cmr.launches_per_read(dtype, n_refine)
    assert set(per) == set(cmr.launch_counts())
    suffix = "bf16" if dtype == torch.bfloat16 else "f32"
    want = {f"candidates_{suffix}": 1, "candidates_merge": 1,
            f"refine_{suffix}": n_refine, "refine_merge": n_refine,
            f"readout_{suffix}": 1, "readout_merge": 1,
            "hilo_planes": 2 if dtype == torch.float32 else 0}
    assert per == {name: want.get(name, 0) for name in per}


def test_memory_config_rejects_unported_km():
    """MemoryConfig takes km, now that the km read is ported, and still
    refuses a bad mem_freq. (The name is the one the test had when km was
    refused; it is kept so that the test's record carries on.)"""
    assert MemoryConfig(km=5.6).km == 5.6
    with pytest.raises(ValueError):
        MemoryConfig(mem_freq=0)


def test_memory_bank_writes_in_place_and_reads_live_prefix():
    bank = MemoryBank(k=2, n=3, key_dim=4, val_dim=5, device="cpu")
    init_k, init_v = torch.ones(2, 3, 4), torch.ones(2, 3, 5)
    bank.reset(2, init_k, init_v)
    assert bank.keys.shape == (2, 9, 4) and bank.num_slots == 1
    buf = bank.keys
    bank.write(1, torch.full((2, 3, 4), 2.0), torch.full((2, 3, 5), 2.0))
    assert bank.keys is buf   # in place
    k, v = bank.live(include_transient=False)
    assert k.shape == (2, 3, 4) and torch.equal(k, init_k)
    k, v = bank.live(include_transient=True)
    assert k.shape == (2, 6, 4) and float(v[:, 3:].mean()) == 2.0
    assert k.stride(0) == 9 * 4   # a view striding over the full buffer
    with pytest.raises(IndexError):
        bank.write(3, init_k, init_v)
