"""The PyTorch port's ops against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The JAX
side of the fused memory read runs `memory_read_pallas(interpret=True)`,
as tests/test_pallas_memory_read.py does; the port's side is the CUDA
kernels' plain PyTorch version, which is what a CPU tensor reaches.
"""
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
from mivos_tpu.ops.pallas.memory_read import memory_read_pallas
from mivos_tpu.utils import tensor as jtu
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.memory_bank import MemoryBank
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
        "('jax', 'jaxlib', 'flax', 'mivos_tpu', 'cv2', 'PIL'))\n"
        "print(len([m for m in sys.modules if m.startswith('mivos_tpu_torch')]))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 36  # every module was imported


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
        cmr.candidates_cuda(cmr.scaled_query(_t(q)), _t(mk), None, 30)
    assert cmr.launch_counts() == before


def test_memory_config_rejects_unported_km():
    with pytest.raises(NotImplementedError):
        MemoryConfig(km=5.6)
    with pytest.raises(ValueError):
        MemoryConfig(mem_freq=0)


def test_memory_bank_writes_in_place_and_reads_live_prefix():
    bank = MemoryBank(k=2, n=3, key_dim=4, val_dim=5)
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
