"""The long-video path of the PyTorch port against the JAX package: the
query cache's byte cap, the session with the cache off, and the commit
thinning at bank_cap_frames.

(1) The cache decision (`_qcache_enabled`) equals the JAX session's for
video lengths on both sides of a time-bucket edge and caps on both sides
of the video's bytes, fp32 and bf16, dec_width 1.0 and 0.5 (exact).
(2) A three-round session (T=8, 45x62 raw frames, K=2, top_k=10,
mem_freq=1, bank_cap_frames=6, fp32, exact reads, no fusion) with
cache_queries=False: every pass thins its commits, and the port commits
the slots JAX commits, its probabilities within 1e-4 of JAX's
(cache_queries=False, xla_exact) and of the port's own cached session
(fp32 convolution and matmul summation order, three rounds deep).
(3) `long_video_bench` end to end on the CPU at a tiny size.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import convert_prop_net
from mivos_tpu.config import MemoryConfig as JMemoryConfig
from mivos_tpu.core.inference import InferenceCore as JInferenceCore
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.utils.tensor import next_bucket as j_next_bucket
from mivos_tpu.utils.tensor import time_buckets as j_time_buckets
from mivos_tpu_torch import long_video_bench
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.utils.tensor import next_bucket, time_buckets

T, RH, RW, K = 8, 45, 62, 2
TOP_K, CAP = 10, 6
ROUNDS = (3, 7, 0)
PROB_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores (tests/test_torch_serve.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_time_buckets_are_jax_ones():
    assert time_buckets() == j_time_buckets()
    for n in (1, 8, 9, 150, 151, 960, 8192):
        assert next_bucket(n, time_buckets()) == j_next_bucket(n, j_time_buckets())


@pytest.fixture(scope="module")
def nets():
    """Untrained port nets per (dtype, dec_width): the decision reads only
    their dtype and width."""
    return {(dt, w): PropagationNetwork(top_k=TOP_K, dtype=dt, dec_width=w)
            for dt in (torch.float32, torch.bfloat16) for w in (1.0, 0.5)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1.0, 0.5])
@pytest.mark.parametrize("t", [150, 151])   # 150 is a bucket; 151 rounds to 187
def test_cache_decision_matches_jax(nets, dtype, width, t):
    h, w = 32, 48
    images = np.zeros((t, h, w, 3), np.float32)
    jnet = JPropagation(top_k=TOP_K, dec_width=width,
                        dtype="bfloat16" if dtype == torch.bfloat16 else None)
    per_frame = (2 if dtype == torch.bfloat16 else 4) * sum(
        (h // s) * (w // s) * c for s, c in ((8, max(16, round(512 * width))),
                                             (4, max(16, round(256 * width))),
                                             (16, 128), (16, 512)))
    edge = next_bucket(t, time_buckets()) * per_frame
    for cap, on in ((edge, True), (edge - 1, False), (3 << 30, True)):
        for cache in (True, False):
            jcore = JInferenceCore(jnet, {}, None, None, images, K,
                                   mem=JMemoryConfig(top_k=TOP_K, query_cache_bytes=cap,
                                                     cache_queries=cache))
            core = InferenceCore(nets[dtype, width], None, images, K,
                                 mem=MemoryConfig(top_k=TOP_K, query_cache_bytes=cap,
                                                  cache_queries=cache),
                                 device="cpu")
            assert core.t_bucket == jcore.t_bucket
            assert core._qcache_enabled == jcore._qcache_enabled == (on and cache), (
                cap, cache)


def test_config_validates_the_cap():
    with pytest.raises(ValueError):
        MemoryConfig(query_cache_bytes=-1)
    assert MemoryConfig().query_cache_bytes == JMemoryConfig().query_cache_bytes
    assert MemoryConfig().cache_queries is JMemoryConfig().cache_queries is True


def _mask(rng):
    labels = rng.randint(0, K + 1, (RH, RW))
    fg = (labels[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)[..., None]
    return np.concatenate([1.0 - fg.sum(0, keepdims=True), fg], 0)


@pytest.fixture(scope="module")
def sessions():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    prop = init_params(PropagationNetwork(top_k=TOP_K, read_backend="exact"),
                       torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    images = rng.rand(T, RH, RW, 3).astype(np.float32)
    masks = [_mask(rng) for _ in ROUNDS]
    jcore = JInferenceCore(
        JPropagation(top_k=TOP_K, read_backend="xla_exact"),
        convert_prop_net({k: v.numpy() for k, v in prop.state_dict().items()}),
        None, None, images, K,
        mem=JMemoryConfig(top_k=TOP_K, mem_freq=1, bank_cap_frames=CAP,
                          cache_queries=False))
    cores = {cache: InferenceCore(prop, None, images, K,
                                  mem=MemoryConfig(top_k=TOP_K, mem_freq=1,
                                                   bank_cap_frames=CAP,
                                                   cache_queries=cache),
                                  device="cpu")
             for cache in (False, True)}
    out = []
    for idx, mask in zip(ROUNDS, masks):
        rec = {}
        for name, core in (("jax", jcore), ("off", cores[False]), ("on", cores[True])):
            lab = (core.interact(jnp.asarray(mask), idx) if name == "jax"
                   else core.interact(mask, idx))
            prob = np.stack([np.asarray(core.get_prob(t))[..., 0] if name == "jax"
                             else core.get_prob(t)[:, 0].numpy() for t in range(T)])
            rec[name] = (np.array(lab), prob, core.bank.num_slots)
        out.append(rec)
    return jcore, cores, out


def test_cache_is_off_and_on_as_configured(sessions):
    jcore, cores, _ = sessions
    assert not jcore._qcache_enabled and not cores[False]._qcache_enabled
    assert cores[True]._qcache_enabled
    assert cores[False]._qcache is None and not cores[False]._qcached.any()
    assert cores[True]._qcached.all()


@pytest.mark.parametrize("round_i", [0, 1, 2])
def test_uncached_session_matches_jax(sessions, round_i):
    _, _, out = sessions
    _, jprob, jslots = out[round_i]["jax"]
    _, prob, slots = out[round_i]["off"]
    assert prob.shape == jprob.shape == (T, K + 1, 48, 64)
    np.testing.assert_allclose(prob, jprob, atol=PROB_ATOL, rtol=0)
    assert slots == jslots


@pytest.mark.parametrize("round_i", [0, 1, 2])
def test_uncached_session_matches_cached(sessions, round_i):
    _, _, out = sessions
    np.testing.assert_allclose(out[round_i]["off"][1], out[round_i]["on"][1],
                               atol=PROB_ATOL, rtol=0)


@pytest.mark.parametrize("num_certain,pass_len,scan", [
    (1, 4, True), (1, 3, True), (2, 3, True), (3, 2, True), (1, 4, False),
    (1, 300, True), (2, 958, True), (1, 959, True), (3, 5, False)])
def test_commit_thinning_matches_jax(sessions, num_certain, pass_len, scan):
    jcore, cores, _ = sessions
    core = cores[False]
    saved = jcore.mem, core.mem
    try:
        for cap in (CAP, 512):
            jcore.mem = JMemoryConfig(top_k=TOP_K, mem_freq=1, bank_cap_frames=cap)
            core.mem = MemoryConfig(top_k=TOP_K, mem_freq=1, bank_cap_frames=cap)
            if cap - num_certain - (2 if scan else 1) < 1:
                with pytest.raises(ValueError):
                    core._effective_mem_freq(pass_len, num_certain, scan)
                with pytest.raises(ValueError):
                    jcore._effective_mem_freq(pass_len, num_certain, scan)
                continue
            assert core._effective_mem_freq(pass_len, num_certain, scan) == \
                jcore._effective_mem_freq(pass_len, num_certain, scan)
    finally:
        jcore.mem, core.mem = saved


def test_passes_thinned_and_bank_within_cap(sessions):
    """Every pass of the fixture would commit more slots than the cap
    leaves; the port's bank stays within bank_cap_frames."""
    _, cores, out = sessions
    assert [r["off"][2] for r in out] == [r["jax"][2] for r in out]
    for core in cores.values():
        assert core.bank.cap <= CAP


def test_long_video_bench_limit_cpu():
    prop = long_video_bench.make_net("cpu", torch.float32)
    rep = long_video_bench.run_limit(prop, "cpu", t=12, hw=(32, 48), k=2, rounds=3,
                                     bank_cap_frames=6, query_cache_bytes=0,
                                     log=lambda *a: None)
    assert rep["reads"] == [11, 10, 9] and len(rep["rounds_s"]) == 3
    assert not rep["qcache_enabled"] and rep["bank_cap"] <= 6
    assert rep["max_read_M"] == max(rep["bank_M"]) + rep["n16"]
