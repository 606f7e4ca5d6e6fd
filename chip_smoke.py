#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mivos_tpu_torch) on one NVIDIA GPU.

Usage, from the repository root on a machine with an H100 and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):
  1. card    require CUDA; print `nvidia-smi` name and power limit;
             build the CUDA kernels from csrc/ and print the build time.
  2. gate    banks memorized by a random-init fp32 encoder over 13 and
             26 synthetic 480p frames (M = 21060 and 42120, last 800
             slots invalid), fp32 and bf16: the kernels against their
             plain PyTorch version (mean error <= 1e-4 of the readout
             scale) and against the exact torch.topk read (mean < 1e-3,
             max < 0.3 of the readout scale), n_refine 0 and 1; each
             kernel alone against its plain phase at M = 21060, bf16;
             the iid-gaussian regime at M = 20480, reported only; CUDA
             event timings of kernels, plain phases and exact read.
  3. check   a small fp32 session through the kernels against the same
             session through the exact read.
  4. session the bench protocol through InferenceCore.interact: 60
             frames 480x854, K=3, top_k=50, mem_freq=5, bf16 convs and
             bank; one warm and 3 measured rounds (frames/s); then a
             second interaction on frame 59 (fusion pass) and one round
             with read_refine=1. The launch counters, zeroed just
             before, must equal the number of memory reads per kernel.
The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""
import copy
import json
import subprocess
import time

import numpy as np
import torch

from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.ops.cuda.build import load_library
from mivos_tpu_torch.ops.memory_read import memory_read
from mivos_tpu_torch.utils.tensor import one_hot_mask, pad_divide_by

T, RH, RW, K = 60, 480, 854, 3
TOP_K, MEM_FREQ = 50, 5
GATE_FRAMES, TAIL = 26, 800
MEASURED = 3
SRC = "mivos_tpu_torch/csrc/memory_read.cu"
REPLACES = {"candidates": "mivos_tpu/ops/pallas/memory_read.py:116",
            "refine": "mivos_tpu/ops/pallas/memory_read.py:221",
            "readout": "mivos_tpu/ops/pallas/memory_read.py:284"}
MEAN, STD = np.array([0.485, 0.456, 0.406]), np.array([0.229, 0.224, 0.225])


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def synthetic_video(seed, t, h, w, k):
    """Normalized frames (t, h, w, 3) of k drifting coloured ellipses on
    a textured background, and their label maps (t, h, w)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    colours = rng.rand(k + 1, 3).astype(np.float32)
    centre = rng.rand(k, 2) * [h, w]
    vel = rng.randn(k, 2) * 4.0
    radii = rng.uniform(40, 140, (k, 2))
    bg = 0.2 * np.sin(yy[..., None] / rng.uniform(5, 30, 3)
                      + xx[..., None] / rng.uniform(5, 30, 3))
    frames = np.empty((t, h, w, 3), np.float32)
    labels = np.zeros((t, h, w), np.int64)
    for i in range(t):
        for o in range(k):
            cy, cx = centre[o] + vel[o] * i
            inside = (((yy - cy) / radii[o, 0]) ** 2
                      + ((xx - cx) / radii[o, 1]) ** 2) <= 1.0
            labels[i][inside] = o + 1
        img = colours[labels[i]] + bg + 0.05 * rng.randn(h, w, 3)
        frames[i] = ((img - MEAN) / STD).astype(np.float32)
    return frames, labels


def interaction_mask(seed):
    """(K+1, RH, RW, 1) hard probabilities of a random label map."""
    lab = np.random.RandomState(seed).randint(0, K + 1, (RH, RW))
    fg = (lab[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)
    return np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None]


def cuda_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} capability "
        f"{torch.cuda.get_device_capability(0)}")
    t0 = time.perf_counter()
    lib = load_library()
    log(f"kernels built+loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s) -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())
    return card


def gate_banks(dev):
    """Random-init fp32 encoder banks over GATE_FRAMES synthetic frames and
    the query key of the next frame."""
    net = init_params(PropagationNetwork(top_k=TOP_K),
                      torch.Generator().manual_seed(0)).to(dev).eval()
    frames, labels = synthetic_video(7, GATE_FRAMES + 1, RH, RW, K)
    mks, mvs = [], []
    with torch.no_grad():
        for t in range(GATE_FRAMES):
            frame = pad_divide_by(torch.from_numpy(frames[t]).to(dev))[0]
            masks = pad_divide_by(one_hot_mask(
                torch.from_numpy(labels[t]).to(dev), K))[0]
            mk, mv = net.memorize(frame, masks)
            mks.append(mk)
            mvs.append(mv)
        qframe = pad_divide_by(torch.from_numpy(frames[GATE_FRAMES]).to(dev))[0]
        k16 = net.get_query_values(qframe)[3]
    q = k16[0].flatten(1).t().contiguous()
    return torch.cat(mks, 1), torch.cat(mvs, 1), q


def phase_gate(dev):
    mk_all, mv_all, q = gate_banks(dev)
    m_all = mk_all.shape[1]
    n16 = (-(-RH // 16)) * (-(-RW // 16))   # 30 * 54 = 1620 at 480p
    check(tuple(q.shape) == (n16, 128), f"query shape {tuple(q.shape)}")
    log(f"gate banks: M = {m_all // 2} and {m_all}, N = {q.shape[0]}")
    for m in (m_all // 2, m_all):
        valid = torch.arange(m, device=dev) < m - TAIL
        for dtype in (torch.float32, torch.bfloat16):
            mk = mk_all[:, :m].to(dtype).contiguous()
            mv = mv_all[:, :m].to(dtype).contiguous()
            exact = memory_read(mk, mv, q, top_k=TOP_K, valid=valid,
                                backend="exact")
            scale = exact.abs().mean().item()
            for n_refine in (0, 1):
                out = cmr.memory_read_threshold_cuda(mk, mv, q, TOP_K, valid,
                                                     n_refine)
                plain = cmr.memory_read_threshold_plain(mk, mv, q, TOP_K,
                                                        valid, n_refine)
                rep = {"regime": "encoder", "M": m, "dtype": str(dtype)[6:],
                       "n_refine": n_refine, "readout_scale": scale,
                       "vs_plain_mean": (out - plain).abs().mean().item(),
                       "vs_plain_max": (out - plain).abs().max().item(),
                       "vs_exact_mean": (out - exact).abs().mean().item(),
                       "vs_exact_max": (out - exact).abs().max().item()}
                log(json.dumps(rep))
                check(bool(torch.isfinite(out).all()), "non-finite readout")
                check(rep["vs_plain_mean"] <= 1e-4 * scale, f"kernel vs plain {rep}")
                check(rep["vs_exact_mean"] < 1e-3 * scale, f"kernel vs exact {rep}")
                check(rep["vs_exact_max"] < 0.3 * scale, f"kernel vs exact {rep}")
            del exact, out, plain
    # iid-gaussian ties: reported, not gated (as in the JAX kernel check).
    rng = np.random.RandomState(0)
    gk, gv, gq = (torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
                  for s in ((K, 20480, 128), (K, 20480, 512), (1620, 128)))
    out = cmr.memory_read_threshold_cuda(gk, gv, gq, TOP_K)
    exact = memory_read(gk, gv, gq, top_k=TOP_K, backend="exact")
    plain = cmr.memory_read_threshold_plain(gk, gv, gq, TOP_K)
    log(json.dumps({"regime": "iid-gaussian", "M": 20480, "dtype": "float32",
                    "readout_scale": exact.abs().mean().item(),
                    "vs_plain_mean": (out - plain).abs().mean().item(),
                    "vs_exact_mean": (out - exact).abs().mean().item(),
                    "vs_exact_max": (out - exact).abs().max().item()}))
    del gk, gv, out, exact, plain

    # Each kernel alone against its plain phase, on the same inputs, at
    # the session's read shape (bf16 bank, M = 21060, N = 1620, K = 3).
    m = m_all // 2
    mk = mk_all[:, :m].to(torch.bfloat16).contiguous()
    mv = mv_all[:, :m].to(torch.bfloat16).contiguous()
    del mk_all, mv_all
    qs = cmr.scaled_query(q)
    mask = cmr.additive_mask(torch.arange(m, device=dev) < m - TAIL)
    aff = cmr.masked_affinity(qs, mk, mask)
    st_k = cmr.candidates_cuda(qs, mk, mask, TOP_K)
    st_p = cmr.candidates_plain(aff, TOP_K)
    ref_k = cmr.refine_cuda(qs, mk, mask, st_k, TOP_K)
    ref_p = cmr.refine_plain(aff, st_k, TOP_K)
    out_k = cmr.readout_cuda(qs, mk, mv, mask, st_k)
    out_p = cmr.readout_plain(aff, mv, st_k)
    scale = out_p.abs().mean().item()
    errs = {"candidates": (st_k - st_p).abs().max().item(),
            "refine": (ref_k - ref_p).abs().max().item(),
            "readout": (out_k - out_p).abs().max().item()}
    readout_mean = (out_k - out_p).abs().mean().item()
    log(json.dumps({"per_kernel_max_abs_err": errs,
                    "readout_mean_abs_err": readout_mean,
                    "readout_scale": scale}))
    # Thresholds in nats: affinity rounding (fp32 FMA order) may move a
    # bisection step only where a bin value sits within ~1e-6 of a
    # midpoint, i.e. at the last steps' ~1e-5 resolution.
    check(errs["candidates"] <= 1e-3, f"candidates vs plain {errs}")
    check(errs["refine"] <= 1e-3, f"refine vs plain {errs}")
    check(readout_mean <= 1e-4 * scale and errs["readout"] < 0.3 * scale,
          f"readout vs plain {errs} mean {readout_mean}")
    del aff

    # Timings at the same shape: CUDA events, after warm-up.
    def plain_phase(fn):
        return lambda: fn(cmr.masked_affinity(qs, mk, mask))

    ms = {"candidates": cuda_ms(lambda: cmr.candidates_cuda(qs, mk, mask, TOP_K)),
          "refine": cuda_ms(lambda: cmr.refine_cuda(qs, mk, mask, st_k, TOP_K)),
          "readout": cuda_ms(lambda: cmr.readout_cuda(qs, mk, mv, mask, st_k))}
    plain_ms = {
        "candidates": cuda_ms(plain_phase(lambda a: cmr.candidates_plain(a, TOP_K)), 3, 1),
        "refine": cuda_ms(plain_phase(lambda a: cmr.refine_plain(a, st_k, TOP_K)), 3, 1),
        "readout": cuda_ms(plain_phase(lambda a: cmr.readout_plain(a, mv, st_k)), 3, 1)}
    valid = torch.arange(m, device=dev) < m - TAIL
    reads = {
        "kernel_read_ms": cuda_ms(lambda: cmr.memory_read_threshold_cuda(
            mk, mv, q, TOP_K, valid)),
        "plain_read_ms": cuda_ms(lambda: cmr.memory_read_threshold_plain(
            mk, mv, q, TOP_K, valid), 3, 1),
        "exact_read_ms": cuda_ms(lambda: memory_read(
            mk, mv, q, top_k=TOP_K, valid=valid, backend="exact"), 3, 1)}
    log(json.dumps({"timing_M": m, "dtype": "bfloat16", "kernel_ms": ms,
                    "plain_ms": plain_ms, **reads}))
    return errs, ms, plain_ms


def make_nets(dev, dtype, read_backend="auto", seed=0):

    gen = torch.Generator().manual_seed(seed)
    prop = init_params(PropagationNetwork(top_k=TOP_K, read_backend=read_backend,
                                          dtype=dtype), gen)
    fuse = init_params(FusionNet(dtype=dtype), gen)
    return prop.to(dev), fuse.to(dev)


def phase_check(dev):
    """Small fp32 session: the kernel path against the exact-read path."""
    t, h, w = 10, 240, 427
    frames, labels = synthetic_video(11, t, h, w, K)
    lab0 = labels[0]
    fg = (lab0[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)
    mask = np.concatenate([1.0 - fg.sum(0, keepdims=True), fg])[..., None]
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)
    probs = {}
    for backend in ("auto", "exact"):
        prop, fuse = make_nets(dev, torch.float32, backend, seed=3)
        core = InferenceCore(prop, fuse, frames, K, mem=mem, device=dev)
        core.interact(mask, 0)
        probs[backend] = torch.stack([core.get_prob(i) for i in range(t)])
    diff = (probs["auto"] - probs["exact"]).abs()
    top2 = probs["exact"][:, :, 0].topk(2, dim=1).values
    decided = (top2[:, 0] - top2[:, 1]) > 0.05
    agree = (probs["auto"][:, :, 0].argmax(1) == probs["exact"][:, :, 0].argmax(1))
    rep = {"small_session": [t, h, w], "mean_abs_prob_diff": diff.mean().item(),
           "max_abs_prob_diff": diff.max().item(),
           "decided_frac": decided.float().mean().item(),
           "decided_agreement": (agree[decided].float().mean().item()
                                 if decided.any() else 1.0)}
    log(json.dumps(rep))
    check(rep["mean_abs_prob_diff"] < 1e-3, f"kernel vs exact session {rep}")
    check(rep["decided_agreement"] >= 0.999, f"kernel vs exact session {rep}")


def expected_reads(core, idx):
    """Frames the next interact(idx) propagates to: one memory read each."""
    front = min([ti for ti in core.interacted if ti > idx] + [core.t])
    back = max([ti for ti in core.interacted if ti < idx] + [-1])
    return (front - idx - 1) + (idx - back - 1)


def session_invariants(core, labels):
    check(labels.shape == (T, RH, RW) and labels.dtype == np.uint8,
          f"labels {labels.shape} {labels.dtype}")
    check(int(labels.max()) <= K, "label out of range")
    lw, uw, lh, uh = core.pad
    worst = torch.zeros((), device=core.device)
    finite = torch.ones((), dtype=torch.bool, device=core.device)
    for ti in range(T):
        p = core.get_prob(ti)[:, 0, lh:core.nh - uh, lw:core.nw - uw]
        finite &= torch.isfinite(p).all()
        worst = torch.maximum(worst, (p.sum(0) - 1.0).abs().max())
    check(bool(finite), "non-finite probabilities")
    check(worst.item() < 1e-4, f"probabilities sum to 1 +- {worst.item()}")


def run_round(core, mask, idx, counts_before):

    reads = expected_reads(core, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels = core.interact(mask, idx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    session_invariants(core, labels)
    got = cmr.launch_counts()
    refine = core.prop_net.read_refine
    for name, per_read in (("candidates", 1), ("readout", 1),
                           ("refine", refine)):
        check(got[name] - counts_before[name] == per_read * reads,
              f"{name}: {got[name] - counts_before[name]} launches for "
              f"{reads} reads")
    return dt, reads, got


def phase_session(dev):
    torch.backends.cudnn.benchmark = True
    prop, fuse = make_nets(dev, torch.bfloat16)
    rng = np.random.RandomState(0)
    # Frames and interaction masks reach the device before the timed
    # rounds, as in bench.py.
    images = torch.from_numpy(rng.rand(T, RH, RW, 3).astype(np.float32)).to(dev)
    masks = [torch.from_numpy(interaction_mask(s)).to(dev) for s in range(8)]
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)

    warm = InferenceCore(prop, fuse, images, K, mem=mem, device=dev)
    dt, _, _ = run_round(warm, masks[7], 0, cmr.launch_counts())
    log(f"warm round: {dt:.3f} s")
    del warm

    cmr.reset_launch_counts()   # the main path's launches start here
    counts = cmr.launch_counts()
    fps, total_reads = [], 0
    for s in range(MEASURED):
        core = InferenceCore(prop, fuse, images, K, mem=mem, device=dev)
        dt, reads, counts = run_round(core, masks[s], 0, counts)
        total_reads += reads
        fps.append((T - 1) / dt)
        log(f"round {s}: {dt:.3f} s, {fps[-1]:.2f} frames/s, {reads} reads, "
            f"bank slots {core.bank.num_slots}, peak mem "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    dt, reads, counts = run_round(core, masks[3], T - 1, counts)
    total_reads += reads
    log(f"fusion round (interaction on frame {T - 1}): {dt:.3f} s, "
        f"{reads} reads")
    refine_net = copy.copy(prop)
    refine_net.read_refine = 1
    core = InferenceCore(refine_net, fuse, images, K, mem=mem, device=dev)
    dt, reads, counts = run_round(core, masks[4], 0, counts)
    total_reads += reads
    log(f"read_refine=1 round: {dt:.3f} s, {reads} reads")
    counts = cmr.launch_counts()
    med = sorted(fps)[len(fps) // 2]
    log(json.dumps({"metric": "propagation_fps_480p_3obj", "median": med,
                    "rounds": fps, "reads": total_reads,
                    "launches": counts}))
    for name, n in counts.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    return counts


def main():
    card = phase_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    errs, ms, plain_ms = phase_gate(dev)
    log(f"gate phase: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    phase_check(dev)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches = phase_session(dev)
    log(f"session phase: {time.perf_counter() - t0:.1f} s")
    kernels = [{"name": name, "route": "cuda", "source": SRC,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms[name],
                "plain_ms": plain_ms[name]} for name in REPLACES]
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()  # any failure raises: non-zero exit, no result line
