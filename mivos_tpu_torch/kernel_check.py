"""The memory-read kernels against the exact read at the session's shapes
(counterpart of scripts/pallas_kernel_check.py).

Two input regimes, as in the JAX script:

  encoder       (GATED) banks the memorize path writes: a propagation
                net's fp32 encoder over synthetic 480p frames
                (`synthetic_sequence(7, ...)`, ImageNet-normalized,
                K = 3 objects), the query key of the next frame.
  iid-gaussian  (REPORTED, not gated) keys, values and queries drawn iid
                from RandomState(0): the top-k order statistics are
                maximally tied, the adversarial case of any thresholded
                top-k.

`--gate-only` (what `bench` runs first, in process): encoder banks over
26 frames, M = 21060 and 42120 with the last 800 slots invalid, fp32 and
bf16 at the smaller M and bf16 at the larger; the kernel read against the
exact torch.topk read, mean error < 1e-3 and max < 0.3 of the readout
scale (mean |exact|). On the card each shape also runs `gate_read`'s
stricter checks: the whole read at n_refine 0 and 1 against its plain
version (mean <= 1e-4 of the scale) and each kernel alone against its
plain phase. Full mode: 13 frames (M = 21060), the encoder regime gated
at a mean of 1e-2 of the scale (the JAX script's), the iid regime at
M = 20480 and 40960, and the CUDA-event ms of the cuda, exact and plain
reads on the bf16 banks.

The JAX script's `pallas_*` keys are `kernel_*` here; its `xla_approx`
context numbers are the plain read's (`plain_*`): the port has no
approximate read. Weights: a propagation `.pth` (`--weights`), or a
random init from seed 0 (the JAX gate's fallback when its weights are
missing). `gate_session_shapes`, `phase_timing` and `bound_ms` are what
chip_smoke.py's gate phase runs.

Usage: python -m mivos_tpu_torch.kernel_check [--gate-only]
    [--weights prop.pth] [--out PATH] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.data.transforms import im_normalize
from mivos_tpu_torch.generation.synthetic import labels_to_onehot, synthetic_sequence
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.ops.memory_read import memory_read
from mivos_tpu_torch.utils.measure import (LaunchTally, cuda_ms, device_info,
                                           require_device)
from mivos_tpu_torch.utils.tensor import pad_divide_by

K, N, CK, CV, TOP_K = 3, 1620, 128, 512, 50
H, W = 480, 854   # raw 480p; pads to 480x864 -> n16 = 30*54 = 1620
TAIL = 800        # invalid slots at the end of a bank, as in sessions
GATE_FRAMES, FULL_FRAMES = 26, 13
MAX_GATE = 0.3    # of the readout scale (scripts/pallas_kernel_check.py:204)
IID_M = (20480, 40960)
TIMING_M = (1620, 11340, 21060)   # the smallest, middle and largest bank of a bench round
TIMING_ITERS = 50
# NVIDIA H100 SXM peaks at 700 W (data sheet): dense bf16 tensor cores, HBM3.
PEAK_BF16_FLOPS, PEAK_BYTES_S = 989e12, 3.35e12
BF16, F32 = torch.bfloat16, torch.float32


class GateError(RuntimeError):
    """A kernel disagreed with its references beyond the gate's bounds."""


def check(cond, msg) -> None:
    if not cond:
        raise GateError(f"kernel gate failed: {msg}")


def _log(*args):
    print(*args, flush=True)


def prop_net(weights: Optional[str], seed: int = 0) -> PropagationNetwork:
    """The fp32 propagation net of the banks: a `.pth` or a random init."""
    net = PropagationNetwork(top_k=TOP_K)
    if weights:
        return load_reference_pth(net, weights)
    return init_params(net, torch.Generator().manual_seed(seed))


def encoder_banks(net: PropagationNetwork, n_frames: int, dev, video=None):
    """(K, n_frames * n16, CK/CV) fp32 banks memorized by `net` over
    synthetic H x W frames (the JAX script's `encoder_banks`:
    `synthetic_sequence(7, ...)`, ImageNet-normalized), and the (n16, CK)
    query key of frame n_frames. video: other (n_frames + 1, H, W, 3)
    normalized frames and (n_frames + 1, H, W) labels to memorize."""
    net, k = net.to(dev).eval(), K
    if video is None:
        images, labels = synthetic_sequence(7, n_frames + 1, H, W, k)
        video = im_normalize(images).astype(np.float32), labels
    images, labels = video
    mks, mvs = [], []
    with torch.no_grad():
        for t in range(n_frames):
            frame = pad_divide_by(torch.from_numpy(images[t]).to(dev))[0]
            masks = pad_divide_by(torch.from_numpy(labels_to_onehot(labels[t], k)).to(dev))[0]
            mk, mv = net.memorize(frame, masks)
            mks.append(mk)
            mvs.append(mv)
        qframe = pad_divide_by(torch.from_numpy(images[n_frames]).to(dev))[0]
        k16 = net.get_query_values(qframe)[3]
    return torch.cat(mks, 1), torch.cat(mvs, 1), k16[0].flatten(1).t().contiguous()


def compare(mk, mv, q, valid, tag: str, tally: Optional[LaunchTally] = None,
            context: bool = False) -> Dict:
    """The kernel read (`auto`: the CUDA kernels on the card, their plain
    version on the CPU) against the exact read; context: the plain read's
    errors too. The JAX script's report, `pallas_*` as `kernel_*`."""
    with tally.window(1, mk.dtype) if tally else contextlib.nullcontext():
        out = memory_read(mk, mv, q, top_k=TOP_K, valid=valid)
    exact = memory_read(mk, mv, q, top_k=TOP_K, valid=valid, backend="exact")
    rep = {"regime": tag, "M": int(mk.shape[1]), "dtype": str(mk.dtype)[6:],
           "readout_scale": exact.abs().mean().item(),
           "kernel_max_abs_err": (out - exact).abs().max().item(),
           "kernel_mean_abs_err": (out - exact).abs().mean().item()}
    if context:
        plain = memory_read(mk, mv, q, top_k=TOP_K, valid=valid, backend="plain")
        rep["plain_max_abs_err"] = (plain - exact).abs().max().item()
        rep["plain_mean_abs_err"] = (plain - exact).abs().mean().item()
    return rep


def shared_threshold(st_a, st_b):
    """Phase A stats `st_a` with each row's threshold lowered to the
    smaller of two pipelines' (a kernel's and its plain version's), the
    threshold the readout kernel and its plain phase are compared on.
    Where the two bisections part, the pipeline whose rounding put the
    boundary entry on the midpoint counted it and ends with its threshold
    at that entry, which the other rounding can put one ulp below; the
    other pipeline ends below the entry, so both roundings keep it there.
    On the higher threshold each read is right by its own affinity yet
    the two differ by that entry's weight: up to 1.2% of the readout
    scale in a row on a pretrained encoder's banks, 9e-4 in the mean
    (tests/test_torch_gate.py)."""
    st = st_a.clone()
    st[:, 0] = torch.minimum(st_a[:, 0], st_b[:, 0])
    return st


def gate_read(mk, mv, q, valid, per_object=False):
    """Hold the kernel read of one bank (CUDA tensors) against its
    references: the whole read (n_refine 0 and 1) against its plain
    version (mean <= 1e-4 of the readout scale) and the exact torch.topk
    read (mean < 1e-3, max < 0.3 of the scale), then each kernel alone
    against its plain phase on the same inputs (the readout on
    shared_threshold's stats). per_object: the kernels read all K
    objects at once and the references, whose dense (K, N, M) fp32
    affinity would not fit at a long video's M, one object at a time.
    Returns the whole-read reports and the per-kernel one."""
    objs = ([slice(j, j + 1) for j in range(mk.shape[0])] if per_object
            else [slice(None)])

    def by_object(fn):
        return torch.cat([fn(o) for o in objs])

    exact = by_object(lambda o: memory_read(mk[o], mv[o], q, top_k=TOP_K,
                                            valid=valid, backend="exact"))
    scale = exact.abs().mean().item()
    reps = []
    for n_refine in (0, 1):
        out = cmr.memory_read_threshold_cuda(mk, mv, q, TOP_K, valid, n_refine)
        plain = by_object(lambda o: cmr.memory_read_threshold_plain(
            mk[o], mv[o], q, TOP_K, valid, n_refine))
        rep = {"regime": "encoder", "K": mk.shape[0], "M": mk.shape[1],
               "dtype": str(mk.dtype)[6:], "n_refine": n_refine,
               "readout_scale": scale,
               "vs_plain_mean": (out - plain).abs().mean().item(),
               "vs_plain_max": (out - plain).abs().max().item(),
               "vs_exact_mean": (out - exact).abs().mean().item(),
               "vs_exact_max": (out - exact).abs().max().item()}
        reps.append(rep)
        check(bool(torch.isfinite(out).all()), f"non-finite readout {rep}")
        check(rep["vs_plain_mean"] <= 1e-4 * scale, f"kernel vs plain {rep}")
        check(rep["vs_exact_mean"] < 1e-3 * scale, f"kernel vs exact {rep}")
        check(rep["vs_exact_max"] < MAX_GATE * scale, f"kernel vs exact {rep}")
    del exact, out, plain
    rq = cmr.read_query(q)
    mask = cmr.additive_mask(valid)
    planes = None if mk.dtype == BF16 else cmr.bank_planes_cuda(mk, mv)
    st_k = cmr.candidates_cuda(rq, mk, mask, TOP_K, planes)
    ref_k = cmr.refine_cuda(rq, mk, mask, st_k, TOP_K, planes)
    st_p, ref_p = [], []
    for o in objs:
        aff = cmr.read_affinity(rq, mk[o], mask)
        st_p.append(cmr.candidates_plain(aff, TOP_K))
        ref_p.append(cmr.refine_plain(aff, st_k[o], TOP_K))
        del aff
    st_p, ref_p = torch.cat(st_p), torch.cat(ref_p)
    st = shared_threshold(st_k, st_p)
    out_k = cmr.readout_cuda(rq, mk, mv, mask, st, planes)
    out_p = by_object(lambda o: cmr.readout_plain(cmr.read_affinity(rq, mk[o], mask),
                                                  mv[o], st[o]))
    errs = {"candidates": (st_k - st_p).abs().max().item(),
            "refine": (ref_k - ref_p).abs().max().item(),
            "readout": (out_k - out_p).abs().max().item()}
    kernel_rep = {"K": mk.shape[0], "M": mk.shape[1],
                  "dtype": str(mk.dtype)[6:], "per_kernel_max_abs_err": errs,
                  "readout_mean_abs_err": (out_k - out_p).abs().mean().item(),
                  "readout_scale": out_p.abs().mean().item()}
    if planes is not None:   # both round to nearest even: equal bits
        errs["hilo_planes"] = max(
            (a.float() - b.float()).abs().max().item() for a, b in
            zip(planes, cmr.hilo_planes_plain(mk) + cmr.hilo_planes_plain(mv)))
        check(errs["hilo_planes"] == 0.0, f"bf16 planes vs plain {kernel_rep}")
    # Thresholds in nats: affinity rounding (the tensor cores' accumulation
    # order against cuBLAS's) may move a bisection step only where a bin value
    # sits within ~1e-6 of a midpoint, i.e. at the last steps' ~1e-5
    # resolution.
    check(errs["candidates"] <= 1e-3, f"candidates vs plain {kernel_rep}")
    check(errs["refine"] <= 1e-3, f"refine vs plain {kernel_rep}")
    check(kernel_rep["readout_mean_abs_err"] <= 1e-4 * kernel_rep["readout_scale"]
          and errs["readout"] < MAX_GATE * kernel_rep["readout_scale"],
          f"readout vs plain {kernel_rep}")
    return reps, kernel_rep


def worst_errs(reps):
    """Each kernel's worst error over gate_read's per-kernel reports, per
    bank dtype."""
    worst = {}
    for rep in reps:
        by_name = worst.setdefault(rep["dtype"], {})
        for name, err in rep["per_kernel_max_abs_err"].items():
            by_name[name] = max(by_name.get(name, 0.0), err)
    return worst


def gate_session_shapes(mk_all, mv_all, q, banks: str, log: Callable = _log):
    """gate_read at the session's read shapes: K = 3, M = half and all of
    the banks' slots (21060 and 42120 at 26 frames), the last TAIL slots
    invalid, fp32 and bf16. Logs every report with the banks' origin;
    returns each kernel's worst error."""
    m_all = mk_all.shape[1]
    log(f"gate banks ({banks}): M = {m_all // 2} and {m_all}, N = {q.shape[0]}")
    kernel_reps = []
    for m in (m_all // 2, m_all):
        valid = torch.arange(m, device=q.device) < m - TAIL
        for dtype in (F32, BF16):
            reps, kernel_rep = gate_read(mk_all[:, :m].to(dtype).contiguous(),
                                         mv_all[:, :m].to(dtype).contiguous(),
                                         q, valid)
            for rep in reps + [kernel_rep]:
                log(json.dumps(dict(rep, banks=banks)))
            kernel_reps.append(kernel_rep)
    return worst_errs(kernel_reps)


def gate(mk_all, mv_all, q, log: Callable = _log) -> Dict:
    """The JAX gate (`--gate-only`) on banks of 2 x m slots: fp32 and bf16
    at m (the last TAIL of them invalid), bf16 at 2 x m. On the card each
    shape runs gate_read (stricter; its n_refine 0 read gives the report);
    on the CPU `compare`. Raises GateError past the bounds; returns the
    reports, the worst mean error over the scale and, on the card, each
    kernel's worst error."""
    m = mk_all.shape[1]
    half = m // 2
    shapes = [(half, F32), (half, BF16), (m, BF16)]
    reports, kernel_reps = [], []
    for mm, dtype in shapes:
        mk = mk_all[:, :mm].to(dtype).contiguous()
        mv = mv_all[:, :mm].to(dtype).contiguous()
        valid = torch.arange(mm, device=q.device) < mm - TAIL
        if mk.is_cuda:
            reps, kernel_rep = gate_read(mk, mv, q, valid)
            kernel_reps.append(kernel_rep)
            rep = {"regime": "encoder", "M": mm, "dtype": str(dtype)[6:],
                   "readout_scale": reps[0]["readout_scale"],
                   "kernel_max_abs_err": reps[0]["vs_exact_max"],
                   "kernel_mean_abs_err": reps[0]["vs_exact_mean"]}
        else:
            rep = compare(mk, mv, q, valid, "encoder")
        log(json.dumps(rep))
        reports.append(rep)
        del mk, mv
    hold(reports, 1e-3)
    worst = max(r["kernel_mean_abs_err"] / max(r["readout_scale"], 1e-9) for r in reports)
    return {"reports": reports, "worst_mean_err_frac": worst,
            "per_kernel_max_abs_err": worst_errs(kernel_reps) if kernel_reps else None}


def hold(reports: List[Dict], mean_gate: float) -> None:
    """The JAX script's gates on the encoder regime (:199-205)."""
    for r in reports:
        if r["regime"] != "encoder":
            continue
        scale = max(r["readout_scale"], 1e-9)
        check(r["kernel_max_abs_err"] < MAX_GATE * scale, r)
        check(r["kernel_mean_abs_err"] < mean_gate * scale, r)


def gate_only(dev, weights: Optional[str] = None, log: Callable = _log) -> Dict:
    """`--gate-only` in process: `gate` on GATE_FRAMES frames of encoder
    banks (bench.py's kernel gate)."""
    banks = encoder_banks(prop_net(weights), GATE_FRAMES, dev)
    try:
        return gate(*banks, log=log)
    finally:
        del banks
        if torch.device(dev).type == "cuda":
            torch.cuda.empty_cache()


def bound_ms(name, k, n, m, dtype):
    """Least time of one call of a TPU kernel's counterpart on a bank of
    `dtype` with a mask: its tensor-core FLOPs at the bf16 peak, or its
    bytes (each input read once, each output written once) at the memory
    rate, whichever is larger. The affinity counts as the JAX kernel's
    bf16 passes (`_affinity`, pallas/memory_read.py:102-113): two for
    bf16 keys, three for fp32 keys; the readout's w.V as one bf16 pass on
    bf16 banks and as three on fp32 banks (an fp32-accurate product from
    bf16 passes, as the affinity's). "hilo_planes": the planes of one
    read, fp32 keys and values read, two bf16 planes of each written.
    Returns (ms, "operations" | "bytes")."""
    flops, nbytes = work(name, k, n, m, dtype)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def work(name, k, n, m, dtype):
    """(tensor-core FLOPs, bytes) of one call of a kernel (bound_ms)."""
    if name == "hilo_planes":
        return 0, k * m * (CK + CV) * (4 + 2 + 2)
    bf16 = dtype == torch.bfloat16
    passes, esize = (2, 2) if bf16 else (3, 4)
    flops = passes * 2 * k * n * m * CK
    # keys, mask, stats, the query (fp32 q, or bf16 q_hi and q_lo)
    nbytes = k * m * CK * esize + m * 4 + k * 3 * n * 4 + n * CK * 4
    if name == "refine":
        nbytes += k * 3 * n * 4                                # stats out
    if name == "readout":
        flops += (1 if bf16 else 3) * 2 * k * n * m * CV
        nbytes += k * m * CV * esize + k * n * CV * 4          # values, out
    return flops, nbytes


def phase_timing(mk_all, mv_all, q, dtype, log: Callable = _log):
    """CUDA-event times of each kernel wrapper (kernel and merge; on fp32
    banks on the read's planes, and the planes of keys and values, as one
    read makes them), its plain phase (affinity included) and its bound
    at M = TIMING_M, banks of `dtype`, K = 3, N = 1620, the last TAIL
    slots invalid; two refine calls that must give equal bits; at the
    largest M the whole read against the plain and exact reads. Logs one
    line; returns {M: {...}}."""
    dev = q.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16 = dtype == torch.bfloat16
    timing = {}
    for m in TIMING_M:
        mk = mk_all[:, :m].to(dtype).contiguous()
        mv = mv_all[:, :m].to(dtype).contiguous()
        k, n = mk.shape[0], q.shape[0]
        rq = cmr.read_query(q)
        valid = torch.arange(m, device=dev) < m - TAIL
        mask = cmr.additive_mask(valid)
        planes = None if bf16 else cmr.bank_planes_cuda(mk, mv)
        st = cmr.candidates_cuda(rq, mk, mask, TOP_K, planes)

        def plain_phase(fn):
            return lambda: fn(cmr.read_affinity(rq, mk, mask))

        ms = {"candidates": cuda_ms(lambda: cmr.candidates_cuda(rq, mk, mask, TOP_K, planes)),
              "refine": cuda_ms(lambda: cmr.refine_cuda(rq, mk, mask, st, TOP_K, planes)),
              "readout": cuda_ms(lambda: cmr.readout_cuda(rq, mk, mv, mask, st, planes))}
        plain_ms = {
            "candidates": cuda_ms(plain_phase(lambda a: cmr.candidates_plain(a, TOP_K)), 3, 1),
            "refine": cuda_ms(plain_phase(lambda a: cmr.refine_plain(a, st, TOP_K)), 3, 1),
            "readout": cuda_ms(plain_phase(lambda a: cmr.readout_plain(a, mv, st)), 3, 1)}
        if not bf16:
            ms["hilo_planes"] = cuda_ms(lambda: cmr.bank_planes_cuda(mk, mv))
            plain_ms["hilo_planes"] = cuda_ms(
                lambda: (cmr.hilo_planes_plain(mk), cmr.hilo_planes_plain(mv)), 3, 1)
        bounds = {name: bound_ms(name, k, n, m, dtype) for name in ms}
        rep = {"kernel_ms": ms, "plain_ms": plain_ms,
               "bound_ms": {name: b[0] for name, b in bounds.items()},
               "bound_by": {name: b[1] for name, b in bounds.items()},
               "share_of_bound": {name: bounds[name][0] / ms[name] for name in ms}}
        refined = cmr.refine_cuda(rq, mk, mask, st, TOP_K, planes)
        rep["refine_repeats_bitwise"] = bool(torch.equal(
            cmr.refine_cuda(rq, mk, mask, st, TOP_K, planes), refined))
        check(rep["refine_repeats_bitwise"], f"refine differs between calls at M = {m}")
        rep["splits"] = {
            "candidates": cmr.kernel_splits("candidates", k, n, m, sms),
            "refine": cmr.kernel_splits("refine" if bf16 else "refine_f32", k, n, m, sms),
            "readout": cmr.kernel_splits("readout", k, n, m, sms)}
        if m == TIMING_M[-1]:
            rep.update({
                "kernel_read_ms": cuda_ms(lambda: cmr.memory_read_threshold_cuda(
                    mk, mv, q, TOP_K, valid)),
                "kernel_read_refine1_ms": cuda_ms(lambda: cmr.memory_read_threshold_cuda(
                    mk, mv, q, TOP_K, valid, 1)),
                "plain_read_ms": cuda_ms(lambda: cmr.memory_read_threshold_plain(
                    mk, mv, q, TOP_K, valid), 3, 1),
                "exact_read_ms": cuda_ms(lambda: memory_read(
                    mk, mv, q, top_k=TOP_K, valid=valid, backend="exact"), 3, 1)})
        timing[m] = rep
        del mk, mv
    log(json.dumps({"timing": str(dtype)[6:], "K": K, "N": q.shape[0], "by_M": timing}))
    return timing


def iid_banks(m: int, rng: np.random.RandomState, dev):
    """(K, m, CK) keys, (K, m, CV) values and (N, CK) queries, iid
    gaussian from `rng` (the JAX script's draw order)."""
    return tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
                 for s in ((K, m, CK), (K, m, CV), (N, CK)))


def time_reads(mk, mv, q, valid, tally: LaunchTally) -> Dict[str, float]:
    """CUDA-event ms a read, of the cuda, exact and plain backends (the
    JAX script's pallas, xla_exact and xla_approx timings)."""
    timing = {}
    for backend in ("cuda", "exact", "plain"):
        iters, warmup = (TIMING_ITERS, 3) if backend == "cuda" else (5, 1)
        with tally.window(iters + warmup if backend == "cuda" else 0, mk.dtype):
            timing[backend] = cuda_ms(lambda: memory_read(
                mk, mv, q, top_k=TOP_K, valid=valid, backend=backend), iters, warmup)
    return timing


def full(dev, weights: Optional[str], log: Callable = _log):
    """Full mode: the gated encoder regime at FULL_FRAMES, the iid regime
    and the timings. Returns (reports, timing_ms, tally)."""
    tally = LaunchTally(dev)
    mk, mv, q = encoder_banks(prop_net(weights), FULL_FRAMES, dev)
    m = mk.shape[1]
    valid = torch.arange(m, device=dev) < m - TAIL
    reports = []
    for dtype in (F32, BF16):
        reports.append(compare(mk.to(dtype), mv.to(dtype), q, valid, "encoder",
                               tally, context=True))
        log(json.dumps(reports[-1]))
    rng = np.random.RandomState(0)
    for m2 in IID_M:
        gk, gv, gq = iid_banks(m2, rng, dev)
        reports.append(compare(gk, gv, gq, None, "iid-gaussian", tally, context=True))
        log(json.dumps(reports[-1]))
        del gk, gv, gq
    timing = {}
    if torch.device(dev).type == "cuda":
        timing = time_reads(mk.to(BF16), mv.to(BF16), q, valid, tally)
        for backend, ms in timing.items():
            log(f"timing {backend}: {ms:.3f} ms")
    return reports, timing, tally


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=None,
                    help="propagation .pth (default: random init, seed 0)")
    ap.add_argument("--gate-only", action="store_true",
                    help="bench's gate: encoder banks at M ~21k and ~42k, mean "
                         "error < 1e-3 of the readout scale; no iid regime, no "
                         "timing. A missing --weights file falls back to the "
                         "random init, so an empty weights directory cannot "
                         "skip the gate")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "kernel_check.json"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> Dict:
    args = parse_args(argv)
    dev = require_device(args.device)
    device = device_info(dev)
    _log(json.dumps({"device": device}))
    weights = args.weights
    if args.gate_only and weights and not os.path.exists(weights):
        _log(f"[gate] {weights} missing -> random-init encoder banks")
        weights = None
    if args.gate_only:
        result = gate_only(dev, weights)
        reports, timing, tally = result["reports"], {}, None
    else:
        reports, timing, tally = full(dev, weights)
        hold(reports, 1e-2)
    mean_gate = 1e-3 if args.gate_only else 1e-2
    out = {"reports": reports, "timing_ms": timing, "gate_only": args.gate_only,
           "mean_gate_frac": mean_gate, "weights": weights or "random-init",
           "device": device}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    if tally is not None:
        out["launches"] = tally.check("kernel_check")
        out["reads"] = tally.reads
    _log("KERNEL-CHECK-OK")
    return out


if __name__ == "__main__":
    main()
