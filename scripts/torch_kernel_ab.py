"""Compare two versions of mivos_tpu_torch/csrc/memory_read.cu on the card,
in one process. From the repository root:

    PYTHONPATH=. python scripts/torch_kernel_ab.py OLD.cu NEW.cu \
        [--banks bf16,fp32] [--refine-splits S,..]

Builds both sources at once (build.build_library, the flags of build.py)
into mivos_tpu_torch/_build/, then times phase A (candidates kernel and
merge), one refine pass (kernel and merge) and phase B (readout kernel
and merge) on banks of random keys and values of each dtype in --banks
at K = 3, N = 1620 and M = 1620, 11340 and 21060, with the last 800
slots masked and without a mask, in the order OLD, NEW, NEW, OLD
(chip_smoke.cuda_ms: CUDA events, 20 calls after 3 warm-up calls).
Prints one JSON line per shape: each side's times in ms, whether the two
sources gave equal statistics, refined statistics and readouts, on how
many (object, row) pairs the refined threshold differs, and the largest
readout difference over the readout scale. On fp32 banks each side also
writes the bf16 planes of keys and values once (mr_hilo_planes, timed
as "planes_ms", as the package makes them once a read), and its three
phases read them. Refine takes the package's number of M ranges, or
each of --refine-splits in turn on both sides. Both sources must export
the functions of the package's C interface (build._SIGNATURES) that the
banks of --banks call (NEEDS); to time an older source against its own
parent, run that checkout's copy of this script. Needs a CUDA card and
nvcc.
"""
from __future__ import annotations

import argparse
import hashlib
import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from chip_smoke import cuda_ms
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.ops.cuda.build import BUILD_DIR, NVCC_FLAGS, build_library

K, N, TOP_K, TAIL = 3, 1620, 50, 800
M_VALUES = (1620, 11340, 21060)
MERGES = ("mr_candidates_merge", "mr_refine_merge", "mr_readout_merge")
# The C functions `phases` calls on banks of each dtype.
NEEDS = {"bf16": ("mr_candidates_bf16", "mr_refine_bf16", "mr_readout_bf16") + MERGES,
         "fp32": ("mr_hilo_planes", "mr_candidates_hilo", "mr_refine_hilo",
                  "mr_readout_hilo") + MERGES}


def build(sources, banks):
    """Compile every source at once; return the loaded libraries."""
    def one(src):
        h = hashlib.sha256(Path(src).read_bytes() + " ".join(NVCC_FLAGS).encode())
        kl = build_library([Path(src)], BUILD_DIR / f"ab_{h.hexdigest()[:16]}.so")
        missing = sorted({name for bank in banks for name in NEEDS[bank]}
                         & set(kl.missing))
        if missing:
            raise SystemExit(f"{src} does not export {missing}")
        return kl

    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(one, sources))


def phases(lib, rq, mk, mv, mask, bufs, planes):
    """The calls of one library on one bank, as closures: the planes of an
    fp32 bank (None on bf16 banks), phase A, one refine pass and phase B,
    each kernel with its merge."""
    m, f32 = mk.shape[1], mk.dtype == torch.float32
    stream = torch.cuda.current_stream().cuda_stream
    mp = None if mask is None else mask.data_ptr()
    wsc, st, wsr, st2, wa, wsum, out, sc, srf, sr = bufs
    qh, ql = rq.hi.data_ptr(), rq.lo.data_ptr()
    kh, kl, vh, vl = (p.data_ptr() for p in planes)

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    def split():
        for x, hi, lo in ((mk, kh, kl), (mv, vh, vl)):
            check(lib.mr_hilo_planes(x.data_ptr(), x.stride(0), *x.shape, hi, lo, stream))

    def cand():
        if f32:
            check(lib.mr_candidates_hilo(qh, ql, kh, kl, mp, wsc.data_ptr(), K, N, m, sc,
                                         stream))
        else:
            check(lib.mr_candidates_bf16(qh, ql, mk.data_ptr(), mk.stride(0), mp,
                                         wsc.data_ptr(), K, N, m, sc, stream))
        check(lib.mr_candidates_merge(wsc.data_ptr(), st.data_ptr(), K, N, sc, TOP_K,
                                      stream))

    def refine():
        if f32:
            check(lib.mr_refine_hilo(qh, ql, kh, kl, mp, st.data_ptr(), wsr.data_ptr(), K,
                                     N, m, srf, stream))
        else:
            check(lib.mr_refine_bf16(qh, ql, mk.data_ptr(), mk.stride(0), mp,
                                     st.data_ptr(), wsr.data_ptr(), K, N, m, srf, stream))
        check(lib.mr_refine_merge(wsr.data_ptr(), st.data_ptr(), st2.data_ptr(), K, N,
                                  srf, TOP_K, stream))

    def read():
        if f32:
            check(lib.mr_readout_hilo(qh, ql, kh, kl, vh, vl, mp, st.data_ptr(),
                                      wa.data_ptr(), wsum.data_ptr(), K, N, m, sr, stream))
        else:
            check(lib.mr_readout_bf16(qh, ql, mk.data_ptr(), mk.stride(0), mv.data_ptr(),
                                      mv.stride(0), mp, st.data_ptr(), wa.data_ptr(),
                                      wsum.data_ptr(), K, N, m, sr, stream))
        check(lib.mr_readout_merge(wa.data_ptr(), wsum.data_ptr(), out.data_ptr(), K, N,
                                   sr, stream))

    return (split if f32 else None), cand, refine, read


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--banks", default="bf16,fp32",
                    help="comma-separated bank dtypes to time: bf16, fp32")
    ap.add_argument("--refine-splits", default="",
                    help="comma-separated numbers of M ranges for refine "
                         "(default: the package's choice)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    banks = args.banks.split(",")
    libs = build([args.old, args.new], banks)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for bank in banks:
        ab_bank(libs, dev, sms, {"bf16": torch.bfloat16, "fp32": torch.float32}[bank],
                args.refine_splits)


def ab_bank(libs, dev, sms, dtype, refine_splits_arg):
    """Time and compare both libraries on random banks of `dtype`."""
    rng = np.random.RandomState(0)
    mk_all = torch.from_numpy(rng.randn(K, M_VALUES[-1], cmr.CK).astype(np.float32)
                              * 0.3).to(dev).to(dtype)
    mv_all = torch.from_numpy(rng.randn(K, M_VALUES[-1], cmr.CV)
                              .astype(np.float32)).to(dev).to(dtype)
    query = torch.from_numpy(rng.randn(N, cmr.CK).astype(np.float32)).to(dev)
    rq = cmr.read_query(query)
    for m in M_VALUES:
        mk, mv = mk_all[:, :m].contiguous(), mv_all[:, :m].contiguous()
        planes = tuple(torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
                       for x in (mk, mk, mv, mv))
        sc, srf, sr = (cmr.kernel_splits(name, K, N, m, sms) for name in (
            "candidates", "refine" if dtype == torch.bfloat16 else "refine_f32", "readout"))
        refine_splits = ([min(int(s), -(-m // cmr.SPLIT_ALIGN))
                          for s in refine_splits_arg.split(",")]
                         if refine_splits_arg else [srf])
        for masked in (True, False):
            mask = (cmr.additive_mask(torch.arange(m, device=dev) < m - TAIL)
                    if masked else None)
            for srf in refine_splits:
                bufs = (torch.empty((sc, K, N, 4, cmr.C_BINS), device=dev),
                        torch.empty((K, 3, N), device=dev),
                        torch.empty((srf, K, N, cmr.N_EDGES), dtype=torch.int32,
                                    device=dev),
                        torch.empty((K, 3, N), device=dev),
                        torch.empty((sr, K, N, cmr.CV), device=dev),
                        torch.empty((sr, K, N), device=dev),
                        torch.empty((K, N, cmr.CV), device=dev), sc, srf, sr)
                times, results = ([], []), []
                for side in (0, 1, 1, 0):
                    split, cand, refine, read = phases(libs[side].lib, rq, mk, mv, mask,
                                                       bufs, planes)
                    if len(results) < 2 and side == len(results):
                        for fn in (split, cand, refine, read):
                            if fn is not None:
                                fn()
                        results.append(tuple(bufs[i].clone() for i in (1, 3, 6)))
                    ms = {"candidates_ms": cuda_ms(cand, 20, 3),
                          "refine_ms": cuda_ms(refine, 20, 3),
                          "readout_ms": cuda_ms(read, 20, 3)}
                    if split is not None:
                        ms["planes_ms"] = cuda_ms(split, 20, 3)
                    times[side].append(ms)
                (st_old, ref_old, out_old), (st_new, ref_new, out_new) = results
                print(json.dumps({
                    "bank": str(dtype)[6:], "M": m, "masked": masked,
                    "splits": [sc, srf, sr], "old": times[0], "new": times[1],
                    "equal_stats": bool(torch.equal(st_old, st_new)),
                    "equal_refined_stats": bool(torch.equal(ref_old, ref_new)),
                    "refined_threshold_rows_differ":
                        int((ref_old[:, 0] != ref_new[:, 0]).sum()),
                    "equal_readout": bool(torch.equal(out_old, out_new)),
                    "readout_max_diff_over_scale":
                        ((out_old - out_new).abs().max() / out_old.abs().mean()).item()}),
                    flush=True)


if __name__ == "__main__":
    main()
