"""Compare two versions of mivos_tpu_torch/csrc/memory_read.cu on the card,
in one process. From the repository root:

    PYTHONPATH=. python scripts/torch_kernel_ab.py OLD.cu NEW.cu [--refine-splits S,..]

Builds both sources at once (build.build_library, the flags of build.py)
into mivos_tpu_torch/_build/, then times phase A (candidates kernel and
merge), one refine pass (kernel and merge) and phase B (readout kernel
and merge) on bf16 banks of random keys and values at K = 3, N = 1620
and M = 1620, 11340 and 21060, with the last 800 slots masked and
without a mask, in the order OLD, NEW, NEW, OLD (chip_smoke.cuda_ms: CUDA
events, 20 calls after 3 warm-up calls). Prints one JSON line per shape:
each side's times in ms, whether the two sources gave equal statistics,
refined statistics and readouts, and on how many (object, row) pairs
the refined threshold differs. Each side's refine goes through the
mr_refine* functions its source exports: mr_refine_bf16 and
mr_refine_merge, or the older mr_refine(q_hi + q_lo, ..., bf16_bank=1).
Refine takes the package's number of M ranges, or each of
--refine-splits in turn on both sides. Both sources must export the rest
of the C interface build.py binds. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
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
_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# mr_refine of sources that predate the split-M refine kernel.
_LEGACY_REFINE = [_VP, _VP, _LL, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP]


def build(sources):
    """Compile every source at once; return the loaded libraries."""
    def one(src):
        h = hashlib.sha256(Path(src).read_bytes() + " ".join(NVCC_FLAGS).encode())
        kl = build_library([Path(src)], BUILD_DIR / f"ab_{h.hexdigest()[:16]}.so")
        if "mr_refine_bf16" in kl.missing:
            kl.lib.mr_refine.argtypes = _LEGACY_REFINE
            kl.lib.mr_refine.restype = ctypes.c_int
        other = [name for name in kl.missing if not name.startswith("mr_refine")]
        if other:
            raise SystemExit(f"{src} does not export {other}")
        return kl

    with ThreadPoolExecutor(len(sources)) as pool:
        return list(pool.map(one, sources))


def phases(kl, rq, mk, mv, mask, bufs):
    """The three phase calls of one library on one bank, as closures."""
    lib, m = kl.lib, mk.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    mp = None if mask is None else mask.data_ptr()
    wsc, st, wsr, st2, wa, wsum, out, sc, srf, sr = bufs
    legacy = "mr_refine_bf16" in kl.missing
    q = rq.hi.float() + rq.lo.float() if legacy else None

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    def cand():
        check(lib.mr_candidates_bf16(rq.hi.data_ptr(), rq.lo.data_ptr(), mk.data_ptr(),
                                     mk.stride(0), mp, wsc.data_ptr(), K, N, m, sc,
                                     stream))
        check(lib.mr_candidates_merge(wsc.data_ptr(), st.data_ptr(), K, N, sc, TOP_K,
                                      stream))

    def refine():
        if legacy:
            check(lib.mr_refine(q.data_ptr(), mk.data_ptr(), mk.stride(0), mp,
                                st.data_ptr(), st2.data_ptr(), K, N, m, TOP_K, 1, stream))
            return
        check(lib.mr_refine_bf16(rq.hi.data_ptr(), rq.lo.data_ptr(), mk.data_ptr(),
                                 mk.stride(0), mp, st.data_ptr(), wsr.data_ptr(), K, N,
                                 m, srf, stream))
        check(lib.mr_refine_merge(wsr.data_ptr(), st.data_ptr(), st2.data_ptr(), K, N,
                                  srf, TOP_K, stream))

    def read():
        check(lib.mr_readout_bf16(rq.hi.data_ptr(), rq.lo.data_ptr(), mk.data_ptr(),
                                  mk.stride(0), mv.data_ptr(), mv.stride(0), mp,
                                  st.data_ptr(), wa.data_ptr(), wsum.data_ptr(), K, N,
                                  m, sr, stream))
        check(lib.mr_readout_merge(wa.data_ptr(), wsum.data_ptr(), out.data_ptr(), K, N,
                                   sr, stream))

    return cand, refine, read


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--refine-splits", default="",
                    help="comma-separated numbers of M ranges for refine "
                         "(default: the package's choice)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    libs = build([args.old, args.new])
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(0)
    mk_all = torch.from_numpy(rng.randn(K, M_VALUES[-1], cmr.CK).astype(np.float32)
                              * 0.3).to(dev).bfloat16()
    mv_all = torch.from_numpy(rng.randn(K, M_VALUES[-1], cmr.CV)
                              .astype(np.float32)).to(dev).bfloat16()
    rq = cmr.read_query(torch.from_numpy(rng.randn(N, cmr.CK).astype(np.float32))
                        .to(dev), torch.bfloat16)
    for m in M_VALUES:
        mk, mv = mk_all[:, :m].contiguous(), mv_all[:, :m].contiguous()
        sc, srf, sr = (cmr.kernel_splits(name, K, N, m, sms)
                       for name in ("candidates", "refine", "readout"))
        refine_splits = ([min(int(s), -(-m // cmr.SPLIT_ALIGN))
                          for s in args.refine_splits.split(",")]
                         if args.refine_splits else [srf])
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
                    cand, refine, read = phases(libs[side], rq, mk, mv, mask, bufs)
                    if len(results) < 2 and side == len(results):
                        cand()
                        refine()
                        read()
                        results.append(tuple(bufs[i].clone() for i in (1, 3, 6)))
                    times[side].append({"candidates_ms": cuda_ms(cand, 20, 3),
                                        "refine_ms": cuda_ms(refine, 20, 3),
                                        "readout_ms": cuda_ms(read, 20, 3)})
                (st_old, ref_old, out_old), (st_new, ref_new, out_new) = results
                print(json.dumps({
                    "M": m, "masked": masked, "splits": [sc, srf, sr],
                    "old": times[0], "new": times[1],
                    "equal_stats": bool(torch.equal(st_old, st_new)),
                    "equal_refined_stats": bool(torch.equal(ref_old, ref_new)),
                    "refined_threshold_rows_differ":
                        int((ref_old[:, 0] != ref_new[:, 0]).sum()),
                    "equal_readout": bool(torch.equal(out_old, out_new))}),
                    flush=True)


if __name__ == "__main__":
    main()
