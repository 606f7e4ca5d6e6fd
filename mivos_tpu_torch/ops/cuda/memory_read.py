"""Fused top-k memory read: CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of mivos_tpu/ops/pallas/memory_read.py::memory_read_pallas,
same contract: mem_k (K, M, 128) and mem_v (K, M, 512) in fp32 or bf16,
query_k (N, 128), optional (M,) bool `valid`, `n_refine` refine passes;
returns the (K, N, 512) fp32 readout.

The algorithm (three phases, kernels in csrc/memory_read.cu):
  A  per row, the top-2 affinities in each of 256 bins under two
     partitions of the memory axis -- bin1(j) = j mod 256 and
     bin2(j) = (j mod 256 + 85 * ((j mod 1024) div 256)) mod 256, keyed on
     the TPU tiling's 1024 -- then 22 fp32 bisection steps on
     [rowmax - 30, rowmax] for the largest t with
     max(count1(t), count2(t)) >= top_k. Counts never overcount, so t is
     a lower bound on the k-th affinity and the kept set a superset of
     the exact top-k. With top_k >= the live count no midpoint passes and
     t = rowmax - 30: a full softmax up to weights below e^-30.
  refine (x n_refine)  exact counts at 7 edges over [t, t + min(ub-t, 0.15)]
     raise t to the highest edge still holding >= top_k entries.
  B  w = (a >= t) ? exp(a - rowmax) : 0; readout = (w as the value dtype) . V
     / sum(w).
Phase statistics travel as one (K, 3, N) fp32 tensor: threshold, row
max, refine upper bound.

The affinity is the JAX kernel's split (`_affinity`) of the scaled query
q: q_hi = bf16(q), q_lo = bf16(q - q_hi). On bf16 banks a = q_hi.k +
q_lo.k, the product of q_hi + q_lo (exact in fp32) with the keys up to
fp32 rounding. On fp32 banks the keys split the same way, k_hi =
bf16(k), k_lo = bf16(k - k_hi), and a = q_hi.k_hi + q_hi.k_lo + q_lo.k_hi
(the q_lo.k_lo term dropped, ~1e-5 relative). The kernels of all three
phases run it as bf16 passes into one fp32 accumulator on the tensor
cores, so that all phases rank the same affinities; the plain version as
fp32 products summed (as `_affinity` sums its passes). `read_query`
makes the query of one read once. On fp32 banks phase B's w.V is
fp32-accurate from three bf16 passes, w_hi.v_hi + w_lo.v_hi +
w_hi.v_lo, against the plain version's fp32 product. The fp32-bank
kernels read the bf16 planes of the keys and values (`BankPlanes`),
which `memory_read_threshold_cuda` has `bank_planes_cuda` write once a
read.

The kernels of all three phases split the memory axis into S ranges cut
at multiples of 256 keys (`split_count`), write per-range partials to a
workspace and merge them in a second kernel, in a fixed order of
ranges.

Each phase has a kernel wrapper (`*_cuda`: CUDA tensors only, raises on
anything else, counts its launches) and a plain version (`*_plain`:
dense PyTorch ops on the materialized (K, N, M) affinity; the CPU path,
and the reference the kernels are checked against on the card).
`memory_read_threshold_cuda` / `_plain` chain the three phases.
"""
from __future__ import annotations

import functools
import math
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30
THRESH_RANGE = 30.0
BISECT_ITERS = 22
C_BINS = 256
TPU_TM = 1024     # tile the second partition's roll is keyed on
ROLL = 85
N_EDGES = 7
REFINE_CAP = 0.15
CK, CV = 128, 512
SPLIT_ALIGN = C_BINS   # M ranges of the split-M kernels start at multiples of this
# Per split-M kernel (csrc/memory_read.cu; both bank dtypes of phases A and
# B, refine per bank dtype: "refine" on bf16 banks, "refine_f32"): query
# rows per block, blocks an SM holds at once (its shared memory), most M
# ranges.
BLOCK_ROWS = {"candidates": 32, "refine": 64, "refine_f32": 64, "readout": 64}
SM_BLOCKS = {"candidates": 1, "refine": 3, "refine_f32": 3, "readout": 1}
MAX_SPLITS = {"candidates": 4, "refine": 8, "refine_f32": 8, "readout": 8}
FULL_WAVES = 0.85      # split_count's target share of full waves

# Launches of each kernel since the last reset: a wrapper adds one
# exactly where it launches its kernel; the plain versions never count.
# Sessions on several threads (the server's handlers) launch at once, so
# every read or write of the counts holds _LAUNCHES_LOCK.
_LAUNCHES_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {
    "candidates_bf16": 0, "candidates_f32": 0, "candidates_merge": 0,
    "refine_bf16": 0, "refine_f32": 0, "refine_merge": 0,
    "readout_bf16": 0, "readout_f32": 0, "readout_merge": 0, "hilo_planes": 0}


def launches_per_read(bank_dtype: torch.dtype, n_refine: int) -> Dict[str, int]:
    """The launches of each counter one `memory_read_threshold_cuda` call
    makes on a bank of `bank_dtype`: phases A and B with their merges
    once, refine with its merge n_refine times; on fp32 banks the planes
    kernel once for the keys and once for the values."""
    if bank_dtype == torch.bfloat16:
        per = {"candidates_bf16": 1, "candidates_merge": 1,
               "refine_bf16": n_refine, "refine_merge": n_refine,
               "readout_bf16": 1, "readout_merge": 1}
    else:
        per = {"hilo_planes": 2, "candidates_f32": 1, "candidates_merge": 1,
               "refine_f32": n_refine, "refine_merge": n_refine,
               "readout_f32": 1, "readout_merge": 1}
    return {name: per.get(name, 0) for name in _LAUNCHES}


def launch_counts() -> Dict[str, int]:
    with _LAUNCHES_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _LAUNCHES_LOCK:
        for name in _LAUNCHES:
            _LAUNCHES[name] = 0


def scaled_query(query_k: torch.Tensor) -> torch.Tensor:
    """(N, CK) query keys -> fp32, scaled by 1/sqrt(CK), contiguous."""
    return (query_k.to(torch.float32)
            * (1.0 / math.sqrt(query_k.shape[-1]))).contiguous()


def hilo_planes_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 tensor -> (hi, lo) bf16, `_affinity`'s split: hi = bf16(x),
    lo = bf16(x - hi); hi + lo is exact in fp32 and within about 2^-17 of
    x, relative."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi.contiguous(), lo.contiguous()


class ReadQuery(NamedTuple):
    """The query of one read, the split `hi`, `lo` (each (N, CK) bf16) of
    the scaled fp32 query, on banks of either dtype."""
    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def rows(self) -> int:
        return self.hi.shape[0]


def read_query(query_k: torch.Tensor) -> ReadQuery:
    return ReadQuery(*hilo_planes_plain(scaled_query(query_k)))


def additive_mask(valid: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(M,) bool live mask -> (M,) fp32 additive mask (0 / -1e30)."""
    if valid is None:
        return None
    zero = torch.zeros((), dtype=torch.float32, device=valid.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF)).contiguous()


def split_count(base_blocks: int, m: int, slots: int, max_splits: int) -> int:
    """Number S of M ranges (each at least one 256-key slice) for a grid
    of `base_blocks` (object, row tile) blocks over `slots` block slots
    (SMs times the blocks one SM holds): the smallest S whose waves are
    FULL_WAVES full, else the S with the fullest waves."""
    best, best_fill = 1, 0.0
    for s in range(1, min(-(-m // SPLIT_ALIGN), max_splits) + 1):
        blocks = base_blocks * s
        fill = blocks / (-(-blocks // slots) * slots)
        if fill >= FULL_WAVES:
            return s
        if fill > best_fill:
            best, best_fill = s, fill
    return best


# ----------------------------------------------------------------------
# Plain versions
# ----------------------------------------------------------------------

def masked_affinity(q: torch.Tensor, mem_k: torch.Tensor,
                    mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(K, N, M) fp32 affinity of the scaled query plus the additive mask."""
    aff = torch.matmul(q, mem_k.to(torch.float32).transpose(1, 2))
    return aff if mask is None else aff + mask


def read_affinity(rq: ReadQuery, mem_k: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(K, N, M) fp32 affinity of one read plus the additive mask:
    q_hi.k + q_lo.k for bf16 banks, q_hi.k_hi + q_hi.k_lo + q_lo.k_hi
    for fp32 banks (k_hi, k_lo = hilo_planes_plain(k))."""
    hi, lo = rq.hi.to(torch.float32), rq.lo.to(torch.float32)
    if mem_k.dtype == torch.bfloat16:
        aff = (masked_affinity(hi, mem_k, None)
               + masked_affinity(lo, mem_k, None))
    else:
        k_hi, k_lo = hilo_planes_plain(mem_k)
        aff = (masked_affinity(hi, k_hi, None) + masked_affinity(hi, k_lo, None)
               + masked_affinity(lo, k_hi, None))
    return aff if mask is None else aff + mask


def _top2_bins(aff: torch.Tensor):
    """Per-row, per-bin top-2 values under both partitions:
    (K, N, 2, C_BINS) pairs (a >= b) for partition 1 and 2."""
    k, n, m = aff.shape
    m_pad = -(-m // TPU_TM) * TPU_TM
    a = F.pad(aff, (0, m_pad - m), value=NEG_INF)
    slices = m_pad // C_BINS
    p1 = a.view(k, n, slices, C_BINS).topk(2, dim=2).values
    s = torch.arange(slices, device=aff.device)
    roll = (ROLL * (s % (TPU_TM // C_BINS))) % C_BINS
    src = (torch.arange(C_BINS, device=aff.device)[None] - roll[:, None]) % C_BINS
    idx = (s[:, None] * C_BINS + src).reshape(-1)
    p2 = a[..., idx].view(k, n, slices, C_BINS).topk(2, dim=2).values
    return p1, p2


def candidates_plain(aff: torch.Tensor, top_k: int) -> torch.Tensor:
    """Phase A on a masked affinity -> (K, 3, N) stats."""
    p1, p2 = _top2_bins(aff)
    rowmax = torch.maximum(p1[:, :, 0].amax(-1), p2[:, :, 0].amax(-1))
    lo, hi = rowmax - THRESH_RANGE, rowmax
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        m4 = mid[..., None, None]
        n1 = (p1 >= m4).sum(dim=(2, 3))
        n2 = (p2 >= m4).sum(dim=(2, 3))
        ok = torch.maximum(n1, n2) >= top_k
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.stack([lo, rowmax, rowmax], dim=1)


def _refine_delta(th: torch.Tensor, ub: torch.Tensor) -> torch.Tensor:
    return ((ub - th).clamp(max=REFINE_CAP) / float(N_EDGES)).clamp(min=1e-7)


def refine_counts_plain(aff: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Refine's counts on a masked affinity (K, N, M), or on any range of
    its memory axis: (K, N, N_EDGES) int64, the entries reaching each edge
    th + (i+1) * delta over [th, th + min(ub - th, REFINE_CAP)]. Counts of
    disjoint ranges add up to the counts of their union."""
    th, _, ub = stats.unbind(1)
    delta = _refine_delta(th, ub)
    return torch.stack(
        [(aff >= (th + float(i + 1) * delta)[..., None]).sum(-1)
         for i in range(N_EDGES)], dim=-1)


def refine_update_plain(counts: torch.Tensor, stats: torch.Tensor,
                        top_k: int) -> torch.Tensor:
    """Refine's counts -> new (K, 3, N) stats: th rises to the highest edge
    still counting >= top_k entries, ub falls to the next edge up."""
    th, mx, ub = stats.unbind(1)
    delta = _refine_delta(th, ub)
    nok = (counts >= top_k).sum(-1).to(torch.float32)
    th_new = th + nok * delta
    ub_new = torch.where(nok < float(N_EDGES),
                         torch.minimum(ub, th_new + delta), ub)
    return torch.stack([th_new, mx, ub_new], dim=1)


def refine_plain(aff: torch.Tensor, stats: torch.Tensor,
                 top_k: int) -> torch.Tensor:
    """One refine pass: exact counts at N_EDGES edges above the threshold."""
    return refine_update_plain(refine_counts_plain(aff, stats), stats, top_k)


def readout_plain(aff: torch.Tensor, mem_v: torch.Tensor,
                  stats: torch.Tensor) -> torch.Tensor:
    """Phase B: thresholded exp weights, (w as the value dtype) . V / sum(w)."""
    th, mx = stats[:, 0, :, None], stats[:, 1, :, None]
    w = torch.where(aff >= th, torch.exp(aff - mx),
                    torch.zeros((), device=aff.device))
    num = torch.matmul(w.to(mem_v.dtype).to(torch.float32),
                       mem_v.to(torch.float32))
    return num / w.sum(dim=-1, keepdim=True)


def memory_read_threshold_plain(mem_k: torch.Tensor, mem_v: torch.Tensor,
                                query_k: torch.Tensor, top_k: int = 50,
                                valid: Optional[torch.Tensor] = None,
                                n_refine: int = 0) -> torch.Tensor:
    """The kernels' algorithm as dense PyTorch ops."""
    aff = read_affinity(read_query(query_k), mem_k, additive_mask(valid))
    stats = candidates_plain(aff, top_k)
    for _ in range(n_refine):
        stats = refine_plain(aff, stats, top_k)
    return readout_plain(aff, mem_v, stats)


# ----------------------------------------------------------------------
# Kernel wrappers
# ----------------------------------------------------------------------

def _check_bank(name: str, x: torch.Tensor, k: int, m: int, c: int) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name} must be float32 or bfloat16, got {x.dtype}")
    if tuple(x.shape) != (k, m, c):
        raise ValueError(f"{name} must have shape {(k, m, c)}, got "
                         f"{tuple(x.shape)}")
    # Rows contiguous; the object axis may stride over a larger buffer
    # (a bank's live prefix). Rows load as 16-byte vectors.
    if x.stride(2) != 1 or x.stride(1) != c:
        raise ValueError(f"{name} rows must be contiguous, strides "
                         f"{x.stride()}")
    if (x.stride(0) * x.element_size()) % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned per object")
    if k > 65535:  # the object axis is a grid dimension
        raise ValueError(f"{name} has too many objects: {tuple(x.shape)}")


def _check_dense(name: str, x: Optional[torch.Tensor], shape, device,
                 dtype=torch.float32) -> None:
    if x is None:
        return
    if (x.device != device or x.dtype != dtype
            or tuple(x.shape) != tuple(shape) or not x.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} {tuple(shape)} "
                         f"tensor on {device}, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")


def _common(rq: ReadQuery, mem_k: torch.Tensor, mask, top_k: int):
    k, m = mem_k.shape[:2]
    _check_bank("mem_k", mem_k, k, m, CK)
    n = rq.rows
    _check_dense("mask", mask, (m,), mem_k.device)
    _check_dense("q_hi", rq.hi, (n, CK), mem_k.device, torch.bfloat16)
    _check_dense("q_lo", rq.lo, (n, CK), mem_k.device, torch.bfloat16)
    if m < 1 or n < 1 or top_k < 1:
        raise ValueError(f"need M, N, top_k >= 1 (M={m}, N={n}, "
                         f"top_k={top_k})")
    return k, n, m


def _launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    with _LAUNCHES_LOCK:
        _LAUNCHES[name] += 1


def _lib():
    from mivos_tpu_torch.ops.cuda.build import load_library

    return load_library().lib


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def range_blocks(kernel: str, k: int, n: int) -> int:
    """Blocks of one M range of the split-M `kernel` ("candidates",
    "refine", "refine_f32" or "readout") for K objects and N query rows."""
    return k * -(-n // BLOCK_ROWS[kernel])


def kernel_splits(kernel: str, k: int, n: int, m: int, sms: int) -> int:
    """The number of M ranges the split-M `kernel` takes on a card of
    `sms` SMs."""
    return split_count(range_blocks(kernel, k, n), m, sms * SM_BLOCKS[kernel],
                       MAX_SPLITS[kernel])


def hilo_planes_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 planes (hi, lo) of an fp32 bank (K, M, C), rows contiguous:
    each (K, M, C) contiguous, equal to hilo_planes_plain(x)."""
    if not x.is_cuda or x.dtype != torch.float32 or x.ndim != 3 or x.shape[2] % 4:
        raise ValueError(f"hilo_planes_cuda takes a CUDA float32 (K, M, C) bank "
                         f"with C % 4 == 0, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    _check_bank("bank", x, *x.shape)
    hi = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(x.device):
        _launch("hilo_planes", _lib().mr_hilo_planes(
            x.data_ptr(), x.stride(0), *x.shape, hi.data_ptr(), lo.data_ptr(),
            _stream(x.device)))
    return hi, lo


class BankPlanes(NamedTuple):
    """The bf16 planes of an fp32 bank's keys and values (each (K, M, C)
    contiguous, hilo_planes_plain's split): what the fp32-bank kernels
    read (refine and phase A the keys'), made once a read by
    `bank_planes_cuda`."""
    k_hi: torch.Tensor
    k_lo: torch.Tensor
    v_hi: torch.Tensor
    v_lo: torch.Tensor


def bank_planes_cuda(mem_k: torch.Tensor, mem_v: torch.Tensor) -> BankPlanes:
    return BankPlanes(*hilo_planes_cuda(mem_k), *hilo_planes_cuda(mem_v))


def _check_planes(planes: Optional[BankPlanes], mem_k: torch.Tensor,
                  with_values: bool) -> BankPlanes:
    if planes is None:
        raise ValueError("fp32 banks need their bf16 planes (bank_planes_cuda)")
    k, m = mem_k.shape[:2]
    names = ("k_hi", "k_lo") + (("v_hi", "v_lo") if with_values else ())
    for name in names:
        c = CK if name[0] == "k" else CV
        _check_dense(name, getattr(planes, name), (k, m, c), mem_k.device,
                     torch.bfloat16)
    return planes


def candidates_cuda(rq: ReadQuery, mem_k: torch.Tensor,
                    mask: Optional[torch.Tensor], top_k: int,
                    planes: Optional[BankPlanes] = None) -> torch.Tensor:
    """Phase A: the read's query, keys, additive mask (M,) or None ->
    (K, 3, N) stats. Launches the split-M kernel of the bank's dtype (on
    fp32 banks it reads the keys' `planes`) and the merge."""
    k, n, m = _common(rq, mem_k, mask, top_k)
    dev = mem_k.device
    stats = torch.empty((k, 3, n), dtype=torch.float32, device=dev)
    splits = kernel_splits("candidates", k, n, m, _sm_count(dev))
    ws = torch.empty((splits, k, n, 4, C_BINS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if mem_k.dtype == torch.bfloat16:
            _launch("candidates_bf16", _lib().mr_candidates_bf16(
                rq.hi.data_ptr(), rq.lo.data_ptr(), mem_k.data_ptr(),
                mem_k.stride(0), _ptr(mask), ws.data_ptr(), k, n, m, splits,
                _stream(dev)))
        else:
            p = _check_planes(planes, mem_k, with_values=False)
            _launch("candidates_f32", _lib().mr_candidates_hilo(
                rq.hi.data_ptr(), rq.lo.data_ptr(), p.k_hi.data_ptr(),
                p.k_lo.data_ptr(), _ptr(mask), ws.data_ptr(), k, n, m, splits,
                _stream(dev)))
        _launch("candidates_merge", _lib().mr_candidates_merge(
            ws.data_ptr(), stats.data_ptr(), k, n, splits, top_k, _stream(dev)))
    return stats


def refine_cuda(rq: ReadQuery, mem_k: torch.Tensor,
                mask: Optional[torch.Tensor], stats: torch.Tensor,
                top_k: int, planes: Optional[BankPlanes] = None) -> torch.Tensor:
    """One refine pass: (K, 3, N) stats -> new (K, 3, N) stats. Launches
    the split-M counting kernel of the bank's dtype (on fp32 banks it
    reads the keys' `planes`) and the merge."""
    k, n, m = _common(rq, mem_k, mask, top_k)
    dev = mem_k.device
    _check_dense("stats", stats, (k, 3, n), dev)
    bf16 = mem_k.dtype == torch.bfloat16
    p = None if bf16 else _check_planes(planes, mem_k, with_values=False)
    out = torch.empty_like(stats)
    splits = kernel_splits("refine" if bf16 else "refine_f32", k, n, m, _sm_count(dev))
    ws = torch.empty((splits, k, n, N_EDGES), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        if bf16:
            _launch("refine_bf16", _lib().mr_refine_bf16(
                rq.hi.data_ptr(), rq.lo.data_ptr(), mem_k.data_ptr(),
                mem_k.stride(0), _ptr(mask), stats.data_ptr(), ws.data_ptr(), k,
                n, m, splits, _stream(dev)))
        else:
            _launch("refine_f32", _lib().mr_refine_hilo(
                rq.hi.data_ptr(), rq.lo.data_ptr(), p.k_hi.data_ptr(),
                p.k_lo.data_ptr(), _ptr(mask), stats.data_ptr(), ws.data_ptr(), k,
                n, m, splits, _stream(dev)))
        _launch("refine_merge", _lib().mr_refine_merge(
            ws.data_ptr(), stats.data_ptr(), out.data_ptr(), k, n, splits,
            top_k, _stream(dev)))
    return out


def readout_cuda(rq: ReadQuery, mem_k: torch.Tensor, mem_v: torch.Tensor,
                 mask: Optional[torch.Tensor], stats: torch.Tensor,
                 planes: Optional[BankPlanes] = None) -> torch.Tensor:
    """Phase B -> (K, N, 512) fp32 readout. Launches the split-M kernel of
    the bank's dtype (on fp32 banks it reads the `planes` of keys and
    values) and the merge."""
    k, n, m = _common(rq, mem_k, mask, 1)
    _check_bank("mem_v", mem_v, k, m, CV)
    if mem_v.dtype != mem_k.dtype:
        raise ValueError(f"mem_k/mem_v dtypes differ: {mem_k.dtype} vs "
                         f"{mem_v.dtype}")
    dev = mem_k.device
    _check_dense("stats", stats, (k, 3, n), dev)
    out = torch.empty((k, n, CV), dtype=torch.float32, device=dev)
    splits = kernel_splits("readout", k, n, m, _sm_count(dev))
    ws_acc = torch.empty((splits, k, n, CV), dtype=torch.float32, device=dev)
    ws_sum = torch.empty((splits, k, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        if mem_k.dtype == torch.bfloat16:
            _launch("readout_bf16", _lib().mr_readout_bf16(
                rq.hi.data_ptr(), rq.lo.data_ptr(), mem_k.data_ptr(),
                mem_k.stride(0), mem_v.data_ptr(), mem_v.stride(0), _ptr(mask),
                stats.data_ptr(), ws_acc.data_ptr(), ws_sum.data_ptr(), k, n, m,
                splits, _stream(dev)))
        else:
            p = _check_planes(planes, mem_k, with_values=True)
            _launch("readout_f32", _lib().mr_readout_hilo(
                rq.hi.data_ptr(), rq.lo.data_ptr(), p.k_hi.data_ptr(),
                p.k_lo.data_ptr(), p.v_hi.data_ptr(), p.v_lo.data_ptr(), _ptr(mask),
                stats.data_ptr(), ws_acc.data_ptr(), ws_sum.data_ptr(), k, n, m,
                splits, _stream(dev)))
        _launch("readout_merge", _lib().mr_readout_merge(
            ws_acc.data_ptr(), ws_sum.data_ptr(), out.data_ptr(), k, n, splits,
            _stream(dev)))
    return out


def memory_read_threshold_cuda(mem_k: torch.Tensor, mem_v: torch.Tensor,
                               query_k: torch.Tensor, top_k: int = 50,
                               valid: Optional[torch.Tensor] = None,
                               n_refine: int = 0) -> torch.Tensor:
    """Launch the phase kernels on the current stream (no
    synchronisation), on fp32 banks after the bank's bf16 planes, which
    all phases share. Raises on CPU tensors, unsupported dtypes,
    shapes or layouts, a missing nvcc, or a failed launch."""
    if not (mem_k.is_cuda and query_k.is_cuda):
        raise ValueError("memory_read_threshold_cuda takes CUDA tensors")
    if query_k.shape[-1] != CK or query_k.ndim != 2:
        raise ValueError(f"query_k must be (N, {CK}), got {tuple(query_k.shape)}")
    if n_refine < 0:
        raise ValueError(f"n_refine must be >= 0, got {n_refine}")
    rq = read_query(query_k)
    mask = None if valid is None else additive_mask(valid.to(mem_k.device))
    planes = None if mem_k.dtype == torch.bfloat16 else bank_planes_cuda(mem_k, mem_v)
    stats = candidates_cuda(rq, mem_k, mask, top_k, planes)
    for _ in range(n_refine):
        stats = refine_cuda(rq, mem_k, mask, stats, top_k, planes)
    return readout_cuda(rq, mem_k, mem_v, mask, stats, planes)
