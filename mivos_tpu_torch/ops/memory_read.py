"""Space-time memory read (counterpart of mivos_tpu/ops/memory_read.py).

Reference behaviour (model/propagation/prop_net.py:47-108): each query
position's affinity against every memory position is the 128-d dot
product scaled by 1/sqrt(CK); the top-k memory entries are kept,
weighted exp(a - a_max) and normalized, and the 512-d memory values are
read out as their weighted sum.

Backends of `memory_read`:
  'exact'  dense affinity + exact torch.topk (the oracle; counterpart of
           the JAX 'xla_exact').
  'plain'  the CUDA kernel's algorithm as dense PyTorch ops
           (ops/cuda/memory_read.py::memory_read_threshold_plain).
  'cuda'   the hand-written CUDA kernel (CUDA tensors only).
  'auto'   'cuda' for CUDA tensors, 'plain' for CPU tensors.
The kernelized (km) read and top_k=None never reach the kernel: they
weight the dense affinity on every backend, as the JAX dispatcher does
(mivos_tpu/ops/memory_read.py:161-179).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from mivos_tpu_torch.ops.cuda.memory_read import (
    NEG_INF, masked_affinity, memory_read_threshold_cuda,
    memory_read_threshold_plain, scaled_query)


def affinity_matrix(mem_k: torch.Tensor, query_k: torch.Tensor) -> torch.Tensor:
    """(K, M, CK) x (N, CK) -> (K, N, M) scaled dot-product affinity in
    full fp32: top-k selection is sensitive to affinity rounding, so
    this product must never run as a single bf16 or TF32 pass (callers
    comparing against a reference set allow_tf32 = False)."""
    return masked_affinity(scaled_query(query_k), mem_k, None)


def topk_softmax(aff: torch.Tensor, top_k: Optional[int],
                 valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact top-k-filtered softmax over the last (memory) axis of a
    (K, N, M) affinity; valid: optional (M,) bool live-slot mask. Weights
    are exp(a - a_max) over the top-k set, normalized; everything else is
    0 (reference softmax_w_g_top, prop_net.py:47-73)."""
    if valid is not None:
        aff = torch.where(valid[None, None, :], aff,
                          torch.full_like(aff, NEG_INF))
    if top_k is None:
        return torch.softmax(aff, dim=-1)
    # Fewer positions than top_k degrades to a full softmax.
    top_k = min(top_k, aff.shape[-1])
    tv = torch.topk(aff, top_k, dim=-1, sorted=True).values
    vmax, kth = tv[..., :1], tv[..., -1:]
    w = torch.where(aff >= kth, torch.exp(aff - vmax), torch.zeros_like(aff))
    return w / w.sum(dim=-1, keepdim=True)


def gaussian_kernelized_weights(aff: torch.Tensor, h: int, w: int,
                                sigma: float, top_k: int,
                                valid: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Kernelized-memory (KMN-style) weights of a (K, N, M) affinity
    with N = h*w row-major query positions (reference prop_net.py:90-97;
    mivos_tpu/ops/memory_read.py:97-124): each memory position gets a
    Gaussian over query space centred on its best query position
    (torch.argmax, like jnp.argmax, takes the first maximum), multiplied
    into exp(a - a_max); the top_k of that product are kept (>= the
    k-th value) and normalized."""
    if valid is not None:
        aff = torch.where(valid[None, None, :], aff,
                          torch.full_like(aff, NEG_INF))
    best_q = torch.argmax(aff, dim=1)                      # (K, M)
    by, bx = (best_q // w).to(torch.float32), (best_q % w).to(torch.float32)
    pos = torch.arange(h * w, device=aff.device)
    qy, qx = (pos // w).to(torch.float32), (pos % w).to(torch.float32)
    d2 = ((qy[None, :, None] - by[:, None, :]) ** 2
          + (qx[None, :, None] - bx[:, None, :]) ** 2)      # (K, N, M)
    g = torch.exp(-d2 / (2.0 * sigma ** 2))
    xg = torch.exp(aff - aff.amax(dim=-1, keepdim=True)) * g
    kth = torch.topk(xg, top_k, dim=-1, sorted=True).values[..., -1:]
    wgt = torch.where(xg >= kth, xg, torch.zeros_like(xg))
    return wgt / wgt.sum(dim=-1, keepdim=True)


def memory_read(mem_k: torch.Tensor, mem_v: torch.Tensor,
                query_k: torch.Tensor, top_k: Optional[int] = 50,
                valid: Optional[torch.Tensor] = None,
                km: Optional[float] = None,
                query_hw: Optional[Tuple[int, int]] = None,
                backend: str = "auto", n_refine: int = 0) -> torch.Tensor:
    """Full memory read (reference EvalMemoryReader, prop_net.py:75-108).

    mem_k: (K, M, CK) keys, mem_v: (K, M, CV) values (fp32 or bf16),
    query_k: (N, CK) query keys shared across objects, valid: optional
    (M,) bool live-slot mask. km: the kernelized read's sigma (None: the
    top-k read), with query_hw = (h, w), h*w = N. n_refine:
    threshold-refine passes of the kernel algorithm ('plain'/'cuda';
    ignored by 'exact'). top_k=None is a full softmax on every backend.
    Returns the (K, N, CV) fp32 readout.
    """
    if backend == "auto":
        backend = "cuda" if mem_k.is_cuda else "plain"
    if backend not in ("exact", "plain", "cuda"):
        raise ValueError(f"unknown memory-read backend {backend!r}")
    if km is None and top_k is not None and backend != "exact":
        fn = (memory_read_threshold_cuda if backend == "cuda"
              else memory_read_threshold_plain)
        return fn(mem_k, mem_v, query_k, top_k=top_k, valid=valid,
                  n_refine=n_refine)
    aff = affinity_matrix(mem_k, query_k)
    if km is not None:
        if query_hw is None or top_k is None:
            raise ValueError("the km read needs query_hw and top_k")
        wgt = gaussian_kernelized_weights(aff, *query_hw, km, top_k, valid)
    else:
        wgt = topk_softmax(aff, top_k, valid)
    return torch.matmul(wgt.to(mem_v.dtype).to(torch.float32),
                        mem_v.to(torch.float32))


def full_softmax_affinity(mem_k: torch.Tensor,
                          query_k: torch.Tensor) -> torch.Tensor:
    """T=1 full-softmax affinity for the fusion attention read
    (reference AttentionMemory, prop_net.py:110-129): (K, M, CK) x
    (N, CK) -> (K, M, N), softmax over M (the memory axis stays second
    because callers left-multiply by a (1, M) mask row). A (K, N, CK)
    query pairs with the keys per batch entry (the training-time
    reader's per-sample read)."""
    aff = torch.matmul(mem_k.to(torch.float32),
                       scaled_query(query_k).transpose(-1, -2))
    return torch.softmax(aff, dim=1)
