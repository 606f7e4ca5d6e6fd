"""Multi-object soft aggregation (counterpart of mivos_tpu/ops/aggregate.py;
reference model/aggregate.py)."""
from __future__ import annotations

import torch

_EPS = 1e-7


def _logit(p: torch.Tensor) -> torch.Tensor:
    p = p.clamp(_EPS, 1.0 - _EPS)
    return torch.log(p / (1.0 - p))


def aggregate_wbg(prob: torch.Tensor, keep_bg: bool = False,
                  hard: bool = False) -> torch.Tensor:
    """Aggregate (K, ...) per-object foreground probabilities with a
    derived background prod(1 - p_k) into a (K+1)-way softmax over
    logits. Returns (K+1, ...) if keep_bg else (K, ...). `hard` scales
    the logits by 1000 (reference model/aggregate.py:30-32)."""
    bg = torch.prod(1.0 - prob, dim=0, keepdim=True)
    logits = _logit(torch.cat([bg, prob], dim=0))
    if hard:
        logits = logits * 1000.0
    out = torch.softmax(logits, dim=0)
    return out if keep_bg else out[1:]


def aggregate_sbg(prob: torch.Tensor, keep_bg: bool = False,
                  hard: bool = False) -> torch.Tensor:
    """As aggregate_wbg with a fixed background probability of 0.5
    (reference model/aggregate.py:4-20)."""
    logits = _logit(torch.cat([torch.full_like(prob[:1], 0.5), prob], dim=0))
    if hard:
        logits = logits * 1000.0
    out = torch.softmax(logits, dim=0)
    return out if keep_bg else out[1:]


def aggregate_wbg_channel(prob: torch.Tensor):
    """Batched aggregate over the class axis of NCHW training batches
    (reference model/aggregate.py:39-53; mivos_tpu/ops/aggregate.py::
    aggregate_wbg_last on its class-last layout): prob (B, K, H, W)
    foreground probabilities -> (logits, softmax), each (B, K+1, H, W)
    with the derived background first."""
    bg = torch.prod(1.0 - prob, dim=1, keepdim=True)
    logits = _logit(torch.cat([bg, prob], dim=1))
    return logits, torch.softmax(logits, dim=1)
