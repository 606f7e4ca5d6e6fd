"""The rule by which the kernel gate (kernel_check.gate_read) holds the
readout kernel to its plain phase, shown on the plain phases alone, on
the CPU.

The kernel and the plain version compute the same affinity in two
roundings, each takes its phase-A threshold by the same bisection, and
the per-kernel check feeds one set of stats to both readouts. Where the
two bisections part at a midpoint that one rounding puts the k-th entry
on and the other one ulp below, the first ends with its threshold at the
entry and the second below it. On the first's threshold the second
rounding drops the entry (pretrained banks: 9e-4 of the readout scale in
the mean over a read, 1.2% in a row, on the card); on the lower of the
two thresholds (`kernel_check.shared_threshold`) both keep it. Each
read is right by its own threshold: the whole reads agreed within 3e-6
of the scale on the same banks.
"""
import numpy as np
import torch

from mivos_tpu_torch import kernel_check
from mivos_tpu_torch.ops.cuda import memory_read as cmr

TOP_K, M = 5, 256   # one entry a bin: the bins' counts are exact


def _stats(aff):
    return cmr.candidates_plain(aff, TOP_K)


def _boundary_affinity():
    """(1, 1, M) affinity whose k-th entry sits exactly on the last
    midpoint the bisection counts it at, and the same with that entry one
    ulp lower (the other rounding)."""
    rng = np.random.RandomState(0)
    aff = np.full(M, -25.0, np.float32) + rng.rand(M).astype(np.float32)
    aff[:TOP_K - 1] = -rng.rand(TOP_K - 1).astype(np.float32) * 0.25
    aff[0] = 0.0                                  # rowmax
    aff[7] = -0.3                                 # the k-th entry
    t = float(_stats(torch.from_numpy(aff)[None, None])[0, 0, 0])
    assert -0.3 - 1e-5 < t <= -0.3
    # Walk the bisection again: the last midpoint it took as `lo` is t.
    aff[7] = t
    a = torch.from_numpy(aff)[None, None]
    b = a.clone()
    b[0, 0, 7] = torch.nextafter(torch.tensor(t), torch.tensor(-1.0))
    return a, b


def test_readouts_agree_on_the_lower_threshold():
    a, b = _boundary_affinity()
    st_a, st_b = _stats(a), _stats(b)
    assert float(st_a[0, 0, 0]) == float(a[0, 0, 7])    # at the entry
    assert float(st_b[0, 0, 0]) < float(b[0, 0, 7])     # below it
    mv = torch.from_numpy(np.random.RandomState(1).randn(1, M, 8).astype(np.float32))

    def gap(stats):
        ra, rb = cmr.readout_plain(a, mv, stats), cmr.readout_plain(b, mv, stats)
        return float((ra - rb).abs().max() / ra.abs().mean())

    assert gap(st_a) > 1e-2           # the b rounding drops the k-th entry
    shared = kernel_check.shared_threshold(st_a, st_b)
    assert float(shared[0, 0, 0]) == float(st_b[0, 0, 0])
    assert torch.equal(shared[:, 1:], st_a[:, 1:])
    assert gap(shared) < 1e-6
    # Each read on its own threshold is right: both keep the entry.
    ra = cmr.readout_plain(a, mv, st_a)
    rb = cmr.readout_plain(b, mv, st_b)
    assert float((ra - rb).abs().max() / ra.abs().mean()) < 1e-6
