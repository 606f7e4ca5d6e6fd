"""Accuracy envelope of the fast path against the exact path (counterpart
of scripts/accuracy_envelope.py).

One two-round interactive session (interactions on frames 0 and T-1, the
second pass fused) at 480x854, K = 3, 30 frames, run twice:

  fast   bf16 towers, bf16 FusionNet, the kernel read (`auto`: the CUDA
         kernels on the card, their plain version on the CPU)
  exact  fp32 towers with TF32 off, fp32 FusionNet, the `exact` read
         (dense affinity and torch.topk)

from one fp32 weight set. Reports label agreement, agreement where the
exact session decides by more than 1e-3 and 1e-2, the share of such
pixels, and the probability error (median, 99th percentile, max); then
gates as JAX does: margin-conditioned agreement > 0.995 and max
probability error < 0.05 (and, with --gate-frac, a least share of
decided pixels).

With --weights (a propagation .pth, `pretrain_synthetic`'s) the inputs
come from the distribution the net was trained on
(`make_trained_session_inputs`: `synthetic_sequence`, seed 11), so
predictions are peaked; without it, a random init (seed 0) on drifting
textures (`make_session_inputs`). --fusion-weights: a FusionNet .pth
(`train_fusion_synthetic`'s); else a random init (seed 1). Both
sessions share it either way.

The knobs --fast-towers-fp32, --fast-fusion-fp32 and --fast-read-refine N
remove one fast-path approximation at a time; `envelope_diagnose`
compares their dumps. The raw arrays (labels and probabilities of both
sessions) are written before the statistics, to
<dump-dir>/envelope_arrays<tag>.npz.

Usage: python -m mivos_tpu_torch.accuracy_envelope [--weights prop.pth]
    [--fusion-weights fusion.pth] [--fast-fusion-fp32] [--fast-towers-fp32]
    [--fast-read-refine N] [--tag T] [--dump-dir DIR] [--gate-frac F]
    [--frames T] [--hw H W] [--objects K] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from mivos_tpu_torch.checkpoint.pth import load_reference_pth
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork

T, H, W, K = 30, 480, 854, 3   # 480p DAVIS production shape, 3 objects
AGREEMENT_MIN, PROB_ERR_MAX = 0.995, 0.05   # scripts/accuracy_envelope.py:196-197


def make_session_inputs(seed: int = 3, t: int = T, h: int = H, w: int = W,
                        k: int = K):
    """Smooth drifting images and blob object masks (the JAX script's):
    (t, h, w, 3) images and two (k+1, h, w, 1) one-hot masks."""
    rng = np.random.RandomState(seed)
    base = rng.rand(-(-h // 8), -(-w // 8), 3).astype(np.float32)
    up = np.kron(base, np.ones((8, 8, 1), np.float32))[:h, :w]
    images = np.stack([np.roll(up, 2 * i, axis=1) for i in range(t)])
    images += 0.05 * rng.rand(t, h, w, 3).astype(np.float32)
    images = np.clip(images, 0, 1)
    yy, xx = np.mgrid[:h, :w]

    def blobs(shift):
        labels = np.zeros((h, w), np.int64)
        for j in range(1, k + 1):
            cy, cx = (0.25 + 0.2 * j) * h, (0.2 * j + shift) * w
            r = 0.1 * min(h, w) * (1 + 0.3 * j)
            labels[(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = j
        oh = np.stack([(labels == i) for i in range(k + 1)])
        return oh.astype(np.float32)[..., None]

    return images, blobs(0.15), blobs(0.22)


def make_trained_session_inputs(seed: int = 11, t: int = T, h: int = H,
                                w: int = W, k: int = K):
    """Inputs from the pretraining distribution: ImageNet-normalized
    moving textured blobs and the masks of their first and last frames."""
    from mivos_tpu_torch.data.transforms import im_normalize
    from mivos_tpu_torch.generation.synthetic import synthetic_sequence
    from mivos_tpu_torch.utils.tensor import labels_to_probs

    images, labels = synthetic_sequence(seed, t, h, w, k)
    return (im_normalize(images).astype(np.float32),
            labels_to_probs(labels[0], k).numpy(),
            labels_to_probs(labels[t - 1], k).numpy())


@contextlib.contextmanager
def tf32_off():
    """Full fp32 convolutions and matmuls for the block, restored after."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def run_session(prop, fuse, images, m1, m2, device, k: int):
    """Interactions on frames 0 and T-1. Returns the (T, h, w) labels, the
    (T, K+1, h, w, 1) probabilities on the raw grid and the seconds."""
    t = images.shape[0]
    core = InferenceCore(prop, fuse, images, k,
                         mem=MemoryConfig(top_k=50, mem_freq=5), device=device)
    t0 = time.perf_counter()
    core.interact(m1, idx=0)
    out = core.interact(m2, idx=t - 1).copy()
    lw, uw, lh, uh = core.pad
    probs = np.stack([core.get_prob(ti)[:, 0, lh:core.nh - uh, lw:core.nw - uw]
                      .float().cpu().numpy() for ti in range(t)])[..., None]
    return out, probs, time.perf_counter() - t0


def statistics(out_f, out_e, prob_f, prob_e):
    """The JAX script's report keys from both sessions' arrays."""
    diff = np.abs(prob_f - prob_e)
    srt = np.sort(prob_e[..., 0], axis=1)
    margin = srt[:, -1] - srt[:, -2]   # the exact path's decision margin
    same = out_f == out_e
    return {
        "label_agreement": float(same.mean()),
        "agreement_margin_1e-3": float(same[margin > 1e-3].mean()),
        "agreement_margin_1e-2": float(same[margin > 1e-2].mean()),
        "frac_margin_1e-2": float((margin > 1e-2).mean()),
        "prob_err_median": float(np.median(diff)),
        "prob_err_p99": float(np.percentile(diff, 99)),
        "prob_err_max": float(diff.max()),
    }


def check_gates(report, gate_frac: float = 0.0) -> None:
    ok = report["agreement_margin_1e-2"]
    assert ok > AGREEMENT_MIN, f"margin-conditioned agreement {ok} below 99.5%"
    assert report["prob_err_max"] < PROB_ERR_MAX, report["prob_err_max"]
    if gate_frac:
        frac = report["frac_margin_1e-2"]
        assert frac >= gate_frac, f"margin cohort {frac:.3f} below {gate_frac}"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", default=None,
                    help="propagation .pth (pretrain_synthetic); default: "
                    "random init and drifting-texture inputs")
    ap.add_argument("--fusion-weights", default=None,
                    help="FusionNet .pth (train_fusion_synthetic); default: "
                    "random init (both sessions share it either way)")
    ap.add_argument("--gate-frac", type=float, default=0.0,
                    help="least frac_margin_1e-2 to accept")
    ap.add_argument("--fast-fusion-fp32", action="store_true",
                    help="the fast session's FusionNet in fp32")
    ap.add_argument("--fast-towers-fp32", action="store_true",
                    help="the fast session's towers in fp32, keeping the kernel read")
    ap.add_argument("--fast-read-refine", type=int, default=0,
                    help="threshold-refine passes of the fast session's read")
    ap.add_argument("--tag", default="", help="suffix of the dump's name")
    ap.add_argument("--dump-dir", default=None,
                    help="where envelope_arrays<tag>.npz goes (default: the "
                    "temporary directory)")
    ap.add_argument("--frames", type=int, default=T)
    ap.add_argument("--hw", type=int, nargs=2, default=(H, W))
    ap.add_argument("--objects", type=int, default=K)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def envelope(args, log=print):
    """Both sessions, the raw dump, then the report (ungated)."""
    dev = torch.device(args.device)
    t, (h, w), k = args.frames, args.hw, args.objects
    gen = torch.Generator().manual_seed(0)
    prop_exact = PropagationNetwork(top_k=50, read_backend="exact")
    if args.weights:
        load_reference_pth(prop_exact, args.weights)
        images, m1, m2 = make_trained_session_inputs(11, t, h, w, k)
    else:
        init_params(prop_exact, gen)
        images, m1, m2 = make_session_inputs(3, t, h, w, k)
    fuse_exact = FusionNet()
    if args.fusion_weights:
        load_reference_pth(fuse_exact, args.fusion_weights)
    else:
        init_params(fuse_exact, torch.Generator().manual_seed(1))
    prop_fast = PropagationNetwork(
        top_k=50, read_refine=args.fast_read_refine,
        dtype=torch.float32 if args.fast_towers_fp32 else torch.bfloat16)
    prop_fast.load_state_dict(prop_exact.state_dict())
    fuse_fast = FusionNet(dtype=torch.float32 if args.fast_fusion_fp32
                          else torch.bfloat16)
    fuse_fast.load_state_dict(fuse_exact.state_dict())

    log("running FAST session (bf16 + kernel read)...")
    out_f, prob_f, t_f = run_session(prop_fast, fuse_fast, images, m1, m2, dev, k)
    log(f"fast session: {t_f:.1f} s")
    log("running EXACT session (fp32, TF32 off, exact read)...")
    with tf32_off():
        out_e, prob_e, t_e = run_session(prop_exact, fuse_exact, images, m1,
                                         m2, dev, k)
    log(f"exact session: {t_e:.1f} s")
    # Raw dump first: a statistics fault must not cost the sessions.
    dump = os.path.join(args.dump_dir or tempfile.gettempdir(),
                        f"envelope_arrays{args.tag}.npz")
    np.savez(dump, out_f=out_f, out_e=out_e, prob_f=prob_f, prob_e=prob_e,
             fast_s=t_f, exact_s=t_e)
    report = statistics(out_f, out_e, prob_f, prob_e)
    report.update({
        "frames": t, "objects": k, "hw": [h, w], "fast_s": t_f, "exact_s": t_e,
        "weights": args.weights or "random-init",
        "fusion_weights": args.fusion_weights or "random-init",
        "fast_config": {"towers_fp32": args.fast_towers_fp32,
                        "fusion_fp32": args.fast_fusion_fp32,
                        "read_refine": args.fast_read_refine},
        "dump": dump})
    return report


def main(argv=None) -> None:
    args = parse_args(argv)
    report = envelope(args, log=lambda *a: print(*a, flush=True))
    print(json.dumps(report), flush=True)
    check_gates(report, args.gate_frac)
    print("ENVELOPE-OK", flush=True)


if __name__ == "__main__":
    main()
