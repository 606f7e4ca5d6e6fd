"""Multi-device dry run (counterpart of __graft_entry__.py::
dryrun_multichip, :80-260): every multi-device path once, at tiny
sizes, each check reported by name.

  trainer        the fusion training step, data-parallel over one rank
                 per mesh position (DDP; NCCL when the positions are
                 distinct cards, gloo otherwise), one 32x32 sample a
                 rank, and a SyncBatchNorm over the ranks (train_rank);
                 the replicas must stay equal
  sharded_read   the bank-sharded exact read against the unsharded one
  bank_session   an InferenceCore pass with its bank over every position
  object_session an InferenceCore pass with one object per position
  session_2d     both: 2 object x n/2 position shards (even n >= 4)

Sessions: 4 frames of 32x48, top_k 10, mem_freq 2, the full-width
PropagationNetwork from a seed.

  PYTHONPATH=. python -m mivos_tpu_torch.parallel.dryrun 4
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from mivos_tpu_torch.parallel.mesh import make_mesh, make_mesh_nd

CHECKS = ("trainer", "sharded_read", "bank_session", "object_session",
          "session_2d")
T, H, W, TOP_K, MEM_FREQ = 4, 32, 48, 10, 2


def fusion_batch(b: int, h: int, w: int, seed: int) -> Dict[str, np.ndarray]:
    """A random NHWC fusion-training batch of b samples, as the JAX dry
    run draws it (every sample with a second object)."""
    rng = np.random.RandomState(seed)
    m = lambda: rng.rand(b, h, w, 1).astype(np.float32)  # noqa: E731
    return {
        "rgb": rng.randn(b, h, w, 3).astype(np.float32),
        "cls_gt": rng.randint(0, 3, (b, h, w)).astype(np.int32),
        "gt": (m() > 0.5).astype(np.float32), "seg1": m(), "seg2": m(),
        "src2_ref": m(), "src2_ref_gt": (m() > 0.5).astype(np.float32),
        "gt2": (m() > 0.5).astype(np.float32), "seg12": m(), "seg22": m(),
        "src2_ref2": m(), "src2_ref_gt2": (m() > 0.5).astype(np.float32),
        "src2_ref_im": rng.randn(b, h, w, 3).astype(np.float32),
        "dist": rng.rand(b, 2).astype(np.float32),
        "selector": np.ones((b, 2), np.float32)}


def train_rank(rank: int, world: int, devices: Sequence[str], attn_state: Dict,
               batch: int, hw: int, steps: int, bn_x: np.ndarray,
               bn_g: np.ndarray) -> Dict:
    """One rank of data-parallel training (run under parallel/ranks.py,
    on devices[rank], TF32 off, deterministic cuDNN plans): a
    SyncBatchNorm over the ranks on this rank's share of the (N, C, H, W)
    bn_x (two training forwards, then the backward of sum(y * bn_g)), and
    `steps` steps of a FusionTrainer whose reader loads `attn_state` on
    its share of each fusion_batch(batch, hw, hw, step). Returns numpy
    results, the losses and each step's ms."""
    from mivos_tpu_torch.config import TrainConfig
    from mivos_tpu_torch.models.layers import SyncBatchNorm
    from mivos_tpu_torch.train.trainer import FusionTrainer

    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = False, True
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *a: None)
    per = bn_x.shape[0] // world
    bn = SyncBatchNorm(bn_x.shape[1]).to(dev)
    x = torch.from_numpy(bn_x[rank * per:(rank + 1) * per]).to(dev).requires_grad_(True)
    bn(x)
    y = bn(x)
    (y * torch.from_numpy(bn_g[rank * per:(rank + 1) * per]).to(dev)).sum().backward()
    out = {"bn_y": y.detach().cpu().numpy(), "bn_dx": x.grad.cpu().numpy(),
           "bn_dweight": bn.weight.grad.cpu().numpy(),
           "bn_dbias": bn.bias.grad.cpu().numpy(),
           "bn_running": (bn.running_mean.cpu().numpy(), bn.running_var.cpu().numpy())}
    trainer = FusionTrainer(TrainConfig(iterations=100, steps=(80,), batch_size=batch),
                            attn_state, device=dev)
    per = batch // world
    out["step_ms"], out["loss"] = [], []
    for s in range(steps):
        b = {k: v[rank * per:(rank + 1) * per]
             for k, v in fusion_batch(batch, hw, hw, s).items()}
        sync(dev)
        t0 = time.perf_counter()
        out["loss"].append(float(trainer.train_step(b)["total_loss"]))
        sync(dev)
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
    out["model"] = type(trainer.model).__name__
    out["weights"] = {k: v.cpu().numpy() for k, v in trainer.fuse_net.state_dict().items()}
    return out


def _session(prop, mesh, k: int, **sharding) -> str:
    from mivos_tpu_torch.config import MemoryConfig
    from mivos_tpu_torch.core.inference import InferenceCore
    from mivos_tpu_torch.utils.tensor import labels_to_probs

    rng = np.random.RandomState(0)
    video = rng.rand(T, H, W, 3).astype(np.float32)
    mask = labels_to_probs((rng.rand(H, W) * (k + 1)).astype(np.int64), k)
    core = InferenceCore(prop, None, video, k, mesh=mesh,
                         device=mesh.devices.reshape(-1)[0],
                         mem=MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ,
                                          **sharding))
    labels = core.interact(mask, 0)
    if labels.shape != (T, H, W) or int(labels.max()) > k:
        raise RuntimeError(f"labels {labels.shape}, max {labels.max()}")
    devs = {x.device for sh in core.shards for x in
            (sh.bank.keys.reshape(-1) if sh.bank.mesh is not None
             else [sh.bank.keys])}
    return (f"pass {labels.shape} over {mesh.size} positions, "
            f"{len(core.shards)} object shards, banks on {sorted(map(str, devs))}")


def _run(check: str, n: int, devices: Optional[Sequence], prop) -> str:
    if check == "trainer":
        from mivos_tpu_torch.parallel.ranks import run_ranks

        devs = [str(d) for d in make_mesh(n, devices=devices).devices]
        backend = ("nccl" if all(d.startswith("cuda") for d in devs)
                   and len(set(devs)) == n else "gloo")
        from mivos_tpu_torch.checkpoint.pth import attention_read_state_dict

        rng = np.random.RandomState(0)
        bn_x = rng.randn(2 * n, 8, 6, 6).astype(np.float32)
        ranks = run_ranks(train_rank, n, (devs, attention_read_state_dict(prop),
                                          n, 32, 1, bn_x, bn_x), backend=backend)
        losses = [r["loss"][0] for r in ranks]
        same = all(np.array_equal(ranks[0]["weights"][k], r["weights"][k])
                   for r in ranks for k in r["weights"])
        if not (np.isfinite(losses).all() and same):
            raise RuntimeError(f"losses {losses}, replicas equal: {same}")
        return (f"{backend} world {n}, one sample a rank, rank losses "
                f"{np.round(losses, 4).tolist()}, replicas equal")
    if check == "sharded_read":
        from mivos_tpu_torch.ops.memory_read import memory_read
        from mivos_tpu_torch.parallel.sharded_memory import (shard_bank,
                                                             sharded_memory_read)

        mesh = make_mesh(n, devices=devices)
        home = mesh.devices[0]
        g = torch.Generator().manual_seed(0)
        mk, mv = torch.randn(2, 64 * n, 128, generator=g), torch.randn(2, 64 * n, 64, generator=g)
        q = torch.randn(32, 128, generator=g).to(home)
        out = sharded_memory_read(mesh, *shard_bank(mesh, mk, mv), q, top_k=8)
        ref = memory_read(mk.to(home), mv.to(home), q, top_k=8, backend="exact")
        err = float((out - ref).abs().max())
        if not (torch.isfinite(out).all() and err < 1e-4):
            raise RuntimeError(f"max |sharded - exact| {err}")
        return f"readout {tuple(out.shape)}, max |sharded - exact| {err:.2e}"
    if check == "bank_session":
        return _session(prop, make_mesh(n, devices=devices), 2,
                        bank_sharded=True)
    if check == "object_session":
        return _session(prop, make_mesh(n, axis="object", devices=devices),
                        n, object_sharded=True)
    if check == "session_2d":
        if n % 2 or n < 4:
            return "skipped (needs even n >= 4)"
        return _session(prop, make_mesh_nd(object=2, data=n // 2,
                                           devices=devices),
                        2, object_sharded=True, bank_sharded=True)
    raise ValueError(f"unknown dry-run check {check!r}")


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> Dict[str, str]:
    """Run every check on a mesh of the first n_devices of `devices`
    (default: every CUDA device; a repeated list puts several positions
    on one device). Prints one line per check and returns check ->
    result; raises RuntimeError naming every check that failed, after
    running them all."""
    from mivos_tpu_torch.models.initializer import init_params
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    # One random-init net from a seed for every session check.
    prop = init_params(PropagationNetwork(top_k=TOP_K),
                       torch.Generator().manual_seed(0))
    report, failures = {}, []
    for check in CHECKS:
        try:
            report[check] = _run(check, n_devices, devices, prop)
        except Exception as e:   # reported by name, raised below
            failures.append(check)
            report[check] = f"FAILED: {type(e).__name__}: {e}"
        print(f"dryrun[{check}]: {report[check]}", flush=True)
    if failures:
        raise RuntimeError(f"dryrun_multichip({n_devices}) checks failed: "
                           f"{failures}; {report}")
    return report


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else
                     torch.cuda.device_count())
