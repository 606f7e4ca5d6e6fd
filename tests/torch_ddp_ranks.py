"""What each rank of tests/test_torch_ddp.py's process group runs.

Spawned ranks import this module to find their function, so it imports
only numpy, torch and the port (never jax or mivos_tpu): the test file
itself does.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

SYNCBN_SHAPE = (4, 3, 5, 6)   # N, C, H, W: each of 2 ranks takes 2 samples
BN_STEPS = 2
TRAIN_BATCH, TRAIN_HW, TRAIN_STEPS = 4, 32, 2
SAMPLER_N = 11


def syncbn_inputs():
    """x (N, C, H, W), the upstream gradient g, weight and bias."""
    rng = np.random.RandomState(5)
    n, c = SYNCBN_SHAPE[:2]
    x = (rng.randn(*SYNCBN_SHAPE) * 2.0 + 0.5).astype(np.float32)
    g = rng.randn(*SYNCBN_SHAPE).astype(np.float32)
    return x, g, rng.rand(c).astype(np.float32) + 0.5, rng.randn(c).astype(np.float32)


def train_batch(seed):
    """A fusion batch of TRAIN_BATCH samples at TRAIN_HW; the odd samples
    have no second object (no class 2, zero second-object streams, as
    the dataset makes them)."""
    b, h, w = TRAIN_BATCH, TRAIN_HW, TRAIN_HW
    rng = np.random.RandomState(seed)
    m = lambda: rng.rand(b, h, w, 1).astype(np.float32)  # noqa: E731
    batch = {
        "rgb": rng.randn(b, h, w, 3).astype(np.float32),
        "cls_gt": rng.randint(0, 3, (b, h, w)).astype(np.int32),
        "gt": (m() > 0.5).astype(np.float32),
        "seg1": m(), "seg2": m(),
        "src2_ref": m(), "src2_ref_gt": (m() > 0.5).astype(np.float32),
        "gt2": (m() > 0.5).astype(np.float32),
        "seg12": m(), "seg22": m(),
        "src2_ref2": m(), "src2_ref_gt2": (m() > 0.5).astype(np.float32),
        "src2_ref_im": rng.randn(b, h, w, 3).astype(np.float32),
        "dist": rng.rand(b, 2).astype(np.float32),
        "selector": np.tile(np.asarray([[1, 1], [1, 0]], np.float32), (b // 2, 1)),
    }
    batch["cls_gt"][1::2] %= 2
    for k in ("gt2", "seg12", "seg22", "src2_ref2", "src2_ref_gt2"):
        batch[k][1::2] = 0.0
    return batch


def train_config():
    from mivos_tpu_torch.config import TrainConfig

    return TrainConfig(iterations=4, steps=(1,), batch_size=TRAIN_BATCH)


def rank_checks(rank, world, attn_state):
    """Every check's per-rank result, as numpy and floats; the trainer's
    reader loads `attn_state`."""
    from mivos_tpu_torch.data.loader import ShardedSampler
    from mivos_tpu_torch.models.layers import SyncBatchNorm
    from mivos_tpu_torch.train.trainer import FusionTrainer
    from mivos_tpu_torch.utils.integrator import Integrator

    torch.set_num_threads(1)   # beside the test runner's other workers
    out = {}
    # SyncBatchNorm: this rank's share of the batch, BN_STEPS training
    # forwards (running statistics), one backward.
    x, g, weight, bias = syncbn_inputs()
    per = x.shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    bn = SyncBatchNorm(x.shape[1])
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(weight))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x[sl]).requires_grad_(True)
    for _ in range(BN_STEPS - 1):
        bn(xt)
    y = bn(xt)
    (y * torch.from_numpy(g[sl])).sum().backward()
    out["bn_y"] = y.detach().numpy()
    out["bn_dx"] = xt.grad.numpy()
    out["bn_dweight"] = bn.weight.grad.numpy()
    out["bn_dbias"] = bn.bias.grad.numpy()
    out["bn_running"] = (bn.running_mean.numpy(), bn.running_var.numpy())

    # Data-parallel fusion training: this rank's share of each batch.
    trainer = FusionTrainer(train_config(), attn_state, device="cpu")
    per = TRAIN_BATCH // world
    integ = Integrator(None, is_main=rank == 0)
    out["ddp"] = type(trainer.model).__name__
    for s in range(TRAIN_STEPS):
        batch = {k: v[rank * per:(rank + 1) * per]
                 for k, v in train_batch(s).items()}
        integ.add_dict({"total_loss": trainer.train_step(batch)["total_loss"]})
    out["weights"] = {k: v.numpy() for k, v in trainer.fuse_net.state_dict().items()}
    out["loss_mean"] = integ.finalize("train", TRAIN_STEPS)["total_loss"]

    # The integrator's cross-rank mean of per-rank values.
    integ = Integrator(None, is_main=rank == 0)
    integ.add_dict({"a": float(rank), "hide_b": 10.0 * (rank + 1)})
    integ.add_dict({"a": float(rank) + 2.0, "hide_b": 0.0})
    integ.add_hook(lambda v: ("c", v["hide_b"] + v["a"]))
    out["integrator"] = integ.finalize("train", 1)

    sampler = ShardedSampler(SAMPLER_N, num_shards=dist.get_world_size(),
                             shard=dist.get_rank(), seed=3)
    sampler.set_epoch(1)
    out["sampler"] = list(sampler)
    out["foreign_modules"] = sorted(m for m in sys.modules if m.split(".")[0]
                                    in ("jax", "jaxlib", "flax", "mivos_tpu"))
    return out
