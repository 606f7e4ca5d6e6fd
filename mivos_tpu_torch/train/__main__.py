"""Fusion-module training (counterpart of the repository's train.py;
reference train.py). Stage 0 = BL30K, stage 1 = DAVIS (reference
util/hyper_para.py:46-53).

  python -m mivos_tpu_torch.train --id retrain_s0 --stage 0 \
      --im_root ../BL30K/JPEGImages --gt_root ../BL30K/Annotations \
      --fd_root ../fusion_data/bl --load_prop saves/propagation_model.pth \
      [--device cuda|cuda:N|cpu]

Data-parallel over N cards of one host, one process per card:

  torchrun --nproc_per_node N -m mivos_tpu_torch.train ...

Each rank trains on cuda:LOCAL_RANK (NCCL; with --device cpu, gloo on the
CPU) with batch_size / N samples of the batch, which N must divide, from
its own shard of each epoch's order (ShardedSampler); DDP averages the
gradients, so the step is the one-process step of the whole batch. Only
rank 0 logs and writes checkpoints. A rank never shares a card: with
more ranks than cards the run stops.

The frozen attention reader takes the propagation weights of --load_prop
(.pth) or --load_prop_npz (flax .npz); without either it is random-init
from the seed. --load_model resumes a checkpoint directory (iteration,
FusionNet, optimizer, scheduler); --load_network loads FusionNet weights
only. Checkpoints go to <save_dir>/<id>/ every save_every iterations,
and on exit past 5000 iterations, with the FusionNet weights as
final_<it>.pth (a fusion.pth). Every report_every * 10 iterations rank 0
writes the training-pair montage (utils/image_saver.py::pool_fusion of
the batch and the step's forward outputs; reference
fusion_model.py:101-112) to <save_dir>/<id>/pairs_<it>.png. --device
cuda (the default) fails without a CUDA device.
"""
import argparse
import os
import time

import torch

from mivos_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from mivos_tpu_torch.checkpoint.manager import CheckpointManager, save_params
from mivos_tpu_torch.checkpoint.npz import load_params_npz
from mivos_tpu_torch.checkpoint.pth import (attention_read_state_dict,
                                            load_reference_pth)
from mivos_tpu_torch.config import TrainConfig
from mivos_tpu_torch.data.fusion_dataset import FusionDataset
from mivos_tpu_torch.data.loader import Loader, ShardedSampler
from mivos_tpu_torch.parallel.mesh import maybe_initialize_distributed
from mivos_tpu_torch.train.trainer import FusionTrainer
from mivos_tpu_torch.utils.integrator import Integrator
from mivos_tpu_torch.utils.logger import TensorboardLogger


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--id", default="NULL", help="run id (NULL = DEBUG)")
    p.add_argument("--stage", type=int, default=0, help="0=BL30K, 1=DAVIS")
    p.add_argument("--im_root", required=True)
    p.add_argument("--gt_root", required=True)
    p.add_argument("--fd_root", required=True)
    p.add_argument("--batch_size", type=int, default=12)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--iterations", type=int, default=None)
    p.add_argument("--steps", type=int, nargs="*", default=None)
    p.add_argument("--gamma", type=float, default=0.1)
    p.add_argument("--load_prop", help="propagation checkpoint (.pth) "
                   "for the frozen attention reader")
    p.add_argument("--load_prop_npz", help="flax propagation weights "
                   "(.npz) for the frozen attention reader")
    p.add_argument("--load_network", help="FusionNet weights only (.pth)")
    p.add_argument("--load_model", help="full resume: a checkpoint directory")
    p.add_argument("--save_dir", default="saves")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--save_every", type=int, default=TrainConfig.save_every,
                   help="checkpoint interval")
    p.add_argument("--report_every", type=int,
                   default=TrainConfig.report_every)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, cpu)")
    return p.parse_args(argv)


def rank_device(device: torch.device) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK under torchrun (one card per
    rank, never shared), else `device`."""
    if device.type != "cuda" or "LOCAL_RANK" not in os.environ:
        return device
    local = int(os.environ["LOCAL_RANK"])
    if local >= torch.cuda.device_count():
        raise SystemExit(f"local rank {local} has no card of its own "
                         f"({torch.cuda.device_count()} CUDA devices)")
    torch.cuda.set_device(local)
    return torch.device("cuda", local)


def save_montage(trainer: FusionTrainer, batch, save_dir: str, it: int) -> str:
    """The training-pair montage of `batch` (the JAX train.py:142's
    pool_fusion image) as <save_dir>/pairs_<it>.png; returns the path."""
    from PIL import Image

    from mivos_tpu_torch.utils.image_saver import pool_fusion

    with torch.no_grad():
        out = trainer.debug_outputs(batch)
    vis = {k: v.numpy() if torch.is_tensor(v) else v for k, v in batch.items()
           if k != "info"}
    vis.update(mask=out["mask"], attn1=out["attn1"], attn2=out["attn2"])
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"pairs_{it:06d}.png")
    Image.fromarray(pool_fusion(vis)).save(path)
    return path


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    device = rank_device(device)
    rank, world = maybe_initialize_distributed(
        "gloo" if device.type == "cpu" else "nccl")
    if args.batch_size % world:
        raise SystemExit(f"--batch_size {args.batch_size} is not divisible "
                         f"by the {world} ranks")
    cfg = TrainConfig(stage=args.stage, batch_size=args.batch_size,
                      lr=args.lr, iterations=args.iterations,
                      steps=tuple(args.steps) if args.steps else None,
                      gamma=args.gamma, save_every=args.save_every,
                      report_every=args.report_every)
    iterations = cfg.resolved_iterations()
    logger = TensorboardLogger(args.id) if rank == 0 else None
    if logger is not None:
        logger.log_string("hyperpara", str(vars(args)))

    dataset = FusionDataset(args.im_root, args.gt_root, args.fd_root,
                            seed=cfg.seed)
    loader = Loader(dataset, cfg.batch_size // world,
                    sampler=ShardedSampler(len(dataset), num_shards=world,
                                           shard=rank, seed=cfg.seed),
                    num_workers=args.num_workers,
                    pin_memory=device.type == "cuda")
    if len(loader) == 0:   # an epoch without a batch would loop forever
        raise SystemExit(f"{len(dataset)} videos with fusion data under "
                         f"{args.fd_root}: fewer than one batch of "
                         f"{cfg.batch_size} over {world} ranks")

    attn_state = None
    if args.load_prop:
        attn_state = attention_read_state_dict(args.load_prop)
    elif args.load_prop_npz:
        attn_state = attention_read_state_dict(
            state_dict_from_flax(load_params_npz(args.load_prop_npz)))
    trainer = FusionTrainer(cfg, attn_state, device=device)

    save_dir = os.path.join(args.save_dir, args.id)
    mgr = CheckpointManager(save_dir)
    if args.load_model:
        trainer.load_state_dict(CheckpointManager(args.load_model).restore())
        if rank == 0:
            print(f"resumed at iteration {trainer.it}", flush=True)
    elif args.load_network:
        load_reference_pth(trainer.fuse_net, args.load_network)
        if rank == 0:
            print("loaded network weights", flush=True)

    integrator = Integrator(logger, is_main=rank == 0)
    integrator.add_hook(lambda v: (
        "iou", v.get("hide_iou/i", 0.0) / max(v.get("hide_iou/u", 1.0), 1.0)))
    epoch = trainer.it * cfg.batch_size // len(dataset)
    last_report = time.time()
    try:
        while trainer.it < iterations:
            loader.set_epoch(epoch)
            for batch in loader:
                if trainer.it >= iterations:
                    break
                integrator.add_dict(trainer.train_step(batch))
                it = trainer.it
                if it % cfg.report_every == 0:
                    if logger is not None:
                        logger.log_metrics("train", "lr", trainer.lr, it)
                        logger.log_metrics("train", "time_per_iter",
                                           (time.time() - last_report)
                                           / cfg.report_every, it)
                    last_report = time.time()
                    integrator.finalize("train", it)
                    integrator.reset_except_hooks()
                if rank == 0 and it % (cfg.report_every * 10) == 0:
                    save_montage(trainer, batch, save_dir, it)
                if rank == 0 and it % cfg.save_every == 0:
                    mgr.save(it, trainer.state_dict())
            epoch += 1
    finally:
        # Save on exit when meaningfully trained (reference train.py:125-129).
        if rank == 0 and trainer.it > 5000:
            mgr.save(trainer.it, trainer.state_dict())
            save_params(os.path.join(save_dir, f"final_{trainer.it}.pth"),
                        trainer.fuse_net)
        if world > 1:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
