"""Fusion-module trainer (counterpart of mivos_tpu/train/trainer.py;
reference model/fusion_model.py), on one device or one rank of a
data-parallel run.

FusionNet is the only module that learns. The attention reader's
parameters have requires_grad False and its forward runs under no_grad
(the JAX trainer's stop_gradient), so the backward pass covers FusionNet
alone; FusionNet has no batch norm. The optimizer is the reference's:
Adam(lr, weight_decay=1e-7), which adds the decay to the gradient before
the moments, as the JAX package's optax chain does, and MultiStepLR(steps,
gamma), whose update i runs at lr * gamma^(boundaries <= i), as
optax.piecewise_constant_schedule's.

Batches are the loader's NHWC tensors (pinned for the card) or numpy
arrays; the trainer copies them to its device with non_blocking=True and
works NCHW.

Data parallelism: when a torch.distributed process group is up with
more than one rank (train/__main__.py under torchrun), FusionNet is
wrapped in DistributedDataParallel, which averages the gradients over
the ranks in the backward pass; the frozen reader stays outside it.
Each rank steps on its own equal share of the batch. The loss is a
per-sample mean averaged over the batch (train/losses.py), so the
ranks' mean gradient is the one-process gradient of the whole batch:
every rank takes the one-process step.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from mivos_tpu_torch.config import TrainConfig
from mivos_tpu_torch.models.fusion import AttentionReadNetwork, FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.ops.aggregate import aggregate_wbg_channel
from mivos_tpu_torch.train.losses import compute_fusion_losses


def fusion_forward(fuse_net: FusionNet, attn_net: AttentionReadNetwork,
                   batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One training batch's forward pass (reference fusion_model.py:54-92),
    NCHW. Returns logits and mask (B, 3, H, W), background first, and
    the two attention maps (B, 2, H, W)."""
    with torch.no_grad():
        attn1, attn2 = attn_net(batch["src2_ref_im"], batch["src2_ref"],
                                batch["src2_ref_gt"], batch["src2_ref2"],
                                batch["src2_ref_gt2"], batch["rgb"])
    prob1 = torch.sigmoid(fuse_net(batch["rgb"], batch["seg1"], batch["seg2"],
                                   attn1, batch["dist"]))
    prob2 = torch.sigmoid(fuse_net(batch["rgb"], batch["seg12"],
                                   batch["seg22"], attn2, batch["dist"]))
    prob = torch.cat([prob1, prob2], dim=1) * batch["selector"][:, :, None, None]
    logits, mask = aggregate_wbg_channel(prob)
    return {"logits": logits, "mask": mask, "attn1": attn1, "attn2": attn2}


class FusionTrainer:
    """FusionNet (random init from cfg.seed) trained through a frozen
    AttentionReadNetwork, whose weights `attn_state` gives (a state_dict
    from `checkpoint/pth.py::attention_read_state_dict`; random init from
    the same seed without one, as in the JAX package)."""

    def __init__(self, cfg: TrainConfig,
                 attn_state: Optional[Mapping[str, torch.Tensor]] = None,
                 device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(cfg.seed)
        self.fuse_net = init_params(FusionNet(), gen).to(self.device).train()
        # What the step runs: FusionNet, or its DDP wrapper over the ranks
        # (which shares its parameters; checkpoints hold FusionNet's).
        self.model: torch.nn.Module = self.fuse_net
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            self.model = DistributedDataParallel(
                self.fuse_net, device_ids=(None if self.device.type == "cpu"
                                           else [self.device]))
        attn_net = AttentionReadNetwork()
        if attn_state is None:
            init_params(attn_net, gen)
        else:
            attn_net.load_state_dict(attn_state, strict=True)
        self.attn_net = attn_net.to(self.device).eval().requires_grad_(False)
        self.optimizer = torch.optim.Adam(self.fuse_net.parameters(),
                                          lr=cfg.lr, weight_decay=1e-7)
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, milestones=list(cfg.resolved_steps()),
            gamma=cfg.gamma)
        iters = cfg.resolved_iterations()
        self.start_warm = int(iters * 0.2)   # reference losses.py:48
        self.end_warm = int(iters * 0.5)
        self.it = 0

    @property
    def lr(self) -> float:
        """The learning rate the next train_step applies."""
        return self.optimizer.param_groups[0]["lr"]

    def to_device(self, batch: Mapping) -> Dict[str, torch.Tensor]:
        """A loader batch (NHWC tensors or arrays, 'info' dropped)
        on the device, NCHW."""
        out = {}
        for k, v in batch.items():
            if k == "info":
                continue
            t = torch.as_tensor(v).to(self.device, non_blocking=True)
            out[k] = t.movedim(-1, 1) if t.ndim == 4 else t
        return out

    def train_step(self, batch: Mapping) -> Dict:
        """One update; returns the metric dict (tensors on the device,
        and the float32 fraction 'p')."""
        b = self.to_device(batch)
        out = fusion_forward(self.model, self.attn_net, b)
        losses = compute_fusion_losses(out, b, self.it, self.start_warm,
                                       self.end_warm)
        self.optimizer.zero_grad(set_to_none=True)
        losses["total_loss"].backward()
        self.optimizer.step()
        self.scheduler.step()
        self.it += 1
        return {k: v.detach() if torch.is_tensor(v) else v
                for k, v in losses.items()}

    @torch.no_grad()
    def val_step(self, batch: Mapping) -> Dict:
        b = self.to_device(batch)
        out = fusion_forward(self.fuse_net, self.attn_net, b)
        return compute_fusion_losses(out, b, self.it, self.start_warm,
                                     self.end_warm)

    @torch.no_grad()
    def debug_outputs(self, batch: Mapping) -> Dict[str, np.ndarray]:
        """Forward outputs as NHWC host arrays (mask, logits, attn1,
        attn2), for a training montage (reference fusion_model.py:101-112)."""
        out = fusion_forward(self.fuse_net, self.attn_net,
                             self.to_device(batch))
        return {k: v.movedim(1, -1).cpu().numpy() for k, v in out.items()}

    # ----- checkpoint state -----

    def state_dict(self) -> Dict:
        """{it, network (FusionNet, reference names), optimizer,
        scheduler}: the reference's full checkpoint (fusion_model.py:143-152)."""
        return {"it": self.it, "network": self.fuse_net.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, state: Mapping) -> None:
        self.it = int(state["it"])
        self.fuse_net.load_state_dict(state["network"], strict=True)
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
