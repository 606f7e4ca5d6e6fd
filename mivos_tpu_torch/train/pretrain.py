"""Synthetic pretraining of the propagation, S2M and f-BRS nets
(counterpart of mivos_tpu/train/pretrain.py).

The repository holds no trained weights and no VOS data, and random-init
weights leave most pixels near-tied, which voids every accuracy check.
These trainers fit the nets on generation/synthetic.py's moving-blob
video until their masks are confident; the artifacts
(pretrain_synthetic.py) feed generate_fusion, fusion training and the
kernel gate on trained-like banks.

The trained set is the JAX package's: every conv weight and bias, and
all four tensors of every FrozenBatchNorm (scale, bias, mean, var),
which are flax params there. Here those four stay buffers, so that
state_dict names stay the reference's and inference is unchanged, and
are marked requires_grad and handed to the optimizer with the
parameters. The optimizer is optax.chain(clip_by_global_norm(1.0),
adam(lr)): the gradient is scaled by 1/||g|| when its global norm is not
below 1 (optax's rule, without clip_grad_norm_'s +1e-6), then
torch.optim.Adam with optax's betas and eps.

Gradients of the propagation net go through the exact top-k read
(read_backend "exact"); the CUDA read kernels are inference-only, as
the Pallas kernel is in the JAX package. Batches are built on the host
in numpy (`host_batch`, or ahead of the loop in worker processes,
`batches`) and copied to the device once a step; `step` reads back two
floats, as the JAX package's float() calls do.
"""
from __future__ import annotations

from typing import Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mivos_tpu_torch.data.transforms import im_normalize
from mivos_tpu_torch.generation.synthetic import (fbrs_example, prop_clip,
                                                  s2m_example)
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.initializer import calibrate_frozen_bn, init_params
from mivos_tpu_torch.models.layers import FrozenBatchNorm
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.ops.aggregate import aggregate_wbg
from mivos_tpu_torch.train.fbrs_losses import normalized_focal_loss

StateDict = Mapping[str, torch.Tensor]
BATCH_WORKERS = 4   # processes building batches ahead of the loop (`batches`)


def _bce_logits(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE on logits, optax.sigmoid_binary_cross_entropy's
    form."""
    return (-y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)).mean()


def _soft_iou(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean over the batch of (|hard & y| + 1) / (|hard | y| + 1), hard =
    p > 0.5, each sum over every axis but the first."""
    hard = (p > 0.5).to(torch.float32)
    i = (hard * y).sum(dim=(1, 2, 3))
    u = torch.maximum(hard, y).sum(dim=(1, 2, 3))
    return ((i + 1.0) / (u + 1.0)).mean()


def trained_tensors(net: torch.nn.Module) -> List[torch.Tensor]:
    """The tensors the JAX package trains: every parameter and every
    FrozenBatchNorm's weight, bias, running_mean and running_var (marked
    requires_grad here; they stay buffers)."""
    tensors = list(net.parameters())
    for m in net.modules():
        if isinstance(m, FrozenBatchNorm):
            for name in ("weight", "bias", "running_mean", "running_var"):
                tensors.append(getattr(m, name).requires_grad_(True))
    return tensors


class ClippedAdam:
    """optax.chain(clip_by_global_norm(1.0), adam(lr)) over `tensors`. A
    tensor without a gradient gets a zero one, so that every tensor's
    Adam step count is optax's."""

    def __init__(self, tensors: List[torch.Tensor], lr: float):
        self.tensors = tensors
        self.adam = torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def step(self, loss: torch.Tensor) -> None:
        self.adam.zero_grad(set_to_none=True)
        loss.backward()
        grads = []
        for t in self.tensors:
            if t.grad is None:
                t.grad = torch.zeros_like(t)
            grads.append(t.grad)
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        # g unchanged below norm 1, else g / norm: optax's select.
        torch._foreach_div_(grads, torch.where(norm < 1.0, torch.ones_like(norm), norm))
        self.adam.step()


def _prepare(net: torch.nn.Module, params: Optional[StateDict], seed: int,
             device, init_flavor: str = "default") -> torch.nn.Module:
    """Load `params` (a state_dict, strict) or draw weights of the
    init flavour from `seed`, then move the net to `device`."""
    if params is None:
        init_params(net, torch.Generator().manual_seed(seed), init_flavor)
    else:
        net.load_state_dict(params, strict=True)
    return net.to(device)


class _Pretrainer:
    """Shared state: the net on its device, its trained tensors and the
    clipped Adam over them."""

    def _setup_optimizer(self, lr: float) -> None:
        self.opt = ClippedAdam(trained_tensors(self.net), lr)

    def host_batch(self, seed: int):
        """Step `seed`'s batch (numpy, on the host)."""
        return self.make_batch(seed)

    def _to_device(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in arrays)

    def _update(self, loss: torch.Tensor,
                iou: torch.Tensor) -> Tuple[float, float]:
        self.opt.step(loss)
        loss_f, iou_f = torch.stack([loss.detach().to(torch.float64),
                                     iou.detach().to(torch.float64)]).tolist()
        return loss_f, iou_f

    def step(self, seed: int, batch=None) -> Tuple[float, float]:
        """One update on step `seed`'s batch (`batch`: host_batch(seed),
        built ahead by `batches`). Returns (loss, iou)."""
        if batch is None:
            batch = self.host_batch(seed)
        return self._update(*self.loss(*self._to_device(*batch)))

    def state_dict(self):
        """The net's weights under the reference's names."""
        return self.net.state_dict()


class PropPretrainer(_Pretrainer):
    """Adam on memorize -> exact top-k read -> decode over a
    `chain_steps`-long propagated clip. Step 1 memorizes the GT mask;
    every later step segments from the accumulated bank and memorizes
    the net's own aggregated prediction, with gradients through the
    whole chain (the reference's main-training recipe). The loss is the
    mean BCE on the logits over the chain; the IoU is the last step's.

    `chain_mix` (e.g. (1, 3)) interleaves chain lengths round-robin by
    step seed over the same weights and optimizer state."""

    def __init__(self, net: Optional[PropagationNetwork] = None,
                 params: Optional[StateDict] = None, lr: float = 2e-4,
                 hw: Tuple[int, int] = (192, 192), num_objects: int = 2,
                 seed: int = 0, chain_steps: int = 1,
                 chain_mix: Optional[Tuple[int, ...]] = None,
                 device="cuda"):
        self.net = net or PropagationNetwork(top_k=50, read_backend="exact")
        assert self.net.read_backend == "exact", (
            "training must differentiate through the exact top-k read")
        self.mix = tuple(chain_mix) if chain_mix else (chain_steps,)
        assert all(n >= 1 for n in self.mix), self.mix
        self.hw, self.k, self.chain = tuple(hw), num_objects, max(self.mix)
        self.device = torch.device(device)
        _prepare(self.net, params, seed, self.device)
        self._setup_optimizer(lr)

    def pick_chain(self, seed: int) -> int:
        """Round-robin over the mix by step seed, so a resumed run replays
        the same schedule."""
        return self.mix[seed % len(self.mix)]

    def make_batch(self, seed: int, n_chain: Optional[int] = None):
        """(imgs (S+1, H, W, 3) normalized, gts (S+1, K, H, W, 1)) numpy,
        at gaps 1-5 (a mem_freq-5 session's commit spacing)."""
        h, w = self.hw
        n = n_chain if n_chain is not None else self.chain
        imgs, gts = prop_clip(seed, n, h, w, num_objects=self.k, max_gap=5)
        return im_normalize(imgs), gts

    def loss(self, imgs: torch.Tensor, gts: torch.Tensor,
             n_chain: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean chain loss, last step's IoU) of one clip on the device."""
        net = self.net
        mem_k, mem_v = net.memorize(imgs[0], gts[0])
        total = 0.0
        for s in range(1, n_chain + 1):
            valid = torch.ones(mem_k.shape[1], dtype=torch.bool,
                               device=imgs.device)
            f16, f8, f4, k16, v16 = net.get_query_values(imgs[s])
            logits = net.segment_logits(mem_k, mem_v, valid, f16, f8, f4,
                                        k16, v16)
            total = total + _bce_logits(logits, gts[s])
            prob = torch.sigmoid(logits)
            if s < n_chain:
                # Memorize the aggregated self-prediction, what a session
                # commits.
                agg = aggregate_wbg(prob, keep_bg=True)[1:]
                nk, nv = net.memorize(imgs[s], agg)
                mem_k = torch.cat([mem_k, nk], dim=1)
                mem_v = torch.cat([mem_v, nv], dim=1)
        return total / n_chain, _soft_iou(prob, gts[n_chain])

    def host_batch(self, seed: int):
        """Step `seed`'s batch, at its chain length."""
        return self.make_batch(seed, self.pick_chain(seed))

    def step(self, seed: int, batch=None) -> Tuple[float, float]:
        if batch is None:
            batch = self.host_batch(seed)
        imgs, gts = self._to_device(*batch)
        return self._update(*self.loss(imgs, gts, self.pick_chain(seed)))


class S2MPretrainer(_Pretrainer):
    """Adam on the 6-channel scribble-to-mask DeepLabV3+ (reference
    model/s2m/s2m_network.py:56-64 input contract); random init from
    seed + 1, as in the JAX package."""

    def __init__(self, net: Optional[S2MNetwork] = None,
                 params: Optional[StateDict] = None, lr: float = 2e-4,
                 hw: Tuple[int, int] = (192, 192), num_objects: int = 2,
                 seed: int = 0, device="cuda"):
        self.net = net or S2MNetwork()
        self.hw, self.k = tuple(hw), num_objects
        self.device = torch.device(device)
        _prepare(self.net, params, seed + 1, self.device)
        self._setup_optimizer(lr)

    def make_batch(self, seed: int):
        """(x (K, 6, H, W): normalized RGB, previous mask, positive and
        negative scribbles; gt (K, 1, H, W)) numpy."""
        h, w = self.hw
        x, gt, _ = s2m_example(seed, h, w, self.k)
        x = np.concatenate([im_normalize(x[..., :3]), x[..., 3:]], axis=-1)
        return x.transpose(0, 3, 1, 2), gt.transpose(0, 3, 1, 2)

    def loss(self, x: torch.Tensor,
             gt: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.net(x)
        return _bce_logits(logits, gt), _soft_iou(torch.sigmoid(logits), gt)


class FBRSPretrainer(_Pretrainer):
    """Adam on the whole f-BRS click model (DistMaps, rgb_conv,
    DeepLabV3+, SepConvHead) with the normalized focal loss, on
    synthetic single-object click samples (generation/synthetic.py::
    fbrs_example). The default tower is the bottleneck ResNet-50, which
    trains through FrozenBatchNorm's (0, 1) statistics; the basic-block
    ResNet-34 saturates its head after one step there (the JAX package's
    round-5 measurement). `calibrate_bn=True` writes measured input
    statistics into every FrozenBatchNorm (calibrate_frozen_bn, 10
    iterations on the first batch) after a random init. `net` may be
    either f-BRS family (FBRSDeepLabModel or FBRSHRNetModel).

    init_flavor: None or 'default' (flax's defaults), or 'gluon' (the
    reference's from-scratch distribution, models/initializer.py)."""

    def __init__(self, net: Optional[torch.nn.Module] = None,
                 params: Optional[StateDict] = None, lr: float = 2e-4,
                 hw: Tuple[int, int] = (192, 192),
                 num_objects: int = 1,  # single-object task (API parity
                 seed: int = 0,         # with the other pretrainers)
                 n_points: int = 8, batch: int = 4,
                 init_flavor: Optional[str] = None,
                 calibrate_bn: bool = False, device="cuda"):
        self.net = net or FBRSDeepLabModel(arch="resnet50", ch=128)
        self.hw, self.p, self.batch = tuple(hw), n_points, batch
        self.device = torch.device(device)
        _prepare(self.net, params, seed, self.device, init_flavor or "default")
        if params is None and calibrate_bn:
            imgs, pts, _ = self._to_device(*self.make_batch(seed))
            calibrate_frozen_bn(self.net, lambda: self.net(imgs, pts), iters=10)
        self._setup_optimizer(lr)

    def make_batch(self, seed: int):
        """(imgs (B, 3, H, W) normalized, points (B, 2P, 2), gts
        (B, 1, H, W)) numpy; sample b of step `seed` is
        fbrs_example(seed * batch + b)."""
        h, w = self.hw
        imgs, gts, pts = [], [], []
        for b in range(self.batch):
            im, gt, pt = fbrs_example(seed * self.batch + b, h, w,
                                      n_points=self.p)
            imgs.append(im_normalize(im).transpose(2, 0, 1))
            gts.append(gt[None])
            pts.append(pt)
        return (np.stack(imgs), np.stack(pts),
                np.stack(gts).astype(np.float32))

    def loss(self, imgs: torch.Tensor, pts: torch.Tensor,
             gts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        logits = self.net(imgs, pts)                       # (B, 1, H, W)
        nfl = normalized_focal_loss(logits, gts).mean()
        return nfl, _soft_iou(torch.sigmoid(logits), gts)



class _HostBatches(torch.utils.data.Dataset):
    """(seed, trainer.host_batch(seed)) for each of `seeds`, built in the
    DataLoader's worker processes."""

    def __init__(self, trainer: _Pretrainer, seeds: Sequence[int]):
        self.trainer, self.seeds = trainer, list(seeds)

    def __len__(self) -> int:
        return len(self.seeds)

    def __getitem__(self, i: int):
        return self.seeds[i], self.trainer.host_batch(self.seeds[i])


def _as_is(item):
    return item


def batches(trainer: _Pretrainer, seeds: Sequence[int]) -> Iterator:
    """(seed, host batch) for each seed in order, the batches built by
    BATCH_WORKERS processes ahead of the training loop. A batch depends
    on its seed alone, so a run takes the steps the loop would take
    building each batch itself; on the card the host builds a 192x192
    propagation clip in about twice the device time of its step."""
    return iter(torch.utils.data.DataLoader(
        _HostBatches(trainer, seeds), batch_size=None,
        num_workers=BATCH_WORKERS, collate_fn=_as_is, prefetch_factor=2))
