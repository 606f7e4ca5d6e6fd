"""Device mesh and process-group start-up (counterpart of
mivos_tpu/parallel/mesh.py).

Inference is one process over a mesh of devices, as JAX's single
controller is: a `Mesh` names its axes and holds a `torch.device` at each
position, and the sharded reads (parallel/sharded_memory.py) place one
tensor per position and copy between them explicitly. A mesh may repeat
a device (four entries of `cuda:0`, eight of `cpu`): the same program
then runs on one card or on the CPU, as the JAX tests run on XLA's
virtual host devices. Such a mesh is built only from an explicit
`devices=` list, never in place of devices that are missing.

Training is one process per device under torchrun (DDP, the reference's
NCCL substrate, reference train.py:27,96). The JAX module's
`batch_sharding` and `replicated` have no counterpart: each rank loads
its own share of the batch (data/loader.py::ShardedSampler), and DDP
keeps the replicas equal.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """`devices`: an object array of torch.device whose dimensions are
    the axes `axis_names`, major first."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-D devices for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as jax's Mesh.shape)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def sub(self, **index: int) -> "Mesh":
        """The mesh of the positions whose coordinate on each named axis
        is `index[axis]`; those axes drop out."""
        sl = tuple(index.get(a, slice(None)) for a in self.axis_names)
        return Mesh(self.devices[sl + (Ellipsis,)],   # an array, even 0-D
                    tuple(a for a in self.axis_names if a not in index))


def _grid(devs: Sequence[torch.device], shape: Tuple[int, ...]) -> np.ndarray:
    out = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        out[i] = torch.device(d)
    return out.reshape(shape)


def _available(devices: Optional[Sequence], n: int) -> list:
    """The first n of `devices` (repeats allowed: the caller named them),
    or of every CUDA device. Raises when there are fewer."""
    if devices is None:
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        what = "CUDA devices"
    else:
        devs = [torch.device(d) for d in devices]
        what = "devices listed"
    if len(devs) < n:
        raise ValueError(f"need {n} devices, have {len(devs)} {what}")
    return devs[:n]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data",
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first n_devices of `devices` (default: every
    CUDA device; n_devices default: all of them)."""
    if n_devices is None:
        n_devices = (torch.cuda.device_count() if devices is None
                     else len(devices))
    if n_devices < 1:
        raise ValueError(f"need at least one device, got n_devices={n_devices} "
                         f"({torch.cuda.device_count()} CUDA devices)")
    return Mesh(_grid(_available(devices, n_devices), (n_devices,)), (axis,))


def make_mesh_nd(*, devices: Optional[Sequence] = None, **axes: int) -> Mesh:
    """N-D mesh from axis=size keywords, e.g. make_mesh_nd(object=3,
    data=2), the 2D inference layout (MemoryConfig.object_sharded with
    bank_sharded). Axis order follows keyword order (major first)."""
    if not axes or any(v < 1 for v in axes.values()):
        raise ValueError(f"axis sizes must be >= 1, got {axes}")
    n = int(np.prod(list(axes.values())))
    return Mesh(_grid(_available(devices, n), tuple(axes.values())),
                tuple(axes))


def maybe_initialize_distributed(backend: str) -> Tuple[int, int]:
    """Start the default process group on `backend` from the environment
    torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and return
    (rank, world). A no-op returning (0, 1) when WORLD_SIZE is unset or 1.

    backend: "nccl" when each rank has a card of its own, "gloo" on the
    CPU. NCCL refuses two ranks on one device; gloo takes CPU tensors,
    and CUDA tensors in all_reduce and broadcast."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return 0, 1
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def device_scope(device: torch.device):
    """`device` as the thread's current CUDA device for the block (a
    no-op for the CPU). The current device is per thread, so each
    worker or handler thread sets it itself; the read kernels launch on
    the current device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
