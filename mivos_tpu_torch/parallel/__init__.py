"""Parallelism (counterpart of mivos_tpu/parallel): device meshes, the
sharded memory reads and the multi-device dry run. Training's data
parallelism is DDP under torchrun (train/)."""
from mivos_tpu_torch.parallel.mesh import (Mesh, make_mesh, make_mesh_nd,
                                           maybe_initialize_distributed)
from mivos_tpu_torch.parallel.sharded_memory import (shard_bank,
                                                     sharded_memory_read)

__all__ = ["Mesh", "make_mesh", "make_mesh_nd", "maybe_initialize_distributed",
           "shard_bank", "sharded_memory_read"]
