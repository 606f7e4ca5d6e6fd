"""mivos_tpu_torch: the PyTorch/CUDA port of mivos_tpu for NVIDIA Hopper.

Mirrors the JAX package's module paths and public names (a reader finds
each counterpart at the same relative path under `mivos_tpu/`). Plain
tensor code is PyTorch; the fused top-k memory read is a CUDA C++ kernel
(`csrc/memory_read.cu`) built at first use and bound through ctypes
(`ops/cuda/`). This package imports neither jax nor mivos_tpu: the GPU
machine has no jax, so what the port needs is carried here.
"""

__version__ = "0.1.0"
