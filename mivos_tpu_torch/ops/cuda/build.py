"""Build and load the hand-written CUDA kernels.

The sources under `mivos_tpu_torch/csrc/` are compiled with nvcc for
Hopper (`sm_90a`) into a shared library with a plain C interface, loaded
with ctypes. The build runs at first use into `mivos_tpu_torch/_build/`
(listed in .gitignore), keyed by a hash of the sources and flags, so a
fresh checkout builds everything from the repository alone. No
`--use_fast_math`: expf and FMA contraction must match the plain
PyTorch versions.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("memory_read.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "mr_hilo_planes": [_VP, _LL, _I, _I, _I, _VP, _VP, _VP],
    "mr_candidates_hilo": [_VP] * 6 + [_I] * 4 + [_VP],
    "mr_candidates_bf16": [_VP, _VP, _VP, _LL, _VP, _VP, _I, _I, _I, _I, _VP],
    "mr_candidates_merge": [_VP, _VP, _I, _I, _I, _I, _VP],
    "mr_refine_hilo": [_VP] * 7 + [_I] * 4 + [_VP],
    "mr_refine_bf16": [_VP, _VP, _VP, _LL, _VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "mr_refine_merge": [_VP, _VP, _VP, _I, _I, _I, _I, _VP],
    "mr_readout_hilo": [_VP] * 10 + [_I] * 4 + [_VP],
    "mr_readout_bf16": [_VP, _VP, _VP, _LL, _VP, _LL, _VP, _VP, _VP, _VP, _I,
                        _I, _I, _I, _VP],
    "mr_readout_merge": [_VP, _VP, _VP, _I, _I, _I, _VP],
}


class KernelLibrary:
    """The loaded kernel library plus what its build reported. `missing`
    names the functions of the C interface the library does not export
    (an older source, built for an A/B); the package's library has all."""

    def __init__(self, path: Path, build_seconds: float, log: str):
        self.path = path
        self.build_seconds = build_seconds  # 0.0 when the build was cached
        self.log = log                      # nvcc/ptxas output of the build
        self.lib = ctypes.CDLL(str(path))
        self.missing = [name for name in _SIGNATURES if not hasattr(self.lib, name)]
        for name, argtypes in _SIGNATURES.items():
            if name not in self.missing:
                fn = getattr(self.lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int


def _find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library(sources: Sequence[Path], so: Path) -> KernelLibrary:
    """Compile `sources` with NVCC_FLAGS into the shared library `so`
    unless it exists, then load it. Raises RuntimeError when nvcc is
    missing or the build fails."""
    seconds, log = 0.0, ""
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.parent / f".{so.name}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{log}")
        os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    return KernelLibrary(so, seconds, log)


@functools.cache
def load_library() -> KernelLibrary:
    """Build (once per source hash) and load the kernel library, once per
    process: every kernel launch asks for it, and hashing the sources
    each time would cost the host ~0.1 ms per memory read. Raises
    RuntimeError when nvcc is missing, the build fails or the library
    lacks a function of the C interface."""
    lib = build_library([CSRC / s for s in SOURCES],
                        BUILD_DIR / f"libmivos_kernels_{source_hash()}.so")
    if lib.missing:
        raise RuntimeError(f"{lib.path} does not export {lib.missing}")
    return lib
