"""Hand-written CUDA kernels: build, bindings and wrappers."""
