"""Serving interactive VOS sessions over HTTP (counterpart of
mivos_tpu/serve/): a thread-safe session manager that pins sessions to
devices round-robin, with one prepared copy of the networks per device,
and a dependency-free HTTP front end (`python -m mivos_tpu_torch.serve`).
"""
from mivos_tpu_torch.serve.server import (SessionManager, VOSRequestHandler,
                                          make_server, shutdown_gracefully)

__all__ = ["SessionManager", "VOSRequestHandler", "make_server",
           "shutdown_gracefully"]
