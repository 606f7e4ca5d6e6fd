"""Training checkpoints on torch.save (counterpart of
mivos_tpu/checkpoint/manager.py, which keeps them with orbax; reference
model/fusion_model.py:133-188).

  CheckpointManager  full resume states ({it, network, optimizer,
                     scheduler}, `FusionTrainer.state_dict`), one file a
                     step, the newest `max_to_keep` kept.
  save_params        a weights-only snapshot: the FusionNet state_dict
                     under the reference's names, a `fusion.pth` that
                     `checkpoint/pth.py::load_reference_pth` loads (the
                     JAX package's `load_params`).

Files are written under a temporary name and renamed into place, so a
file that exists is complete; they load with weights_only=True.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

import torch

_NAME = re.compile(r"^checkpoint_(\d+)\.pth$")


def _save(obj: Any, path: str) -> None:
    tmp = path + ".__tmp__"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}.pth")

    def steps(self) -> List[int]:
        """Saved steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any]) -> None:
        os.makedirs(self.directory, exist_ok=True)
        _save(state, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self) -> Dict[str, Any]:
        """The latest saved state, on the CPU."""
        step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)


def save_params(path: str, module: torch.nn.Module) -> None:
    """Weights-only snapshot of `module` (reference save_model,
    fusion_model.py:133)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    _save(module.state_dict(), path)
