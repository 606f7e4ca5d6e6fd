"""Reference .pth checkpoints (propagation_model.pth, fusion.pth, s2m.pth)
-> the port's modules. The port's module names are the reference's, so
the state_dicts load as they are."""
from __future__ import annotations

import torch


def load_reference_pth(module: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference .pth into `module` with strict=True. Training
    checkpoints nest the weights under "network"; BatchNorm's
    `num_batches_tracked` counters have no counterpart in
    FrozenBatchNorm and are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("network"), dict):
        sd = sd["network"]
    sd = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    module.load_state_dict(sd, strict=True)
    return module
