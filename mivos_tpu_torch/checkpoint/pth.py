"""Reference .pth checkpoints (propagation_model.pth, fusion.pth, s2m.pth,
the f-BRS click models) -> the port's modules. The port's module names
are the reference's, so the state_dicts load as they are."""
from __future__ import annotations

from typing import Dict, Mapping

import torch


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference .pth as a flat state_dict. Training checkpoints nest
    the weights under "network"; BatchNorm's `num_batches_tracked`
    counters have no counterpart in FrozenBatchNorm and are dropped."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd.get("network"), dict):
        sd = sd["network"]
    return {k: v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


def load_reference_pth(module: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a reference .pth into `module` with strict=True."""
    module.load_state_dict(read_state_dict(path), strict=True)
    return module


def detect_fbrs_model(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The f-BRS architecture of a reference state dict (the port's copy
    of mivos_tpu/checkpoint/convert.py:281-306; reference
    fbrs/inference/utils.py:21-100). Returns 'kind' ('deeplab' |
    'hrnet') and, for DeepLab, its constructor kwargs; the HRNet model
    is not ported, so its widths are not read."""
    keys = sd.keys()
    if any(k.startswith("feature_extractor.backbone") for k in keys):
        # Depth from the backbone's parameter count (utils.py:69-80; past
        # 531, resnet152, which the reference builds but cannot detect).
        n_bb = len([k for k in keys
                    if k.startswith("feature_extractor.backbone")
                    and "num_batches_tracked" not in k])
        if n_bb <= 181:
            arch = "resnet34"
        elif n_bb <= 276:
            arch = "resnet50"
        elif n_bb <= 531:
            arch = "resnet101"
        else:
            arch = "resnet152"
        # deeplab_ch from the ASPP projection width (utils.py:85-88).
        ch = int(sd["feature_extractor.aspp.project.0.weight"].shape[0])
        return {"kind": "deeplab", "backbone": arch, "ch": ch}
    if any(".stage2." in k or k.startswith("feature_extractor.stage2")
           for k in keys):
        return {"kind": "hrnet"}
    raise ValueError("unrecognized fbrs checkpoint")
