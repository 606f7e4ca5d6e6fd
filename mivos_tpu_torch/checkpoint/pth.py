"""Reference .pth checkpoints (propagation_model.pth, fusion.pth, s2m.pth,
the f-BRS click models) -> the port's modules. The port's module names
are the reference's, so the state_dicts load as they are."""
from __future__ import annotations

import re
from typing import Dict, Mapping, Union

import torch

# The propagation modules the training-time attention reader shares
# (mivos_tpu/checkpoint/convert.py:111-117).
ATTENTION_READ_PREFIXES = ("mask_rgb_encoder.", "rgb_encoder.", "kv_m_f16.",
                           "kv_q_f16.")


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


def attention_read_state_dict(
        source: Union[str, Mapping[str, torch.Tensor], torch.nn.Module]
) -> Dict[str, torch.Tensor]:
    """The AttentionReadNetwork's weights from a propagation network: a
    reference `propagation_model.pth` path, a propagation state_dict
    (from `read_state_dict` or `state_dict_from_flax`), or the port's
    PropagationNetwork. Only the four shared modules are kept, in fp32,
    so that the reader loads them with strict=True: the reference's
    strict=False load (fusion_model.py:185-188) made explicit."""
    if isinstance(source, str):
        source = read_state_dict(source)
    elif isinstance(source, torch.nn.Module):
        source = source.state_dict()
    sd = {k: v.detach().to(torch.float32) for k, v in source.items()
          if k.startswith(ATTENTION_READ_PREFIXES)}
    missing = [p for p in ATTENTION_READ_PREFIXES
               if not any(k.startswith(p) for k in sd)]
    if missing:
        raise KeyError(f"propagation weights lack {missing}")
    return sd


def detect_fbrs_model(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The f-BRS architecture of a reference state dict (the port's copy
    of mivos_tpu/checkpoint/convert.py:281-314; reference
    fbrs/inference/utils.py:21-100). Returns 'kind' ('deeplab' | 'hrnet')
    and the model's constructor kwargs: for DeepLab the backbone and ch,
    for HRNet the width, the OCR width and `small` (two layer1 blocks)."""
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
        width = int(sd["feature_extractor.transition1.0.0.weight"].shape[0])
        ocr = int(sd["feature_extractor.conv3x3_ocr.0.weight"].shape[0]) // 2
        layer1 = re.compile(r"feature_extractor\.layer1\.(\d+)\.")
        blocks = 1 + max(int(m.group(1)) for m in map(layer1.match, keys) if m)
        return {"kind": "hrnet", "width": width, "ocr_width": ocr,
                "small": blocks == 2}
    raise ValueError("unrecognized fbrs checkpoint")
