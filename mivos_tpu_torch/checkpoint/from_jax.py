"""Weight bridge: the JAX package's flax parameter trees -> this port's
state_dicts.

The exact inverse of mivos_tpu/checkpoint/convert.py (torch .pth ->
flax): conv kernels HWIO -> OIHW (`_conv_kernel`, :39), FrozenBatchNorm
(scale, bias, mean, var) -> (weight, bias, running_mean, running_var)
(`_BN_MAP`, :52), `layerN/blockM` -> `layerN.M` and
`downsample_{conv,bn}` -> `downsample.{0,1}` (`_RESNET_RULES`, :92-96),
`rgb_encoder/layer1` -> `rgb_encoder.res2` (:104-106), and FusionNet's
`conv1`, `conv2_0/1`, `conv3_0/1` -> the reference Sequential indices
(:139-145), and S2MNetwork's DeepLab head (`project`, `aspp.b0-b3`,
`aspp.pool_conv`, `aspp.project`, `classifier0/1`) -> the reference
Sequential indices (`convert_s2m`, :156-172). The port's module names
are the reference's, so the result loads with strict=True and feeds
straight back into convert.py. Operates on numpy arrays; no jax import.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BN_INV = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}

# (regex, replacement) on dotted flax paths, applied in order.
_RULES = (
    (r"\.layer(\d)\.block(\d+)\.", r".layer\1.\2."),
    (r"\.downsample_conv\.", ".downsample.0."),
    (r"\.downsample_bn\.", ".downsample.1."),
    (r"^rgb_encoder\.layer1\.", "rgb_encoder.res2."),
    (r"^conv1\.(weight|bias)$", r"conv1.0.\1"),
    (r"^conv2_0\.", "conv2.0."),
    (r"^conv2_1\.", "conv2.2."),
    (r"^conv3_0\.", "conv3.0."),
    (r"^conv3_1\.", "conv3.2."),
    (r"^classifier\.project\.conv\.", "classifier.project.0."),
    (r"^classifier\.project\.bn\.", "classifier.project.1."),
    (r"^classifier\.aspp\.b(\d)\.conv\.", r"classifier.aspp.convs.\1.0."),
    (r"^classifier\.aspp\.b(\d)\.bn\.", r"classifier.aspp.convs.\1.1."),
    (r"^classifier\.aspp\.pool_conv\.conv\.", "classifier.aspp.convs.4.1."),
    (r"^classifier\.aspp\.pool_conv\.bn\.", "classifier.aspp.convs.4.2."),
    (r"^classifier\.aspp\.project\.conv\.", "classifier.aspp.project.0."),
    (r"^classifier\.aspp\.project\.bn\.", "classifier.aspp.project.1."),
    (r"^classifier\.classifier0\.conv\.", "classifier.classifier.0."),
    (r"^classifier\.classifier0\.bn\.", "classifier.classifier.1."),
    (r"^classifier\.classifier1\.", "classifier.classifier.3."),
)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax tree ({'params': ...} or the bare tree) of PropagationNetwork,
    FusionNet or S2MNetwork -> the port's state_dict (fp32 torch
    tensors)."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(params).items():
        parts = path.split(".")
        parent, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        if "bn" in parent:  # bn*, downsample_bn: FrozenBatchNorm only
            parts[-1] = _BN_INV[leaf]
        elif leaf == "kernel" and val.ndim == 4:
            parts[-1] = "weight"
            val = val.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        name = ".".join(parts)
        for pat, rep in _RULES:
            name = re.sub(pat, rep, name)
        sd[name] = torch.from_numpy(np.array(val, np.float32, order="C"))
    return sd
