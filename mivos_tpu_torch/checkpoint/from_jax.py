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
Sequential indices (`convert_s2m`, :156-172), and a trainable
SyncBatchNorm's `scale`/`bias` params and `batch_stats` `mean`/`var`
-> (weight, bias, running_mean, running_var). FBRSDeepLabModel has a
table of its own (`fbrs_state_dict_from_flax`, the inverse of
`convert_fbrs`, :177-225), so no FusionNet rule touches its names, and so
has FBRSHRNetModel (`fbrs_hrnet_state_dict_from_flax`, the inverse of
`convert_fbrs_hrnet`, :228-278). The
port's module names are the reference's, so the result loads with
strict=True and feeds straight back into convert.py. Shapes come from
the tree, so a slim decoder (`dec_width=0.5`) maps as the reference one
does, into a PropagationNetwork built with the same dec_width; a bare
ResNet50 tree (`stem_bias` included) maps with
`resnet_state_dict_from_flax`. Operates on numpy
arrays; no jax import.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_BN_INV = {"scale": "weight", "bias": "bias", "mean": "running_mean",
           "var": "running_var"}

# (regex, replacement) on dotted flax paths, applied in order.
_RESNET_RULES = (
    (r"\.layer(\d)\.block(\d+)\.", r".layer\1.\2."),
    (r"\.downsample_conv\.", ".downsample.0."),
    (r"\.downsample_bn\.", ".downsample.1."),
)
_RULES = _RESNET_RULES + (
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
_FE = "feature_extractor"
_FBRS_RULES = _RESNET_RULES + (
    (r"^rgb_conv_0\.", "rgb_conv.0."),
    (r"^rgb_conv_bn\.", "rgb_conv.2."),
    (r"^rgb_conv_1\.", "rgb_conv.3."),
    (r"^backbone\.stem0\.", f"{_FE}.backbone.conv1.0."),
    (r"^backbone\.stem_bn0\.", f"{_FE}.backbone.conv1.1."),
    (r"^backbone\.stem1\.", f"{_FE}.backbone.conv1.3."),
    (r"^backbone\.stem_bn1\.", f"{_FE}.backbone.conv1.4."),
    (r"^backbone\.stem2\.", f"{_FE}.backbone.conv1.6."),
    (r"^backbone\.", f"{_FE}.backbone."),
    (r"^skip_project_conv\.", f"{_FE}.skip_project.skip_project.0."),
    (r"^skip_project_bn\.", f"{_FE}.skip_project.skip_project.1."),
    (r"^aspp\.b(\d)_conv\.", rf"{_FE}.aspp.concurent.\1.0."),
    (r"^aspp\.b(\d)_bn\.", rf"{_FE}.aspp.concurent.\1.1."),
    (r"^aspp\.pool_conv\.", f"{_FE}.aspp.concurent.4.gap.1."),
    (r"^aspp\.pool_bn\.", f"{_FE}.aspp.concurent.4.gap.2."),
    (r"^aspp\.project_conv\.", f"{_FE}.aspp.project.0."),
    (r"^aspp\.project_bn\.", f"{_FE}.aspp.project.1."),
    (r"^head_sep(\d)\.dw\.", rf"{_FE}.head.block.\1.body.0."),
    (r"^head_sep(\d)\.pw\.", rf"{_FE}.head.block.\1.body.1."),
    (r"^head_sep(\d)\.bn\.", rf"{_FE}.head.block.\1.body.2."),
    (r"^head_out\.", f"{_FE}.head.block.2."),
    (r"^sep_head(\d)\.dw\.", r"head.layers.\1.body.0."),
    (r"^sep_head(\d)\.pw\.", r"head.layers.\1.body.1."),
    (r"^sep_head(\d)\.bn\.", r"head.layers.\1.body.2."),
    (r"^sep_head_out\.", "head.layers.2."),
)

# FBRSHRNetModel (the inverse of `convert_fbrs_hrnet`, :228-278, with its
# fuse-layer `premap`: fuseI_J_convS/bnS -> fuse_layers.I.J.S.{0,1} for
# j < i, fuseI_J_conv/bn -> fuse_layers.I.J.{0,1} for j > i).
_FBRS_HRNET_RULES = (
    (r"^rgb_conv_0\.", "rgb_conv.0."),
    (r"^rgb_conv_bn\.", "rgb_conv.2."),
    (r"^rgb_conv_1\.", "rgb_conv.3."),
    (r"\.layer1_block(\d+)\.", r".layer1.\1."),
    (r"\.downsample_conv\.", ".downsample.0."),
    (r"\.downsample_bn\.", ".downsample.1."),
    # transition1's first branch is one Sequential; each new branch is a
    # Sequential holding one.
    (r"\.transition1_0_conv\.", ".transition1.0.0."),
    (r"\.transition1_0_bn\.", ".transition1.0.1."),
    (r"\.transition(\d)_(\d)_conv\.", r".transition\1.\2.0.0."),
    (r"\.transition(\d)_(\d)_bn\.", r".transition\1.\2.0.1."),
    (r"\.stage(\d)_m(\d+)\.branch(\d+)_block(\d+)\.",
     r".stage\1.\2.branches.\3.\4."),
    (r"\.stage(\d)_m(\d+)\.fuse(\d+)_(\d+)_conv(\d+)\.",
     r".stage\1.\2.fuse_layers.\3.\4.\5.0."),
    (r"\.stage(\d)_m(\d+)\.fuse(\d+)_(\d+)_bn(\d+)\.",
     r".stage\1.\2.fuse_layers.\3.\4.\5.1."),
    (r"\.stage(\d)_m(\d+)\.fuse(\d+)_(\d+)_conv\.",
     r".stage\1.\2.fuse_layers.\3.\4.0."),
    (r"\.stage(\d)_m(\d+)\.fuse(\d+)_(\d+)_bn\.",
     r".stage\1.\2.fuse_layers.\3.\4.1."),
    (r"\.conv3x3_ocr_conv\.", ".conv3x3_ocr.0."),
    (r"\.conv3x3_ocr_bn\.", ".conv3x3_ocr.1."),
    (r"\.ocr_distri_head\.proj_conv\.", ".ocr_distri_head.conv_bn_dropout.0."),
    (r"\.ocr_distri_head\.proj_bn\.", ".ocr_distri_head.conv_bn_dropout.1.0."),
    (r"\.ocr_distri_head\.f_(pixel|object|down|up)\.conv0\.",
     r".ocr_distri_head.object_context_block.f_\1.0."),
    (r"\.ocr_distri_head\.f_(pixel|object|down|up)\.bn0\.",
     r".ocr_distri_head.object_context_block.f_\1.1.0."),
    (r"\.ocr_distri_head\.f_(pixel|object|down|up)\.conv1\.",
     r".ocr_distri_head.object_context_block.f_\1.2."),
    (r"\.ocr_distri_head\.f_(pixel|object|down|up)\.bn1\.",
     r".ocr_distri_head.object_context_block.f_\1.3.0."),
    (r"\.aux_head_conv1\.", ".aux_head.0."),
    (r"\.aux_head_bn\.", ".aux_head.1."),
    (r"\.aux_head_conv2\.", ".aux_head.3."),
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


def state_dict_from_flax(params: Mapping,
                         rules=_RULES) -> Dict[str, torch.Tensor]:
    """Flax tree ({'params': ...} or the bare tree) of PropagationNetwork,
    FusionNet, S2MNetwork or AttentionReadNetwork (its modules carry the
    propagation names) -> the port's state_dict (fp32 torch tensors).
    `rules` renames the dotted flax paths. With a 'batch_stats'
    collection beside 'params', each module holding statistics there is
    a SyncBatchNorm: its scale becomes `weight`, its mean and var
    `running_mean` and `running_var`."""
    flat: Dict[str, np.ndarray] = {}
    synced = set()   # SyncBatchNorm module paths
    if "params" in params and isinstance(params["params"], Mapping):
        for path, val in _flatten(params.get("batch_stats", {})).items():
            module, leaf = path.rsplit(".", 1) if "." in path else ("", path)
            synced.add(module)
            flat[f"{module}.running_{leaf}" if module else f"running_{leaf}"] = val
        params = params["params"]
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _flatten(params).items():
        module, leaf = path.rsplit(".", 1) if "." in path else ("", path)
        if module in synced and leaf == "scale":
            path = f"{module}.weight" if module else "weight"
        flat[path] = val
    for path, val in flat.items():
        parts = path.split(".")
        parent, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        if "bn" in parent and leaf in _BN_INV:  # bn*, downsample_bn: FrozenBatchNorm
            parts[-1] = _BN_INV[leaf]
        elif leaf == "kernel" and val.ndim == 4:
            parts[-1] = "weight"
            val = val.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        name = ".".join(parts)
        for pat, rep in rules:
            name = re.sub(pat, rep, name)
        sd[name] = torch.from_numpy(np.array(val, np.float32, order="C"))
    return sd


def fbrs_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax tree of FBRSDeepLabModel -> the port's state_dict."""
    return state_dict_from_flax(params, _FBRS_RULES)


def fbrs_hrnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax tree of FBRSHRNetModel -> the port's state_dict."""
    return state_dict_from_flax(params, _FBRS_HRNET_RULES)


def resnet_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax tree of a bare ResNet50 (mivos_tpu/models/resnet.py) -> the
    state_dict of the port's ResNet50 with layer1_name="layer1"."""
    tree = params.get("params", params)
    sd = state_dict_from_flax({"net": tree}, _RESNET_RULES)   # the rules key on a parent
    return {name[len("net."):]: val for name, val in sd.items()}
