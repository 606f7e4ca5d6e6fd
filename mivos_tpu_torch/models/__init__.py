"""Networks: propagation, fusion, S2M and the f-BRS click models."""


def build_fbrs_from_state_dict(sd):
    """The f-BRS model a reference state dict describes, DeepLab or
    HRNet-OCR, loaded with strict=True (counterpart of
    mivos_tpu/models/__init__.py:9-23; reference
    fbrs/inference/utils.py:21-100)."""
    from mivos_tpu_torch.checkpoint.pth import detect_fbrs_model
    from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
    from mivos_tpu_torch.models.hrnet import FBRSHRNetModel

    info = detect_fbrs_model(sd)
    if info["kind"] == "deeplab":
        net = FBRSDeepLabModel(arch=info["backbone"], ch=info["ch"])
    else:
        net = FBRSHRNetModel(width=info["width"], ocr_width=info["ocr_width"],
                             small=info["small"])
    net.load_state_dict(sd, strict=True)
    return net
