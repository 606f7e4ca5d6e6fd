"""Networks: propagation, fusion, S2M and the f-BRS click model."""


def build_fbrs_from_state_dict(sd):
    """The f-BRS model a reference state dict describes, loaded with
    strict=True (counterpart of mivos_tpu/models/__init__.py:9-23;
    reference fbrs/inference/utils.py:21-100). DeepLab models only."""
    from mivos_tpu_torch.checkpoint.pth import detect_fbrs_model
    from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel

    info = detect_fbrs_model(sd)
    if info["kind"] != "deeplab":
        raise NotImplementedError(
            "the f-BRS HRNet-OCR model (models/hrnet.py) is not ported yet "
            "(ROADMAP queue 1, item 8)")
    net = FBRSDeepLabModel(arch=info["backbone"], ch=info["ch"])
    net.load_state_dict(sd, strict=True)
    return net
