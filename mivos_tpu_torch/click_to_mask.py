"""Interactive click segmentation (f-BRS) of one image (counterpart of
examples/click_to_mask.py).

  python -m mivos_tpu_torch.click_to_mask --image photo.jpg \
      --fbrs_model saves/fbrs.pth --clicks "120,340,+ 80,500,-" \
      --output mask.png

Click syntax: "y,x,+" is positive (object), "y,x,-" negative
(background), space-separated. --brs_mode: NoBRS, f-BRS-A, f-BRS-B,
f-BRS-C, RGB-BRS or DistMap-BRS (reference
fbrs/inference/predictors/__init__.py). --fbrs_model is a reference
f-BRS checkpoint of either family, DeepLab or HRNet-OCR, detected from
its keys. Without it the model is the reference GUI's resnet50_dh128
with random weights from a fixed seed (a pipeline smoke test). --device cuda
(the default) needs a CUDA device and fails without one. Reading and
writing images needs PIL.
"""
import argparse

import numpy as np
import torch

from mivos_tpu_torch.data.transforms import im_normalize
from mivos_tpu_torch.interactive.clicker import Click, Clicker
from mivos_tpu_torch.interactive.fbrs_predictor import BRS_MODES, get_predictor
from mivos_tpu_torch.utils.palette import save_indexed_png


def parse_clicks(spec):
    clicks = []
    for tok in spec.split():
        try:
            y, x, sign = tok.split(",")
            if sign not in ("+", "-"):
                raise ValueError(sign)
            clicks.append((float(y), float(x), sign == "+"))
        except ValueError:
            raise SystemExit(f'bad click "{tok}": expected "y,x,+" or '
                             f'"y,x,-" (e.g. "120,340,+ 80,500,-")')
    if not clicks:
        raise SystemExit('no clicks given: pass at least one "y,x,+" token '
                         'in --clicks')
    return clicks


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--fbrs_model")
    p.add_argument("--clicks", required=True, help='e.g. "120,340,+ 80,500,-"')
    p.add_argument("--brs_mode", default="f-BRS-B", choices=BRS_MODES)
    p.add_argument("--zoom_target", type=int, default=480)
    p.add_argument("--output", default="mask.png")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, cuda:N, cpu)")
    return p.parse_args(argv)


def build_net(fbrs_model):
    if fbrs_model:
        from mivos_tpu_torch.checkpoint.pth import read_state_dict
        from mivos_tpu_torch.models import build_fbrs_from_state_dict
        return build_fbrs_from_state_dict(read_state_dict(fbrs_model))
    from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
    from mivos_tpu_torch.models.initializer import init_params
    print("warning: random weights (no --fbrs_model)")
    return init_params(FBRSDeepLabModel("resnet50", ch=128),
                       torch.Generator().manual_seed(0))


def main(argv=None):
    args = parse_args(argv)
    clicks = parse_clicks(args.clicks)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is available")
    from PIL import Image

    img = np.asarray(Image.open(args.image).convert("RGB"))
    net = build_net(args.fbrs_model)
    pred = get_predictor(net, args.brs_mode,
                         zoom_in_params={"target_size": args.zoom_target},
                         device=device)
    pred.set_input_image(im_normalize(img))
    clicker = Clicker()
    prob = None
    for y, x, pos in clicks:
        clicker.add_click(Click(pos, (y, x)))
        prob = pred.get_prediction(clicker).cpu().numpy()
        print(f"click ({y:.0f},{x:.0f},{'+' if pos else '-'}): "
              f"fg {float((prob > 0.5).mean()):.1%}")
    save_indexed_png(args.output, (prob > 0.5).astype(np.uint8))
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
