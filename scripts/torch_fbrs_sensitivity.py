"""How far the port's f-BRS drives move under float32 noise, beside how far
the card moves them from the CPU.

For each f-BRS mode the NoC user clicks through get_predictor on the
random models of tests/test_torch_fbrs_modes_card.py (96x128, fp32, TF32
off, deterministic cuDNN plans): once on --device, once on the CPU, and
once on the CPU with 1e-6 of normal noise added to the frame. The CPU
map drives every copy's next click. One JSON line per click: the device's
max |dp| against the CPU, the noisy CPU's (the drive's own sensitivity),
the mask IoU, each copy's L-BFGS iterations. A device map that parts
from the CPU's by about as much as the noise moves the CPU's own map
parts by float32 rounding the drive amplifies, not by a fault.

    PYTHONPATH=. python scripts/torch_fbrs_sensitivity.py --device cuda
    PYTHONPATH=. python scripts/torch_fbrs_sensitivity.py --device cpu \
        --oracle_maxiter 20 5
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
import test_torch_fbrs_modes_card as card  # noqa: E402
from mivos_tpu_torch.interactive.clicker import Clicker  # noqa: E402
from mivos_tpu_torch.interactive.fbrs_predictor import get_predictor  # noqa: E402

MODES = (("deeplab", "f-BRS-A"), ("deeplab", "f-BRS-C"), ("deeplab", "RGB-BRS"),
         ("deeplab", "DistMap-BRS"), ("hrnet", "f-BRS-B"), ("hrnet", "f-BRS-C"))
ZOOM = {"target_size": 96, "min_crop_size": 40}


def drive(family, mode, device, oracle_maxiter=None):
    image, gt = card._frame()
    noise = np.random.RandomState(0).randn(*image.shape).astype(np.float32)
    copies = {"device": (device, image), "cpu": ("cpu", image),
              "cpu_noise": ("cpu", image + np.float32(1e-6) * noise)}
    preds = {}
    for name, (dev, frame) in copies.items():
        if oracle_maxiter is None:
            pred = get_predictor(card._net(family), mode, zoom_in_params=ZOOM,
                                 device=dev)
        else:
            pred = get_predictor(card._net(family), "f-BRS-B", device=dev,
                                 predictor_params={"maxiter": oracle_maxiter})
        pred.set_input_image(frame)
        if oracle_maxiter is not None:
            pred.set_oracle_gt(gt)
        preds[name] = pred
    clicker, mask = Clicker(gt), np.zeros(gt.shape, bool)
    for i in range(card.CLICKS):
        clicker.make_next_click(mask)
        maps = {n: p.get_prediction(clicker).cpu().numpy() for n, p in preds.items()}
        cpu = maps["cpu"]
        print(json.dumps({
            "family": family,
            "mode": mode if oracle_maxiter is None else f"oracle maxiter {oracle_maxiter}",
            "click": i, "coords": clicker.clicks_list[-1].coords,
            "device_max_abs_dp": float(np.abs(maps["device"] - cpu).max()),
            "noise_max_abs_dp": float(np.abs(maps["cpu_noise"] - cpu).max()),
            "device_mask_iou": float(card._iou(maps["device"] > 0.49, cpu > 0.49)),
            "iters": {n: p.last_info["iters"] for n, p in preds.items()}}), flush=True)
        mask = cpu > 0.49


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--oracle_maxiter", type=int, nargs="*", default=[5])
    args = p.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    for family, mode in MODES:
        drive(family, mode, args.device)
    for maxiter in args.oracle_maxiter:
        drive("deeplab", None, args.device, maxiter)


if __name__ == "__main__":
    main()
