"""Where the click model's IoU goes after the first click: the NoC
trajectories of one trained f-BRS weight set through both packages (CPU)
or through the port's predictor modes (card).

--device cpu (the witness; needs JAX): FBRSPretrainer trains the port's
FBRSDeepLabModel("resnet50", ch=128) for --steps at --hw on the CPU
(noc_synthetic.train; cached under --dir), the weights go to the JAX
package through checkpoint/convert.py, and the same --eval-n held-out
scenes run through the port's `noc_synthetic.evaluate` (f-BRS-B, ZoomIn
--hw, L-BFGS maxiter 20, up to --max-clicks clicks) and the JAX script's
main (scripts/noc_synthetic.py with --weights, so it trains nothing).
Prints both packages' trajectories, scene by scene.

--device cuda (no JAX): `python -m mivos_tpu_torch.noc_synthetic
--train-steps --steps` on the card, its report to --dir, then on the
same weights (kept in the temporary directory) `evaluate` under NoBRS and
under f-BRS-B with cuDNN's TF32 off; prints each report.

Usage, from the repository root:
  PYTHONPATH=. python scripts/torch_noc_witness.py --device cpu [--hw 96] [--steps 300]
  PYTHONPATH=. python scripts/torch_noc_witness.py --device cuda [--hw 192] [--steps 600]
"""
import argparse
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import torch

from mivos_tpu_torch import noc_synthetic
from mivos_tpu_torch.checkpoint.manager import save_params
from mivos_tpu_torch.checkpoint.pth import load_reference_pth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def show(name, rep):
    print(name, json.dumps({k: v for k, v in rep.items() if k != "trajectories"}), flush=True)


def card(args):
    pth = os.path.join(tempfile.gettempdir(), f"fbrs_{args.hw}_{args.steps}.pth")
    try:
        noc_synthetic.main(["--train-steps", str(args.steps), "--hw", str(args.hw),
                            "--weights", pth, "--out", os.path.join(args.dir, "noc.json")])
    except RuntimeError as e:   # its asserts: reported here, not fatal
        print("noc_synthetic:", e, flush=True)
    net = load_reference_pth(noc_synthetic.make_net(), pth)
    for name, mode, tf32 in (("NoBRS", "NoBRS", True), ("f-BRS-B_tf32_off", "f-BRS-B", False)):
        torch.backends.cudnn.allow_tf32 = tf32
        rep = noc_synthetic.evaluate(net, (args.hw, args.hw), args.eval_n, mode,
                                     args.max_clicks, 20, "cuda")
        show(name, rep)
        with open(os.path.join(args.dir, f"noc_{name}.json"), "w") as f:
            json.dump(rep, f)


def witness(args):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mivos_tpu.checkpoint.convert import convert_fbrs
    from mivos_tpu.checkpoint.npz import save_params_npz

    torch.set_num_threads(args.threads)
    stem = os.path.join(args.dir, f"fbrs_{args.hw}_{args.steps}")
    if not os.path.exists(stem + ".pth"):
        net = noc_synthetic.train(noc_synthetic.make_net(), (args.hw, args.hw), args.steps,
                                  2e-4, "cpu", log=lambda *a: print(*a, flush=True))
        save_params(stem + ".pth", net)
        save_params_npz(stem + ".npz", convert_fbrs(
            {k: v.detach().numpy() for k, v in net.state_dict().items()}))
    net = load_reference_pth(noc_synthetic.make_net(), stem + ".pth")
    got = noc_synthetic.evaluate(net, (args.hw, args.hw), args.eval_n, "f-BRS-B",
                                 args.max_clicks, 20, "cpu")
    show("port", got)
    spec = importlib.util.spec_from_file_location(
        "jax_noc_synthetic", os.path.join(ROOT, "scripts", "noc_synthetic.py"))
    jnoc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jnoc)
    out = os.path.join(args.dir, "noc_jax.json")
    sys.argv = ["noc_synthetic.py", "--eval-n", str(args.eval_n), "--hw", str(args.hw),
                "--max-clicks", str(args.max_clicks), "--weights", stem + ".npz", "--out", out]
    try:
        jnoc.main()
    except AssertionError as e:   # its asserts: reported here, not fatal
        print("JAX noc_synthetic assert:", str(e)[:200], flush=True)
    with open(out) as f:
        ref = json.load(f)
    for i, (g, r) in enumerate(zip(got["trajectories"], ref["trajectories"])):
        print(f"scene {i} port", np.round(g, 3).tolist(), flush=True)
        print(f"scene {i} jax ", np.round(r, 3).tolist(), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--hw", type=int, default=None, help="default: 96 on cpu, 192 on cuda")
    ap.add_argument("--steps", type=int, default=None, help="default: 300 on cpu, 600 on cuda")
    ap.add_argument("--eval-n", type=int, default=None, help="default: 4 on cpu, 20 on cuda")
    ap.add_argument("--max-clicks", type=int, default=None, help="default: 6 on cpu, 20 on cuda")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--dir", default=os.path.join("chiprun_out", "noc_witness"))
    args = ap.parse_args()
    cpu = args.device == "cpu"
    for key, on_cpu, on_card in (("hw", 96, 192), ("steps", 300, 600), ("eval_n", 4, 20),
                                 ("max_clicks", 6, 20)):
        if getattr(args, key) is None:
            setattr(args, key, on_cpu if cpu else on_card)
    os.makedirs(args.dir, exist_ok=True)
    witness(args) if cpu else card(args)


if __name__ == "__main__":
    main()
