"""Every f-BRS mode, HRNet, the oracle and tiled inference on the card
against the CPU.

Needs an NVIDIA GPU: marked `cuda`, skipped without a card. Run on the
card with
`python -m pytest tests/test_torch_fbrs_modes_card.py --noconftest -q`.

The same random weights (DeepLab resnet34 ch 32 and HRNet-W18 OCR 64
small, drawn as the CPU parity tests draw theirs, the last logit conv
rescaled so the maps spread around the threshold, `_net`) and the same NoC clicks at 96x128, fp32 with TF32 off, through
get_predictor on the card and on the CPU: the first click's map within
1e-3 (fp32 convolutions in cuDNN's order against the CPU's), the same
clicks chosen, and mask (p > 0.49) IoU >= 0.99 after that, the bounds of
chip_smoke.py's f-BRS phases.
"""
import numpy as np
import pytest
import torch

from mivos_tpu_torch.interactive.clicker import Clicker
from mivos_tpu_torch.interactive.crops import TiledPredictor
from mivos_tpu_torch.interactive.fbrs_predictor import get_predictor
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.hrnet import FBRSHRNetModel
from mivos_tpu_torch.models.layers import FrozenBatchNorm

pytestmark = pytest.mark.cuda

H, W, CLICKS = 96, 128, 3
FIRST_ATOL, MASK_IOU = 1e-3, 0.99


@pytest.fixture(scope="module", autouse=True)
def _card_and_full_fp32():
    # Decided here, not at import or collection: every pytest-xdist
    # worker must collect the same tests.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = deterministic


def _net(family):
    """A random model drawn as the CPU parity tests draw theirs (conv
    weights normal over sqrt(fan in), conv biases normal 0.05, frozen-BN
    weight and running_var uniform in [0.5, 1.5], bias and running_mean
    normal 0.1), its last conv rescaled so that its logits for the frame
    and one centre click have median 0 and deviation 2. With such weights
    a 1e-6 perturbation of the frame moves these drives' maps by at most
    5e-3 on the CPU (scripts/torch_fbrs_sensitivity.py); a flax-style
    init with the same rescale made them chaotic, beyond what a card-
    against-CPU bound can resolve."""
    if family == "deeplab":
        net = FBRSDeepLabModel("resnet34", ch=32, norm_radius=40.0)
        last = net.head.layers[2]
    else:
        net = FBRSHRNetModel(18, 64, small=True, norm_radius=40.0)
        last = net.feature_extractor.cls_head
    rng = np.random.RandomState(7)

    def draw(shape, fn):
        return torch.from_numpy(fn(shape).astype(np.float32))

    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(draw(m.weight.shape,
                                    lambda s: rng.randn(*s) / np.sqrt(fan_in)))
                if m.bias is not None:
                    m.bias.copy_(draw(m.bias.shape, lambda s: rng.randn(*s) * 0.05))
            elif isinstance(m, FrozenBatchNorm):
                for name in ("weight", "running_var"):
                    getattr(m, name).copy_(draw(m.weight.shape,
                                                lambda s: rng.uniform(0.5, 1.5, s)))
                for name in ("bias", "running_mean"):
                    getattr(m, name).copy_(draw(m.weight.shape,
                                                lambda s: rng.randn(*s) * 0.1))
        image = torch.from_numpy(_frame()[0]).permute(2, 0, 1)[None]
        z = net.eval()(image, torch.tensor([[[H / 2, W / 2], [-1.0, -1.0]]]))
        a = 2.0 / float(z.std())
        last.weight.mul_(a)
        last.bias.mul_(a).sub_(a * float(z.median()))
    return net


def _frame():
    rng = np.random.RandomState(3)
    yy, xx = np.mgrid[:H, :W]
    gt = (((yy - 48) / 26) ** 2 + ((xx - 60) / 38) ** 2 <= 1).astype(np.int32)
    image = rng.randn(H, W, 3).astype(np.float32) * 0.5 + gt[..., None] * 0.8
    return image, gt


def _iou(a, b):
    """Mask IoU; two empty masks agree (1)."""
    union = np.logical_or(a, b).sum()
    return np.logical_and(a, b).sum() / union if union else 1.0


def _drive(make_predictor, family, devices=("cuda", "cpu")):
    """The NoC user's clicks and maps on the card and on the CPU."""
    image, gt = _frame()
    out = []
    for device in devices:
        pred = make_predictor(_net(family), device)
        pred.set_input_image(image)
        clicker, mask, maps = Clicker(gt), np.zeros(gt.shape, bool), []
        for _ in range(CLICKS):
            clicker.make_next_click(mask)
            maps.append(pred.get_prediction(clicker).cpu().numpy())
            mask = maps[-1] > 0.49
        out.append(([(c.is_positive, c.coords) for c in clicker.clicks_list], maps,
                    getattr(pred, "last_info", {})))
    (gc, gmaps, ginfo), (cc, cmaps, _) = out
    assert float(np.abs(gmaps[0] - cmaps[0]).max()) <= FIRST_ATOL
    assert gc == cc
    assert min(_iou(a > 0.49, b > 0.49) for a, b in zip(gmaps, cmaps)) >= MASK_IOU
    return ginfo


@pytest.mark.parametrize("family,brs_mode", [
    ("deeplab", "f-BRS-A"), ("deeplab", "f-BRS-C"), ("deeplab", "RGB-BRS"),
    ("deeplab", "DistMap-BRS"), ("hrnet", "NoBRS"), ("hrnet", "f-BRS-B"),
    ("hrnet", "f-BRS-C")])
def test_mode_card_matches_cpu(family, brs_mode):
    zoom = {"target_size": 96, "min_crop_size": 40}
    info = _drive(lambda net, d: get_predictor(net, brs_mode, zoom_in_params=zoom,
                                               device=d), family)
    assert (info["iters"] > 0) == (brs_mode != "NoBRS")


def test_oracle_card_matches_cpu():
    """The oracle at maxiter 5: at the default 20 its fit is chaotic (a
    1e-6 perturbation of the frame moves the port's own second map by
    0.28 on the CPU, against 3e-6 at 5; scripts/torch_fbrs_sensitivity.py),
    as in the CPU parity tests."""
    _, gt = _frame()

    def make(net, device):
        pred = get_predictor(net, "f-BRS-B", predictor_params={"maxiter": 5},
                             device=device)
        pred.set_oracle_gt(gt)
        return pred

    assert _drive(make, "deeplab")["iters"] > 0


def test_tiled_predictor_card_matches_cpu():
    """96x128 in 64x80 crops: 4 crops and their flips in one batch."""
    _drive(lambda net, d: TiledPredictor(net, crop_size=(64, 80), device=d),
           "deeplab")
