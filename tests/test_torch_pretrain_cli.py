"""The port's pretraining on the CPU: the JAX package's descent tests
(tests/test_pretrain.py) mirrored on the port's trainers, and the
two entry points, `python -m mivos_tpu_torch.pretrain_synthetic` (every
net, strict loads of its .pth, --resume's merged log, a prior entry
with no steps) and `python -m mivos_tpu_torch.train_fusion_synthetic`
at a toy size.
"""
import json
import os
import subprocess
import sys
from os import path

import jax
import numpy as np
import pytest
import torch

from mivos_tpu.models.fbrs import FBRSDeepLabModel as JFBRS
from mivos_tpu_torch import pretrain_synthetic, train_fusion_synthetic
from mivos_tpu_torch.checkpoint.from_jax import fbrs_state_dict_from_flax
from mivos_tpu_torch.checkpoint.manager import save_params
from mivos_tpu_torch.checkpoint.pth import load_reference_pth, read_state_dict
from mivos_tpu_torch.models import build_fbrs_from_state_dict
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.train.pretrain import (FBRSPretrainer, PropPretrainer,
                                            S2MPretrainer, batches)

REPO = path.dirname(path.dirname(path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- descent

def test_prop_pretrain_descends():
    tr = PropPretrainer(hw=(48, 48), num_objects=2, lr=1e-3, device="cpu")
    # Overfit one fixed example; Adam's fresh-net transient spikes the
    # first steps, so require recovery below the start.
    losses = [tr.step(3)[0] for _ in range(12)]
    assert all(np.isfinite(losses))
    assert min(losses[-3:]) < losses[0]


def test_prop_pretrain_chained_descends_and_resumes():
    """chain_steps=2 descends from the single-step trainer's weights (the
    same state_dict names, so --resume can switch curricula)."""
    tr1 = PropPretrainer(hw=(48, 48), num_objects=2, lr=1e-3, device="cpu")
    tr = PropPretrainer(hw=(48, 48), num_objects=2, lr=1e-3, chain_steps=2,
                        params=tr1.state_dict(), device="cpu")
    losses = [tr.step(3)[0] for _ in range(12)]
    assert all(np.isfinite(losses))
    assert min(losses[-3:]) < losses[0]


def test_prop_pretrain_mixed_curriculum():
    tr = PropPretrainer(hw=(48, 48), num_objects=2, lr=1e-3, chain_mix=(1, 2),
                        device="cpu")
    assert [tr.pick_chain(s) for s in range(5)] == [1, 2, 1, 2, 1]
    assert tr.chain == 2
    losses = [tr.step(s)[0] for s in range(4)]
    assert all(np.isfinite(losses))
    tr1 = PropPretrainer(hw=(48, 48), num_objects=2, chain_steps=2, device="cpu")
    assert tr1.mix == (2,) and tr1.pick_chain(17) == 2


def test_s2m_pretrain_descends_and_roundtrips(tmp_path):
    tr = S2MPretrainer(hw=(48, 48), num_objects=2, lr=1e-3, device="cpu")
    losses = [tr.step(3)[0] for _ in range(4)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    p = str(tmp_path / "s2m.pth")
    save_params(p, tr.net)
    net = load_reference_pth(S2MNetwork(), p)
    for k, v in tr.state_dict().items():
        assert torch.equal(net.state_dict()[k], v), k


def test_fbrs_pretrain_descends():
    """From the JAX test's own initial weights (flax's init from
    PRNGKey(0), carried over): the bottleneck tower bounces before it
    descends, and whether it recovers depends on the draw. From the
    port's seed-0 draw both packages take the same steps to a head
    saturated at -log(1e-3) (checked against JAX from those weights when
    this test was written)."""
    jnet = JFBRS(arch="resnet50", ch=128)
    tree = jax.jit(jnet.init)(jax.random.PRNGKey(0),
                              np.zeros((1, 48, 48, 3), np.float32),
                              np.full((1, 8, 2), -1.0, np.float32))
    tr = FBRSPretrainer(params=fbrs_state_dict_from_flax(jax.device_get(tree)),
                        hw=(48, 48), lr=1e-3, n_points=4, batch=2, device="cpu")
    losses = [tr.step(3)[0] for _ in range(10)]
    assert all(np.isfinite(losses))
    assert min(losses[-3:]) < losses[0]


def test_batches_built_ahead_give_the_same_steps():
    """The CLI's worker processes build each step's batch from its seed
    alone: the batches, in order, that the loop builds, so the same
    steps."""
    def trainer():
        return S2MPretrainer(hw=(32, 32), lr=1e-3, device="cpu")

    inline = trainer()
    want = [inline.step(seed) for seed in (5, 6, 7)]
    ahead = trainer()
    fed = list(batches(ahead, [5, 6, 7]))
    assert [seed for seed, _ in fed] == [5, 6, 7]
    for (seed, batch), (x, gt) in zip(fed, map(inline.host_batch, (5, 6, 7))):
        np.testing.assert_array_equal(batch[0], x)
        np.testing.assert_array_equal(batch[1], gt)
    assert [ahead.step(seed, batch) for seed, batch in fed] == want


def test_trained_set_is_every_parameter_and_frozen_bn_tensor():
    tr = S2MPretrainer(hw=(32, 32), device="cpu")
    named = dict(tr.net.named_parameters())
    named.update({n: b for n, b in tr.net.named_buffers()})
    assert {id(t) for t in tr.opt.tensors} == {id(t) for t in named.values()}
    assert set(named) == set(tr.state_dict())
    assert all(t.requires_grad and t.is_leaf for t in tr.opt.tensors)


# ---------------------------------------------------------------- CLIs

def _run(out, *args):
    pretrain_synthetic.main(["--out", str(out), "--hw", "32", "--steps", "2",
                             "--log-every", "1", "--device", "cpu", *args])
    with open(path.join(out, "pretrain_log.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def prop_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("weights")
    return out, _run(out, "--net", "prop", "--chain", "1", "2")


def test_pretrain_cli_prop_resume_and_s2m(prop_run):
    out, log = prop_run
    assert log["prop"]["step"] == [0, 1]
    assert log["prop"]["schedule"] == [{"steps": 2, "hw": [32, 32], "lr": 2e-4,
                                        "seed": 1000, "resume": False,
                                        "chain": [1, 2]}]
    load_reference_pth(PropagationNetwork(), pretrain_synthetic.checkpoint_path(str(out), "prop"))
    first = read_state_dict(pretrain_synthetic.checkpoint_path(str(out), "prop"))

    log = _run(out, "--net", "prop", "--resume", "--seed", "2000")
    assert log["prop"]["step"] == [0, 1, 2, 3]
    assert len(log["prop"]["loss"]) == len(log["prop"]["iou"]) == 4
    assert [m["resume"] for m in log["prop"]["schedule"]] == [False, True]
    resumed = read_state_dict(pretrain_synthetic.checkpoint_path(str(out), "prop"))
    assert any(not torch.equal(v, resumed[k]) for k, v in first.items())

    log = _run(out, "--net", "s2m")
    assert log["prop"]["step"] == [0, 1, 2, 3]            # kept
    assert log["s2m"]["step"] == [0, 1] and "chain" not in log["s2m"]["schedule"][0]
    load_reference_pth(S2MNetwork(), pretrain_synthetic.checkpoint_path(str(out), "s2m"))


def test_pretrain_cli_fbrs_builds_the_click_model(tmp_path):
    log = _run(tmp_path, "--net", "fbrs")
    assert list(log) == ["fbrs"] and log["fbrs"]["step"] == [0, 1]
    sd = read_state_dict(pretrain_synthetic.checkpoint_path(str(tmp_path), "fbrs"))
    net = build_fbrs_from_state_dict(sd)
    assert (net.arch, net.ch) == ("resnet50", 128)


def test_pretrain_log_merge_survives_a_prior_entry_without_steps():
    """A resumed run after a logged run with no steps (the JAX script
    raises IndexError there, after training)."""
    old = {"prop": {"loss": [], "iou": [], "step": [], "schedule": [{"steps": 0}]},
           "s2m": {"loss": [1.0], "iou": [0.5], "step": [0]}}
    hist = {"loss": [0.3, 0.2], "iou": [0.1, 0.2], "step": [0, 5]}
    pretrain_synthetic.merge_log(old, "prop", hist, {"steps": 6}, resume=True)
    assert old["prop"]["step"] == [0, 5] and old["prop"]["loss"] == [0.3, 0.2]
    assert old["prop"]["schedule"] == [{"steps": 0}, {"steps": 6}]
    pretrain_synthetic.merge_log(old, "prop", hist, {"steps": 6}, resume=True)
    assert old["prop"]["step"] == [0, 5, 6, 11]
    pretrain_synthetic.merge_log(old, "prop", hist, {"steps": 6}, resume=False)
    assert old["prop"]["step"] == [0, 5] and len(old["prop"]["schedule"]) == 1
    assert old["s2m"]["step"] == [0]


def test_pretrain_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would train on it")
    r = subprocess.run([sys.executable, "-m", "mivos_tpu_torch.pretrain_synthetic",
                        "--net", "prop", "--steps", "1"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_train_fusion_synthetic_runs_on_the_cpu(prop_run, tmp_path):
    """The whole pipeline at a toy size: 2 videos of 4 64x64 frames, the
    CLI's prop weights, 16 iterations at batch 2 (lr 1e-3, reports every 2,
    so several come after the hard-pixel share reaches 0.15)."""
    out, _ = prop_run
    weights = pretrain_synthetic.checkpoint_path(str(out), "prop")
    dest = str(tmp_path / "fusion_synthetic.pth")
    summary = train_fusion_synthetic.main([
        "--root", str(tmp_path / "syn"), "--weights", weights, "--out", dest,
        "--videos", "2", "--batch", "2", "--frames", "4", "--hw", "64",
        "--separation", "2", "--iterations", "16", "--report-every", "2",
        "--lr", "1e-3", "--num-workers", "0", "--device", "cpu"])
    assert summary["it"] == 16 and len(summary["losses"]) == 8
    assert summary["p"][-1] == pytest.approx(0.15)
    load_reference_pth(FusionNet(), dest)
    with open(tmp_path / "syn" / "fusion_train_log.json") as f:
        assert json.load(f)["losses"] == summary["losses"]
    pngs = [f for _, _, fs in os.walk(tmp_path / "syn" / "fusion") for f in fs]
    assert len(pngs) == 2 * 2 * 2 * 4   # videos x reference frames x objects x frames
    with pytest.raises(SystemExit):
        train_fusion_synthetic.main(["--videos", "2", "--batch", "3",
                                     "--device", "cpu"])
