"""The PyTorch port's fusion-data generation against the JAX package's,
on the CPU.

(a) The kernelized (km) memory read against `gaussian_kernelized_weights`
and `memory_read(km=...)`. (b) `FusionGenerator.interact_mask`, the JAX
net on the exact read ('xla_exact') and the port's on its torch.topk
counterpart ('exact'), the same weights (the port's random init carried
to flax by the JAX package's converter), fp32: T=6, 45x62 frames (padded
to 48x64), K=2, top_k=10, mem_freq=2, a whole-video window and a BL
window. (c) `python -m mivos_tpu_torch.generate_fusion`: the resume
contract of tests/test_generate_fusion_cli.py, its PNGs within one
uint8 level of the JAX CLI's on the same tiny DAVIS tree and weights
(--model_npz), and no CPU fallback. (d) The datasets it reads.
"""
import os
import subprocess
import sys
from os import path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import convert_prop_net
from mivos_tpu.checkpoint.npz import flatten_tree
from mivos_tpu.core.fusion_generator import FusionGenerator as JFusionGenerator
from mivos_tpu.data.video_datasets import BLTestDataset as JBLTestDataset
from mivos_tpu.generation.synthetic import synthetic_sequence
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.ops.memory_read import gaussian_kernelized_weights as j_km_weights
from mivos_tpu.ops.memory_read import memory_read as j_memory_read
from mivos_tpu.utils.palette import save_indexed_png
from mivos_tpu_torch import generate_fusion
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.fusion_generator import FusionGenerator
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.data.video_datasets import BLTestDataset, DAVISTestDataset
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops import memory_read as mr

REPO = path.dirname(path.dirname(path.abspath(__file__)))
T, RH, RW, K = 6, 45, 62, 2
TOP_K, MEM_FREQ = 10, 2
PROB_ATOL = 1e-4      # fp32 conv/matmul summation order over 5 propagated frames
KM_ATOL = 1e-5        # fp32 exp/normalize of the kernelized weights


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    same cores (see tests/test_torch_serve.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("with_valid", [False, True])
def test_km_read_matches_jax(with_valid):
    rng = np.random.RandomState(5)
    h, w, k, m = 6, 7, 2, 90
    mk = rng.randn(k, m, 128).astype(np.float32)
    mv = rng.randn(k, m, 512).astype(np.float32)
    q = rng.randn(h * w, 128).astype(np.float32)
    valid = (np.arange(m) < 70) if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    aff = np.asarray(rng.randn(k, h * w, m).astype(np.float32) * 3)
    ref_w = np.asarray(j_km_weights(jnp.asarray(aff), h, w, 5.6, 12, jv))
    got_w = mr.gaussian_kernelized_weights(torch.from_numpy(aff), h, w, 5.6,
                                           12, tv).numpy()
    np.testing.assert_allclose(got_w, ref_w, atol=KM_ATOL, rtol=0)
    np.testing.assert_array_equal(got_w > 0, ref_w > 0)   # the same kept set
    ref = np.asarray(j_memory_read(jnp.asarray(mk), jnp.asarray(mv),
                                   jnp.asarray(q), top_k=12, valid=jv, km=5.6,
                                   query_hw=(h, w), backend="xla_exact"))
    for backend in ("auto", "exact"):   # km never reaches the kernel path
        got = mr.memory_read(torch.from_numpy(mk), torch.from_numpy(mv),
                             torch.from_numpy(q), top_k=12, valid=tv, km=5.6,
                             query_hw=(h, w), backend=backend).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_km_flows_from_memory_config_to_the_read():
    net = PropagationNetwork(top_k=TOP_K)
    core = InferenceCore(net, None, np.zeros((2, 32, 32, 3), np.float32), 1,
                         mem=MemoryConfig(top_k=TOP_K, km=5.6), device="cpu")
    assert core.prop_net.km == 5.6 and net.km is None
    with pytest.raises(ValueError):   # km needs the query grid
        mr.memory_read(torch.zeros(1, 4, 128), torch.zeros(1, 4, 512),
                       torch.zeros(2, 128), top_k=2, km=1.0)


# ---------------------------------------------------------------- (b)

@pytest.fixture(scope="module")
def prop_sd():
    """A random-init propagation net's weights (numpy, reference names)."""
    return _numpy_sd(init_params(PropagationNetwork(),
                                 torch.Generator().manual_seed(0)))


@pytest.fixture(scope="module")
def generators(prop_sd):
    prop = PropagationNetwork(top_k=TOP_K, read_backend="exact")
    prop.load_state_dict({k: torch.from_numpy(v) for k, v in prop_sd.items()})
    rng = np.random.RandomState(0)
    images = rng.rand(T, RH, RW, 3).astype(np.float32)
    labels = rng.randint(0, K + 1, (RH, RW))
    mask = (labels[None] == np.arange(1, K + 1)[:, None, None]).astype(
        np.float32)[..., None]
    jgen = JFusionGenerator(JPropagation(top_k=TOP_K, read_backend="xla_exact"),
                            convert_prop_net(prop_sd), images,
                            mem_freq=MEM_FREQ)
    gen = FusionGenerator(prop, images, mem_freq=MEM_FREQ, device="cpu")
    return jgen, gen, mask


@pytest.mark.parametrize("idx,left,right", [(2, 0, T - 1), (3, 2, 4)])
def test_interact_mask_matches_jax(generators, idx, left, right):
    jgen, gen, mask = generators
    jgen.reset(K)
    gen.reset(K)
    ref = jgen.interact_mask(mask, idx, left, right)
    got = gen.interact_mask(mask, idx, left, right)
    assert got.shape == ref.shape == (K + 1, T, RH, RW)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=PROB_ATOL, rtol=0)
    outside = [t for t in range(T) if not left <= t <= right]
    assert not got[:, outside].any()
    np.testing.assert_allclose(got[:, left:right + 1].sum(0), 1.0, atol=1e-5)


# ---------------------------------------------------------------- (c)

@pytest.fixture(scope="module")
def tiny_davis(tmp_path_factory):
    """tests/test_generate_fusion_cli.py's tree: two 3-frame 64x64
    DAVIS-layout videos, the second with empty annotations."""
    from PIL import Image

    root = str(tmp_path_factory.mktemp("gfdata"))
    im_root = path.join(root, "trainval", "JPEGImages", "480p")
    gt_root = path.join(root, "trainval", "Annotations", "480p")
    imset = path.join(root, "trainval", "ImageSets", "2017")
    os.makedirs(imset)
    names = ["vid00", "vid01"]
    for vi, name in enumerate(names):
        os.makedirs(path.join(im_root, name))
        os.makedirs(path.join(gt_root, name))
        images, labels = synthetic_sequence(42 + vi, 3, 64, 64, num_objects=1)
        if vi == 1:
            labels = np.zeros_like(labels)   # no usable object
        for fi in range(3):
            Image.fromarray((images[fi] * 255).astype(np.uint8)).save(
                path.join(im_root, name, f"{fi:05d}.jpg"), quality=95)
            save_indexed_png(path.join(gt_root, name, f"{fi:05d}.png"),
                             labels[fi].astype(np.uint8))
    with open(path.join(imset, "train.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return root


@pytest.fixture(scope="module")
def tiny_npz(tmp_path_factory, prop_sd):
    out = str(tmp_path_factory.mktemp("gfw") / "prop.npz")
    # The layout of checkpoint/npz.py::save_params_npz, uncompressed
    # (compressing 60M random weights takes seconds).
    np.savez(out, **flatten_tree(convert_prop_net(prop_sd)))
    return out


def _pngs(root):
    found = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = path.join(dirpath, f)
            found[path.relpath(p, root)] = p
    return found


def _run_jax_cli(monkeypatch, argv):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "generate_fusion_jax", path.join(REPO, "generate_fusion.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(sys, "argv", ["generate_fusion.py"] + argv)
    mod.main()


def test_generate_fusion_resume_contract_and_jax_parity(
        tiny_davis, tiny_npz, tmp_path, monkeypatch, capsys):
    from PIL import Image

    common = ["--dataset", "DAVIS", "--davis_root", tiny_davis,
              "--model_npz", tiny_npz, "--separation", "2",
              "--dtype", "float32", "--mem_freq", "1"]
    out, jout = str(tmp_path / "fusion"), str(tmp_path / "jax")
    # Stale staging from an interrupted run is swept.
    os.makedirs(path.join(out, "vid00.__tmp__", "junk"))
    argv = common + ["--output", out, "--device", "cpu"]
    generate_fusion.main(argv)
    assert "ALL-DONE" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["vid00", "vid01"]
    assert os.listdir(path.join(out, "vid01")) == []   # no usable object
    got = _pngs(path.join(out, "vid00"))
    # Reference frames 0 and 2, one object, 3 frames each.
    assert sorted(got) == [f"{r:05d}/00001/{f:05d}.png"
                           for r in (0, 2) for f in range(3)]

    _run_jax_cli(monkeypatch, common + ["--output", jout])
    capsys.readouterr()
    ref = _pngs(path.join(jout, "vid00"))
    assert sorted(ref) == sorted(got)
    for name in ref:
        a = np.asarray(Image.open(got[name]), np.int16)
        b = np.asarray(Image.open(ref[name]), np.int16)
        assert np.abs(a - b).max() <= 1, name

    # A re-run without --skip_done overwrites; --skip_done skips both.
    mtime0 = path.getmtime(got["00000/00001/00001.png"])
    generate_fusion.main(argv)
    assert "ALL-DONE" in capsys.readouterr().out
    assert path.getmtime(got["00000/00001/00001.png"]) >= mtime0
    generate_fusion.main(argv + ["--skip_done"])
    text = capsys.readouterr().out
    assert text.count("(skipped)") == 2 and "ALL-DONE" in text
    assert not [d for d in os.listdir(out) if d.endswith(".__tmp__")]


def test_generate_fusion_defaults_to_the_card(tiny_davis, tmp_path):
    """Without a card the default device fails; it never falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(
        [sys.executable, "-m", "mivos_tpu_torch.generate_fusion",
         "--dataset", "DAVIS", "--davis_root", tiny_davis,
         "--output", str(tmp_path / "o")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    assert not (tmp_path / "o").exists()


# ---------------------------------------------------------------- (d)

def test_datasets_match_jax(tiny_davis, tmp_path):
    from PIL import Image

    davis = DAVISTestDataset(path.join(tiny_davis, "trainval"),
                             imset="2017/train.txt")
    assert davis.videos == ["vid00", "vid01"]
    assert davis[1]["gt"].shape[0] == 0
    # A BL30K-layout tree: JPEGImages/<video>, Annotations/<video>.
    src = path.join(tiny_davis, "trainval")
    bl = tmp_path / "bl"
    for sub in ("JPEGImages", "Annotations"):
        for name in ("vid00", "vid01"):
            os.makedirs(bl / sub / name)
            for f in os.listdir(path.join(src, sub, "480p", name)):
                Image.open(path.join(src, sub, "480p", name, f)).save(
                    bl / sub / name / f)
    for kw in ({}, {"start": 1, "end": 1}):
        ref, got = JBLTestDataset(str(bl), **kw), BLTestDataset(str(bl), **kw)
        assert got.videos == ref.videos and len(got) == len(ref)
        for i in range(len(got)):
            a, b = got[i], ref[i]
            np.testing.assert_array_equal(a["rgb"], b["rgb"])
            np.testing.assert_array_equal(a["gt"], b["gt"])
            assert a["info"] == b["info"]
