"""The PyTorch port's fusion training against the JAX package's, on the CPU.

(a) TrainConfig, the paired augmentation, FusionDataset samples (bit for
bit, two epochs) and the ShardedSampler/Loader order against the JAX
data layer on a small fusion-data tree, and the video with an empty
instance directory that the JAX dataset raises on. (b) The class-axis
aggregate and the losses at iterations before, inside and after the
warm-up window, with and without a second object. (c) The frozen
AttentionReadNetwork on bridged weights. (d) Three train steps against
the JAX FusionTrainer on a one-CPU mesh, from the same weights and
batches, crossing a learning-rate boundary and the warm-up's end. (e)
Checkpoints, the console logger and `python -m mivos_tpu_torch.train
--device cpu` with a save and a --load_model resume.
"""
import multiprocessing
import os
import re
import subprocess
import sys
from os import path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mivos_tpu.checkpoint.convert import (attention_read_from_prop,
                                          convert_attention_read,
                                          convert_fusion_net, convert_prop_net)
from mivos_tpu.checkpoint.npz import save_params_npz
from mivos_tpu.config import TrainConfig as JTrainConfig
from mivos_tpu.data import transforms as jtr
from mivos_tpu.data.fusion_dataset import FusionDataset as JFusionDataset
from mivos_tpu.data.loader import Loader as JLoader
from mivos_tpu.data.loader import ShardedSampler as JShardedSampler
from mivos_tpu.models.fusion import AttentionReadNetwork as JAttentionRead
from mivos_tpu.ops.aggregate import aggregate_wbg_last
from mivos_tpu.parallel.mesh import make_mesh
from mivos_tpu.train import losses as jlosses
from mivos_tpu.train.trainer import FusionTrainer as JFusionTrainer
from mivos_tpu.utils.palette import save_indexed_png
from mivos_tpu_torch.checkpoint.from_jax import state_dict_from_flax
from mivos_tpu_torch.checkpoint.manager import CheckpointManager, save_params
from mivos_tpu_torch.checkpoint.npz import load_params_npz
from mivos_tpu_torch.checkpoint.pth import (attention_read_state_dict,
                                            load_reference_pth)
from mivos_tpu_torch.config import TrainConfig
from mivos_tpu_torch.data import transforms as tr
from mivos_tpu_torch.data.fusion_dataset import FusionDataset
from mivos_tpu_torch.data.loader import Loader, ShardedSampler
from mivos_tpu_torch.models.fusion import AttentionReadNetwork, FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.aggregate import aggregate_wbg_channel
from mivos_tpu_torch.train import losses
from mivos_tpu_torch.train.trainer import FusionTrainer
from mivos_tpu_torch.utils.integrator import Integrator
from mivos_tpu_torch.utils.logger import TensorboardLogger

REPO = path.dirname(path.dirname(path.abspath(__file__)))
H, W, T_VID = 48, 64, 8     # fusion-data tree: 8-frame 48x64 videos
ATTN_ATOL = 1e-5     # attention maps: softmax weights of fp32 affinities, in [0, 1]
LOSS_RTOL = 1e-5     # fp32 CE summed in another order
# Weights after 3 Adam steps. Each element of an update is ~lr in size
# (m / sqrt(v) ~ 1), fp32 rounding of weights and gradients moved them by
# up to 4e-7 here; 1e-6 is 1% of a step at lr 1e-4 and a tenth of the
# third step (lr 1e-5), while a drop one step early or late would move
# them by ~9e-5.
WEIGHT_ATOL = 1e-6


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


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).movedim(-1, 1)


# ---------------------------------------------------------------- (a)

def test_train_config_matches_jax():
    for stage in (0, 1):
        ref, got = JTrainConfig(stage=stage), TrainConfig(stage=stage)
        assert got.resolved_iterations() == ref.resolved_iterations()
        assert got.resolved_steps() == ref.resolved_steps()
        for f in ("batch_size", "lr", "gamma", "seed", "save_every",
                  "report_every"):
            assert getattr(got, f) == getattr(ref, f)
    cfg = TrainConfig(iterations=7, steps=(3, 5))
    assert cfg.resolved_iterations() == 7 and cfg.resolved_steps() == (3, 5)


def test_augmentation_matches_jax():
    img = np.random.RandomState(0).rand(50, 70, 3).astype(np.float32)
    lab = np.random.RandomState(1).randint(0, 3, (50, 70)).astype(np.uint8)
    for seed in range(6):
        p = tr.AugParams.sample(np.random.default_rng(seed), 50, 70, 32)
        q = jtr.AugParams.sample(np.random.default_rng(seed), 50, 70, 32)
        assert p.__dict__ == q.__dict__
        for x in (img, lab):
            np.testing.assert_array_equal(tr.apply_geometric(x, p),
                                          jtr.apply_geometric(x, q))
        np.testing.assert_array_equal(tr.apply_color_jitter(img, p),
                                      jtr.apply_color_jitter(img, q))


def _write_tree(root, empty_video=None):
    """im_root/gt_root with videos v0-v2 (8 frames of 48x64), and fd_root
    with two runs: r0 has every video, reference frames 0 and 4, objects 1
    and 2 (v0's object 1 equal from both references, so that its pairs
    are drawn again); r1 has v1, references 2 and 6, object 1. With
    empty_video, that video's r1 instance directory holds no reference
    frame, as generate_fusion writes it for a video with no usable
    object."""
    from PIL import Image

    rng = np.random.RandomState(3)
    im_root, gt_root, fd_root = (path.join(root, d) for d in ("im", "gt", "fd"))
    for vid in ("v0", "v1", "v2"):
        os.makedirs(path.join(im_root, vid))
        os.makedirs(path.join(gt_root, vid))
        for f in range(T_VID):
            Image.fromarray(rng.randint(0, 256, (H, W, 3), np.uint8)).save(
                path.join(im_root, vid, f"{f:05d}.jpg"))
            save_indexed_png(path.join(gt_root, vid, f"{f:05d}.png"),
                             rng.randint(0, 3, (H, W)).astype(np.uint8))
    runs = {"r0": {v: ((0, 4), (1, 2)) for v in ("v0", "v1", "v2")},
            "r1": {"v1": ((2, 6), (1,))}}
    for run, vids in runs.items():
        for vid, (refs, objs) in vids.items():
            for ref in refs:
                for obj in objs:
                    d = path.join(fd_root, run, vid, f"{ref:05d}", f"{obj:05d}")
                    os.makedirs(d)
                    for f in range(T_VID):
                        same = vid == "v0" and obj == 1
                        arr = (np.full((H, W), 37 * f % 256, np.uint8) if same
                               else rng.randint(0, 256, (H, W), np.uint8))
                        Image.fromarray(arr).save(path.join(d, f"{f:05d}.png"))
    if empty_video is not None:
        os.makedirs(path.join(fd_root, "r1", empty_video))
    return im_root, gt_root, fd_root


@pytest.fixture(scope="module")
def fusion_tree(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("fusion_tree")))


def _assert_samples_equal(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if key == "info":
            assert a[key] == b[key]
        else:
            got = np.asarray(a[key])
            assert got.dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(got, b[key], err_msg=key)


def test_fusion_dataset_matches_jax_bit_for_bit(fusion_tree):
    ref, got = JFusionDataset(*fusion_tree, seed=7), FusionDataset(*fusion_tree, seed=7)
    assert got.videos == ref.videos == ["v0", "v1", "v2"]
    seconds = 0
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        for idx in range(5):
            a, b = got[idx], ref[idx]
            _assert_samples_equal(a, b)
            assert a["rgb"].shape == (H, W, 3) and a["cls_gt"].shape == (H, W)
            seconds += int(a["selector"][1])
    assert 0 < seconds < 10   # samples with and without a second object


def test_fusion_dataset_skips_an_empty_instance(tmp_path):
    """The JAX dataset raises ValueError (rng.integers(0),
    mivos_tpu/data/fusion_dataset.py:80) on an instance directory with no
    reference frame; the port drops that instance and leaves a video with
    no other instance out."""
    tree = _write_tree(str(tmp_path), empty_video="v2")
    os.makedirs(path.join(tree[2], "r2", "v0"))   # an empty second instance of v0
    jds = JFusionDataset(*tree, seed=7)
    with pytest.raises(ValueError):
        for idx in range(20):
            jds[idx]
    ds = FusionDataset(*tree, seed=7)
    assert ds.videos == ["v0", "v1", "v2"]   # v2 still has its r0 instance
    assert all(not p.endswith("r2/v0") for p in ds.vid_to_instance["v0"])
    for idx in range(6):
        s = ds[idx]
        assert s["rgb"].shape == (H, W, 3)
    only_empty = str(tmp_path / "only_empty")
    os.makedirs(path.join(only_empty, "r0", "v1"))
    assert FusionDataset(tree[0], tree[1], only_empty).videos == []


def test_sampler_and_loader_match_jax(fusion_tree):
    for n, shards in ((7, 1), (7, 2), (10, 3)):
        for shard in range(shards):
            a = ShardedSampler(n, shards, shard, seed=5)
            b = JShardedSampler(n, shards, shard, seed=5)
            for epoch in (0, 3):
                a.set_epoch(epoch)
                b.set_epoch(epoch)
                assert list(a) == list(b) and len(a) == len(b)
    with pytest.raises(ValueError):
        ShardedSampler(4, 2, 2)
    got = Loader(FusionDataset(*fusion_tree, seed=7), 2,
                 sampler=ShardedSampler(3, seed=7), num_workers=2)
    ref = JLoader(JFusionDataset(*fusion_tree, seed=7), 2,
                  sampler=JShardedSampler(3, seed=7), num_workers=2)
    for loader in (got, ref):
        loader.set_epoch(1)
    a, b = list(got), list(ref)
    assert len(a) == len(b) == len(got) == 1   # 3 samples: 1 whole batch
    _assert_samples_equal(a[0], b[0])
    assert all(torch.is_tensor(v) for k, v in a[0].items() if k != "info")
    # A consumer that leaves early stops the workers.
    before = set(multiprocessing.active_children())
    it = iter(Loader(FusionDataset(*fusion_tree, seed=7), 1, num_workers=2))
    next(it)
    assert len(set(multiprocessing.active_children()) - before) == 2
    it.close()
    assert set(multiprocessing.active_children()) <= before


# ---------------------------------------------------------------- (b)

def test_aggregate_wbg_channel_matches_jax():
    prob = np.random.RandomState(2).rand(2, 9, 11, 2).astype(np.float32)
    prob[0, 0, 0] = 0.0
    rl, rm = aggregate_wbg_last(jnp.asarray(prob), keep_bg=True)
    gl, gm = aggregate_wbg_channel(_nchw(prob))
    np.testing.assert_allclose(gl.movedim(1, -1).numpy(), rl, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gm.movedim(1, -1).numpy(), rm, atol=1e-6, rtol=0)


@pytest.mark.parametrize("it", [0, 19, 20, 33, 50, 51, 80])
@pytest.mark.parametrize("second", [True, False])
def test_losses_match_jax(it, second):
    rng = np.random.RandomState(it)
    b, h, w = 3, 16, 24
    logits = (rng.randn(b, h, w, 3) * 2).astype(np.float32)
    cls_gt = rng.randint(0, 3 if second else 2, (b, h, w)).astype(np.int32)
    sel = np.stack([np.ones(b), np.full(b, float(second))], 1).astype(np.float32)
    sel[0, 1] = 1.0   # one sample always has a second object
    batch = {"cls_gt": cls_gt, "selector": sel,
             "gt": (rng.rand(b, h, w, 1) > 0.5).astype(np.float32),
             "gt2": (rng.rand(b, h, w, 1) > 0.5).astype(np.float32)}
    mask = rng.rand(b, h, w, 3).astype(np.float32)
    assert losses.bootstrap_fraction(it, 20, 50) == jlosses.bootstrap_fraction(
        jnp.int32(it), 20, 50)
    ref_ce, ref_p = jlosses.bootstrapped_ce(jnp.asarray(logits),
                                            jnp.asarray(cls_gt), jnp.int32(it), 20, 50)
    ce, p = losses.bootstrapped_ce(_nchw(logits), torch.from_numpy(cls_gt), it, 20, 50)
    assert p == float(ref_p)
    np.testing.assert_allclose(float(ce), float(ref_ce), rtol=LOSS_RTOL)
    ref = jlosses.compute_fusion_losses(
        {"logits": jnp.asarray(logits), "mask": jnp.asarray(mask)},
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(it), 20, 50)
    got = losses.compute_fusion_losses(
        {"logits": _nchw(logits), "mask": _nchw(mask)},
        {"cls_gt": torch.from_numpy(cls_gt), "selector": torch.from_numpy(sel),
         "gt": _nchw(batch["gt"]), "gt2": _nchw(batch["gt2"])}, it, 20, 50)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


# ---------------------------------------------------------------- (c)

@pytest.fixture(scope="module")
def prop_weights():
    """A random-init propagation net's weights in both packages."""
    prop = init_params(PropagationNetwork(), torch.Generator().manual_seed(2))
    return prop, convert_prop_net(_numpy_sd(prop))


def test_attention_read_weights_bridge(prop_weights, tmp_path):
    prop, jtree = prop_weights
    want = attention_read_state_dict(prop)
    assert {k.split(".")[0] for k in want} == {
        "mask_rgb_encoder", "rgb_encoder", "kv_m_f16", "kv_q_f16"}
    AttentionReadNetwork().load_state_dict(want, strict=True)
    # The JAX reader's flax tree, both ways the JAX package makes it.
    for tree in (attention_read_from_prop(jtree),
                 convert_attention_read(_numpy_sd(prop))):
        got = state_dict_from_flax(tree)
        assert sorted(got) == sorted(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    # A reference-named .pth, and a flax .npz snapshot.
    torch.save(prop.state_dict(), tmp_path / "prop.pth")
    got = attention_read_state_dict(str(tmp_path / "prop.pth"))
    assert all(torch.equal(got[k], want[k]) for k in want)
    save_params_npz(str(tmp_path / "prop.npz"), {"params": {
        "kv_q_f16": jtree["params"]["kv_q_f16"]}})
    tree = load_params_npz(str(tmp_path / "prop.npz"))
    np.testing.assert_array_equal(
        tree["params"]["kv_q_f16"]["key_proj"]["kernel"],
        jtree["params"]["kv_q_f16"]["key_proj"]["kernel"])
    with pytest.raises(KeyError):
        attention_read_state_dict({k: v for k, v in want.items()
                                   if not k.startswith("kv_q_f16.")})


def test_attention_read_matches_jax(prop_weights):
    prop, jtree = prop_weights
    net = AttentionReadNetwork().eval()
    net.load_state_dict(attention_read_state_dict(prop), strict=True)
    rng = np.random.RandomState(4)
    b, h, w = 2, 64, 64
    ims = [rng.randn(b, h, w, 3).astype(np.float32) for _ in range(2)]
    masks = [rng.rand(b, h, w, 1).astype(np.float32) for _ in range(4)]
    ref = JAttentionRead().apply(attention_read_from_prop(jtree), ims[0],
                                 *masks, ims[1])
    with torch.no_grad():
        got = net(_nchw(ims[0]), *map(_nchw, masks), _nchw(ims[1]))
    for g, r in zip(got, ref):
        assert g.shape == (b, 2, h, w)
        np.testing.assert_allclose(g.movedim(1, -1).numpy(), np.asarray(r),
                                   atol=ATTN_ATOL, rtol=0)


# ---------------------------------------------------------------- (d)

def _batch(seed, b=2, h=32, w=32):
    """Sample 0 has a second object, sample 1 none (its class map holds
    no class 2 and its second-object streams are zero, as the dataset
    makes them)."""
    rng = np.random.RandomState(seed)
    m = lambda: rng.rand(b, h, w, 1).astype(np.float32)  # noqa: E731
    batch = {
        "rgb": rng.randn(b, h, w, 3).astype(np.float32),
        "cls_gt": rng.randint(0, 3, (b, h, w)).astype(np.int32),
        "gt": (m() > 0.5).astype(np.float32),
        "seg1": m(), "seg2": m(),
        "src2_ref": m(), "src2_ref_gt": (m() > 0.5).astype(np.float32),
        "gt2": (m() > 0.5).astype(np.float32),
        "seg12": m(), "seg22": m(),
        "src2_ref2": m(), "src2_ref_gt2": (m() > 0.5).astype(np.float32),
        "src2_ref_im": rng.randn(b, h, w, 3).astype(np.float32),
        "dist": rng.rand(b, 2).astype(np.float32),
        "selector": np.asarray([[1, 1], [1, 0]], np.float32),
    }
    batch["cls_gt"][1] = batch["cls_gt"][1] % 2
    for k in ("gt2", "seg12", "seg22", "src2_ref2", "src2_ref_gt2"):
        batch[k][1] = 0.0
    return batch


def test_three_train_steps_match_jax(prop_weights):
    """iterations=5 (warm-up 1..2), a learning-rate drop at step 2: the
    third update runs at lr/10 and the hardest 15% of pixels."""
    prop, jtree = prop_weights
    cfg = dict(iterations=5, steps=(2,), batch_size=2)
    fuse = init_params(FusionNet(), torch.Generator().manual_seed(3))
    jtr_ = JFusionTrainer(JTrainConfig(**cfg), make_mesh(1))
    batches = [_batch(s) for s in range(3)]
    # What JFusionTrainer.init sets, from the port's weights, placed as
    # its steps return them (so that the step compiles once).
    jtr_.attn_params = jax.device_put(attention_read_from_prop(jtree), jtr_.repl)
    jtr_.fuse_params = jax.device_put(convert_fusion_net(_numpy_sd(fuse)),
                                      jtr_.repl)
    jtr_.opt_state = jax.device_put(jtr_.tx.init(jtr_.fuse_params), jtr_.repl)
    trainer = FusionTrainer(TrainConfig(**cfg), attention_read_state_dict(prop),
                            device="cpu")
    trainer.fuse_net.load_state_dict(fuse.state_dict())
    sched = optax.piecewise_constant_schedule(1e-4, {2: 0.1})
    for i, batch in enumerate(batches):
        assert trainer.lr == pytest.approx(float(sched(i)), rel=1e-6), i
        ref = jtr_.train_step(batch)
        got = trainer.train_step(batch)
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=LOSS_RTOL, err_msg=f"step {i} {k}")
    assert trainer.it == jtr_.it == 3
    assert float(got["p"]) == pytest.approx(0.15)
    ref_sd = state_dict_from_flax(jtr_.fuse_params)
    moved = 0.0
    for k, v in trainer.fuse_net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ref_sd[k].numpy(),
                                   atol=WEIGHT_ATOL, rtol=0, err_msg=k)
        moved = max(moved, (v - fuse.state_dict()[k]).abs().max().item())
    assert moved > 1e-4   # the steps really moved the weights
    # val_step and the montage outputs run without touching the state.
    assert np.isfinite(float(trainer.val_step(batches[0])["total_loss"]))
    out = trainer.debug_outputs(batches[0])
    assert out["mask"].shape == (2, 32, 32, 3) and trainer.it == 3


# ---------------------------------------------------------------- (e)

def test_checkpoints_round_trip(tmp_path, prop_weights):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    for step in range(1, 6):
        mgr.save(step, {"it": step, "w": torch.full((2,), float(step))})
    assert mgr.steps() == [3, 4, 5] and mgr.latest_step() == 5
    assert mgr.restore()["it"] == 5
    assert torch.equal(mgr.restore()["w"], torch.full((2,), 5.0))
    assert not [f for f in os.listdir(tmp_path / "ck") if "__tmp__" in f]

    # A trainer's full state: save, restore into a fresh trainer, one more
    # step on both gives equal weights.
    prop, _ = prop_weights
    attn = attention_read_state_dict(prop)
    cfg = TrainConfig(iterations=4, steps=(1,), batch_size=2)
    a = FusionTrainer(cfg, attn, device="cpu")
    a.train_step(_batch(0))
    a.train_step(_batch(1))
    mgr = CheckpointManager(str(tmp_path / "trainer"))
    mgr.save(a.it, a.state_dict())
    b = FusionTrainer(cfg, attn, device="cpu")
    b.load_state_dict(mgr.restore())
    assert b.it == 2 and b.lr == a.lr
    a.train_step(_batch(2))
    b.train_step(_batch(2))
    for k, v in a.fuse_net.state_dict().items():
        assert torch.equal(v, b.fuse_net.state_dict()[k]), k
    # The weights-only file loads as a reference fusion.pth.
    save_params(str(tmp_path / "w" / "fusion.pth"), a.fuse_net)
    net = load_reference_pth(FusionNet(), str(tmp_path / "w" / "fusion.pth"))
    assert all(torch.equal(v, a.fuse_net.state_dict()[k])
               for k, v in net.state_dict().items())


def test_integrator_and_logger(capsys):
    logger = TensorboardLogger("NULL")
    integ = Integrator(logger)
    integ.add_hook(lambda v: ("iou", v["hide_iou/i"] / v["hide_iou/u"]))
    integ.add_dict({"total_loss": torch.tensor(2.0), "hide_iou/i": 3.0,
                    "hide_iou/u": 4.0, "p": np.float32(0.5)})
    integ.add_dict({"total_loss": torch.tensor(4.0), "hide_iou/i": 1.0,
                    "hide_iou/u": 4.0, "p": np.float32(0.5)})
    out = integ.finalize("train", 50)
    assert out == {"total_loss": 3.0, "p": 0.5, "iou": 0.5}
    text = capsys.readouterr().out
    assert text.splitlines()[0].startswith("git ")
    assert "DEBUG - It     50 [TRAIN] [total_loss   ]: 3.0000000" in text
    assert "hide" not in text


def test_train_cli_saves_and_resumes(fusion_tree, prop_weights, tmp_path):
    im, gt, fd = fusion_tree
    torch.save(prop_weights[0].state_dict(), tmp_path / "prop.pth")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "mivos_tpu_torch.train", "--device", "cpu",
            "--im_root", im, "--gt_root", gt, "--fd_root", fd,
            "--batch_size", "2", "--num_workers", "2", "--save_every", "2",
            "--report_every", "1", "--save_dir", str(tmp_path / "runs"),
            "--load_prop", str(tmp_path / "prop.pth")]
    r = subprocess.run(base + ["--id", "a", "--iterations", "3"], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert os.listdir(tmp_path / "runs" / "a") == ["checkpoint_2.pth"]
    its = [int(x) for x in re.findall(r"^a - It +(\d+) \[TRAIN\] \[total_loss",
                                       r.stdout, re.M)]
    assert its == [1, 2, 3]
    r = subprocess.run(base + ["--id", "b", "--iterations", "4", "--load_model",
                               str(tmp_path / "runs" / "a")], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "resumed at iteration 2" in r.stdout
    assert os.listdir(tmp_path / "runs" / "b") == ["checkpoint_4.pth"]
    assert CheckpointManager(str(tmp_path / "runs" / "b")).restore()["it"] == 4
    # Without a card the default device fails; no CPU fallback.
    if not torch.cuda.is_available():
        r = subprocess.run(base[:3] + base[5:] + ["--iterations", "1"],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_train_cli_data_parallel_on_two_cpu_ranks(fusion_tree, tmp_path):
    """`torchrun --nproc_per_node 2 -m mivos_tpu_torch.train --device cpu`:
    two gloo ranks of one sample each (batch 2), only rank 0 logging and
    saving; a batch the ranks do not divide is refused."""
    im, gt, fd = fusion_tree
    env = dict(os.environ, OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node", "2", "-m", "mivos_tpu_torch.train",
            "--device", "cpu", "--im_root", im, "--gt_root", gt, "--fd_root", fd,
            "--num_workers", "0", "--save_every", "2", "--report_every", "1",
            "--save_dir", str(tmp_path / "runs"), "--id", "ddp"]
    r = subprocess.run(base + ["--batch_size", "2", "--iterations", "2"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    its = [int(x) for x in re.findall(r"^ddp - It +(\d+) \[TRAIN\] \[total_loss",
                                       r.stdout, re.M)]
    assert its == [1, 2]     # logged once, by rank 0
    assert os.listdir(tmp_path / "runs" / "ddp") == ["checkpoint_2.pth"]
    r = subprocess.run(base + ["--batch_size", "3", "--iterations", "1"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "not divisible" in r.stdout + r.stderr


def test_training_entry_points_default_to_the_card():
    import inspect

    from mivos_tpu_torch import generate_fusion
    from mivos_tpu_torch.core.fusion_generator import FusionGenerator
    from mivos_tpu_torch.train import __main__ as train_main

    for fn in (FusionTrainer.__init__, FusionGenerator.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    assert generate_fusion.parse_args(
        ["--dataset", "DAVIS", "--output", "o"]).device == "cuda"
    assert train_main.parse_args(
        ["--im_root", "i", "--gt_root", "g", "--fd_root", "f"]).device == "cuda"
