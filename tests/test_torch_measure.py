"""The port's measuring entry points against the JAX package's scripts,
on the CPU at small sizes, one intra-op thread.

The JAX scripts are loaded from scripts/ with importlib and their size
globals set small where they have them. Weights are one random init of
the port's, carried into JAX by checkpoint/convert.py; fp32, TF32 off.
Tolerances, each stated where it is checked: encoder banks 1e-4 of their
largest magnitude; readout scales 1e-5 relative and the kernel read's
errors against the exact read 1e-4 of the scale (the plain read against
the Pallas kernel in interpret mode); NoC trajectories the same number
of clicks and IoUs 1e-3 apart; conv-phase FLOPs 2% of XLA's
cost_analysis (XLA also counts the elementwise work); the first training
loss 1e-5 relative (tests/test_torch_train.py's LOSS_RTOL); the
streamed masks exact.
"""
import importlib.util
import json
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import (convert_attention_read, convert_fusion_net,
                                          convert_prop_net)
from mivos_tpu.checkpoint.npz import save_params_npz
from mivos_tpu.config import TrainConfig as JTrainConfig
from mivos_tpu.models.fbrs import FBRSDeepLabModel as JFBRS
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.ops.pallas.memory_read import memory_read_pallas
from mivos_tpu.parallel.mesh import make_mesh
from mivos_tpu.train.trainer import FusionTrainer as JFusionTrainer
from mivos_tpu_torch import (bench, curriculum_ab, interactive_latency_bench, kernel_check,
                             mfu_report, noc_synthetic, refine_sweep, serve_streaming_bench,
                             slim_decoder_bench, synthetic_lifecycle, train_step_bench)
from mivos_tpu_torch.checkpoint.from_jax import fbrs_state_dict_from_flax
from mivos_tpu_torch.models.fbrs import FBRSDeepLabModel
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.utils.measure import LaunchTally
from test_torch_models import _random_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, FRAMES, TAIL = 64, 96, 4, 8       # n16 = 24, M = 96
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_serve.py); full fp32."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _numpy_sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


@pytest.fixture
def small(monkeypatch):
    """kernel_check and bench at H x W, the gate's tail TAIL slots."""
    for name, value in (("H", H), ("W", W), ("TAIL", TAIL)):
        monkeypatch.setattr(kernel_check, name, value)
    return monkeypatch


@pytest.fixture(scope="module")
def prop_weights(tmp_path_factory):
    """A random-init propagation net, and its flax tree saved as .npz."""
    net = init_params(PropagationNetwork(), torch.Generator().manual_seed(2))
    tree = convert_prop_net(_numpy_sd(net))
    path = str(tmp_path_factory.mktemp("w") / "prop.npz")
    save_params_npz(path, tree)
    return net, tree, path


@pytest.fixture(scope="module")
def banks(prop_weights):
    """Both packages' encoder banks over FRAMES frames of H x W."""
    net, _, path = prop_weights
    jcheck = _script("pallas_kernel_check")
    jcheck.H, jcheck.W = H, W
    ref = [np.asarray(x) for x in jcheck.encoder_banks(path, FRAMES)]
    saved = kernel_check.H, kernel_check.W
    kernel_check.H, kernel_check.W = H, W
    try:
        got = [x.numpy() for x in kernel_check.encoder_banks(net, FRAMES, "cpu")]
    finally:
        kernel_check.H, kernel_check.W = saved
    return jcheck, ref, got


def test_encoder_banks_match_jax(banks):
    _, ref, got = banks
    assert ref[0].shape == got[0].shape == (3, FRAMES * (H // 16) * (W // 16), 128)
    assert ref[2].shape == got[2].shape == ((H // 16) * (W // 16), 128)
    for r, g in zip(ref, got):
        assert np.abs(g - r).max() <= 1e-4 * np.abs(r).max()   # 1e-4 of the largest


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compare_matches_jax_on_encoder_banks(banks, monkeypatch, dtype):
    """The port's `compare` (its kernel read is the plain version on the
    CPU) against the JAX script's `compare` with its Pallas kernel in
    interpret mode, on the same banks."""
    jcheck, _, (mk, mv, q) = banks
    m = mk.shape[1]
    valid = np.arange(m) < m - TAIL

    def interpreted(mk_, mv_, q_, top_k, valid, backend, **kw):
        if backend == "pallas":
            return memory_read_pallas(mk_, mv_, q_, top_k=top_k, valid=valid, interpret=True)
        return jmemory_read(mk_, mv_, q_, top_k=top_k, valid=valid, backend=backend, **kw)

    jmemory_read = jcheck.memory_read
    monkeypatch.setattr(jcheck, "memory_read", interpreted)
    jdt = getattr(jnp, dtype)
    ref = jcheck.compare(jnp.asarray(mk).astype(jdt), jnp.asarray(mv).astype(jdt),
                         jnp.asarray(q), jnp.asarray(valid), "encoder", dtype,
                         with_approx=False)
    tdt = getattr(torch, dtype)
    got = kernel_check.compare(torch.from_numpy(mk).to(tdt), torch.from_numpy(mv).to(tdt),
                               torch.from_numpy(q), torch.from_numpy(valid), "encoder")
    scale = ref["readout_scale"]
    assert (got["regime"], got["M"], got["dtype"]) == ("encoder", m, dtype)
    assert got["readout_scale"] == pytest.approx(scale, rel=1e-5)
    for key in ("mean_abs_err", "max_abs_err"):
        assert abs(got[f"kernel_{key}"] - ref[f"pallas_{key}"]) <= 1e-4 * scale, key


def test_gate_holds_and_refuses(banks, small):
    """The gate on the CPU banks (the plain read against exact) passes
    inside the JAX bounds, reports the JAX keys, and refuses a read that
    drifted by 1e-2 of the scale."""
    _, _, (mk, mv, q) = banks
    args = [torch.from_numpy(x) for x in (mk, mv, q)]
    rep = kernel_check.gate(*args, log=lambda *a: None)
    assert [(r["M"], r["dtype"]) for r in rep["reports"]] == [
        (mk.shape[1] // 2, "float32"), (mk.shape[1] // 2, "bfloat16"),
        (mk.shape[1], "bfloat16")]
    assert 0 <= rep["worst_mean_err_frac"] < 1e-3
    real = kernel_check.memory_read

    def drifted(*a, backend="auto", **kw):
        out = real(*a, backend=backend, **kw)
        return out + 1e-2 * out.abs().mean() if backend == "auto" else out

    small.setattr(kernel_check, "memory_read", drifted)
    with pytest.raises(kernel_check.GateError):
        kernel_check.gate(*args, log=lambda *a: None)


def _bench_keys():
    """The keys bench.py prints (bench.py:137-146)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        text = f.read()
    body = text[text.index("print(json.dumps({"):]
    return re.findall(r'^\s*"(\w+)":', body[:body.index("}))")], re.M)


@pytest.fixture
def tiny_bench(small):
    for name, value in (("T", 6), ("RH", H), ("RW", W), ("SESSIONS", 2)):
        small.setattr(bench, name, value)
    small.setattr(kernel_check, "GATE_FRAMES", FRAMES)
    return small


def test_bench_prints_the_jax_keys_and_device(tiny_bench, capsys):
    rep = bench.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    keys = _bench_keys()
    assert len(keys) == 8 and "kernel_gate" in keys
    assert sorted(line) == sorted(keys + ["device"])
    assert line["metric"] == "propagation_fps_480p_3obj" and line["sessions"] == 2
    assert line["kernel_gate"]["ok"] is True
    assert 0 <= line["kernel_gate"]["worst_mean_err_frac"] < 1e-3
    assert line["device"]["name"] == "cpu"
    assert line["spread"][0] <= line["value"] <= line["spread"][1] == line["best"]
    assert rep["reads"] == 2 * (6 - 1)


def test_bench_refuses_the_headline_when_the_gate_fails(tiny_bench, capsys):
    def failing(dev, weights=None, log=None):
        raise kernel_check.GateError("kernel gate failed: drifted")

    tiny_bench.setattr(kernel_check, "gate_only", failing)
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu"])
    assert e.value.code == 1
    out, err = capsys.readouterr()
    assert "propagation_fps" not in out and "KERNEL GATE FAILED" in err


def test_refine_sweep_launch_arithmetic(banks):
    """Each row reads once on the CPU (no launches, no timing); on the
    card a read of n_refine r must launch the refine kernel and its merge
    r times and phases A and B once (the arithmetic the sweep holds its
    counters to)."""
    _, _, (mk, mv, q) = banks
    m = mk.shape[1]
    rep = refine_sweep.sweep(torch.from_numpy(mk), torch.from_numpy(mv),
                             torch.from_numpy(q), torch.arange(m) < m - TAIL,
                             log=lambda *a: None)
    assert [r["n_refine"] for r in rep["rows"]] == [0, 1, 2, 3]
    assert rep["reads"] == 4 and all(not any(c.values()) for c in rep["launches"])
    assert all(r["ms"] is None and r["max_abs_err"] >= r["mean_abs_err"] >= 0
               for r in rep["rows"])
    for r in (0, 1, 2, 3):
        tally = LaunchTally("cpu")
        tally.cuda = True
        tally.add(53, torch.bfloat16, r)
        assert tally.want["refine_bf16"] == tally.want["refine_merge"] == 53 * r
        assert tally.want["candidates_bf16"] == tally.want["readout_merge"] == 53
        assert tally.want["hilo_planes"] == tally.want["refine_f32"] == 0
        with pytest.raises(RuntimeError):
            tally.check("unlaunched")


def test_mfu_conv_phases_match_xla_cost(prop_weights):
    """FlopCounterMode's FLOPs of the query encode and the memorize (the
    port's net on the meta device: shapes only) against XLA's
    cost_analysis of the JAX phases at the production 480x864, K = 3:
    at most 1% above XLA's, which leaves out the window positions in a
    convolution's zero padding (13% at 64x96)."""
    _, tree, _ = prop_weights
    jmfu = _script("mfu_report")
    jnet = JPropagation(top_k=50)
    h, w = mfu_report.H, mfu_report.W
    image, masks = jnp.zeros((h, w, 3)), jnp.zeros((3, h, w, 1))
    ref = {"query_encode": jmfu.cost(
               lambda p, im: jnet.apply(p, im, method="get_query_values"), tree, image),
           "memorize": jmfu.cost(
               lambda p, im, m: jnet.apply(p, im, m, method="memorize"), tree, image, masks)}
    got = mfu_report.phase_costs(PropagationNetwork().to("meta"), "meta")
    for phase, r in ref.items():
        assert r["gflops"] <= got[phase]["gflops"] <= 1.01 * r["gflops"], phase
    n16, m = (h // 16) * (w // 16), mfu_report.M_BANK
    # Phase A: two bf16 passes of q.k; phase B: two of q.k and one of w.V.
    assert got["memory_read_only"]["gflops"] * 1e9 == \
        2 * (2 * 2 * 3 * n16 * m * 128) + 2 * 3 * n16 * m * 512


def _fbrs_weights(tmp_path):
    """A flax f-BRS tree (resnet34, ch 32, the last conv scaled by 10 as
    in tests/test_torch_fbrs.py) saved for both packages."""
    jnet = JFBRS(arch="resnet34", ch=32)
    abstract = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 2, 2)))
    tree = _random_tree(abstract, seed=21)
    out = tree["params"]["sep_head_out"]
    out["kernel"] = out["kernel"] * 10.0
    npz, pth = str(tmp_path / "fbrs.npz"), str(tmp_path / "fbrs.pth")
    save_params_npz(npz, tree)
    torch.save(fbrs_state_dict_from_flax(tree), pth)
    return npz, pth


def test_noc_trajectories_match_jax(tmp_path, monkeypatch, capsys):
    """Both scripts' --smoke evaluation (2 held-out scenes of 64x64, 3
    clicks, L-BFGS maxiter 3) on one weight set, the click model cut to
    ResNet-34 ch 32 in both."""
    import mivos_tpu.models.fbrs as jfbrs_module

    npz, pth = _fbrs_weights(tmp_path)
    monkeypatch.setattr(jfbrs_module, "FBRSDeepLabModel",
                        lambda arch, ch: JFBRS(arch="resnet34", ch=32))
    monkeypatch.setattr(noc_synthetic, "make_net",
                        lambda: FBRSDeepLabModel("resnet34", ch=32))
    jnoc = _script("noc_synthetic")
    monkeypatch.setattr(sys, "argv", ["noc_synthetic.py", "--smoke", "--weights", npz,
                                      "--out", str(tmp_path / "jax.json")])
    jnoc.main()
    with open(tmp_path / "jax.json") as f:
        ref = json.load(f)
    got = noc_synthetic.main(["--smoke", "--weights", pth, "--device", "cpu",
                              "--out", str(tmp_path / "port.json")])
    assert "NOC-SYNTHETIC-OK" in capsys.readouterr().out
    assert [len(t) for t in got["trajectories"]] == [len(t) for t in ref["trajectories"]]
    for g, r in zip(got["trajectories"], ref["trajectories"]):
        np.testing.assert_allclose(g, r, atol=1e-3, rtol=0)
    assert got["noc"] == ref["noc"] and got["over_max"] == ref["over_max"]
    with open(tmp_path / "port.json") as f:
        written = json.load(f)
    assert set(written) == set(ref) | {"device"}


def test_streamed_rounds_equal_an_unstreamed_interact():
    """At T = 12 (a pass of 11 frames streams 4-, 4- and 3-frame chunks,
    each handed over a chunk behind, so the first arrives mid-pass; at
    T = 8 it arrives with the pass's end) the polled rounds' masks equal
    the same interactions without polling, and the frames visible only
    grow. Then the whole protocol at 32x48: its reads and rounds."""
    dev = torch.device("cpu")
    t, h, w, k = 12, H, W, 2
    video = serve_streaming_bench.make_video(7, t, h, w)
    prop, _ = bench.make_nets(dev, fusion=False)
    polled, plain = (serve_streaming_bench.make_manager(dev, prop) for _ in range(2))
    sid, sid2 = polled.create(video, k), plain.create(video, k)
    for i, frame in enumerate([0, t - 1]):
        labels = serve_streaming_bench.labels_of(10 + i, h, w, k)
        masks, arrivals, wall = serve_streaming_bench.timed_round(polled, sid, labels, frame,
                                                                  poll_s=0.001)
        np.testing.assert_array_equal(masks, plain.interact(sid2, labels, frame))
        times, seen = [a[0] for a in arrivals], [a[1] for a in arrivals]
        assert times == sorted(times) and seen == sorted(set(seen)) and wall > 0
        assert all(0 < n < t for n in seen)
        if frame == 0:
            assert arrivals, "no chunk arrived before the pass ended"
    rep = serve_streaming_bench.run(serve_streaming_bench.make_manager(dev, prop), dev,
                                    t=t, h=32, w=48, k=k)
    # Frame 0: 11 reads; frame 11: the 10 between; frame 6: 4 + 5.
    assert rep["qcache_enabled"] and rep["reads"] == 11 + 10 + 9
    assert [r["frame"] for r in rep["rounds"]] == [0, t - 1]


def test_train_step_batch_and_first_loss_match_jax(prop_weights, monkeypatch):
    """make_batch bit for bit, and the first step's losses of the two
    trainers from the same weights on it (batch 2, 32x32)."""
    jbench = _script("train_step_bench")
    for name, value in (("B", 2), ("H", 32), ("W", 32)):
        monkeypatch.setattr(jbench, name, value)
    batch = train_step_bench.make_batch(1, 2, 32, 32)
    ref_batch = jbench.make_batch(1)
    assert sorted(batch) == sorted(ref_batch)
    for key in batch:
        np.testing.assert_array_equal(batch[key], ref_batch[key])
    monkeypatch.setattr(train_step_bench, "B", 2)
    trainer = train_step_bench.make_trainer("cpu")
    cfg = dict(iterations=1000, steps=(800,), batch_size=2)
    jtr = JFusionTrainer(JTrainConfig(**cfg), make_mesh(1))
    jtr.attn_params = jax.device_put(convert_attention_read(_numpy_sd(trainer.attn_net)),
                                     jtr.repl)
    jtr.fuse_params = jax.device_put(convert_fusion_net(_numpy_sd(trainer.fuse_net)),
                                     jtr.repl)
    jtr.opt_state = jax.device_put(jtr.tx.init(jtr.fuse_params), jtr.repl)
    ref = jtr.train_step(batch)
    got = trainer.train_step(batch)
    for key in ref:
        np.testing.assert_allclose(float(got[key]), float(ref[key]), rtol=LOSS_RTOL,
                                   err_msg=key)


def test_curriculum_iou_matches_jax(monkeypatch):
    """iou_per_frame against the JAX script's on random label maps; the
    port's A/B runs end to end (--smoke, random inits)."""
    jcur = _script("curriculum_ab")
    rng = np.random.RandomState(3)
    out, gt = rng.randint(0, 3, (5, 8, 9)), rng.randint(0, 3, (5, 8, 9))
    gt[:, :, :3] = 0   # frames where an object is absent from one side
    np.testing.assert_array_equal(curriculum_ab.iou_per_frame(out, gt, 2),
                                  jcur.iou_per_frame(out, gt, 2))
    rep = curriculum_ab.main(["--smoke", "--device", "cpu", "--out", os.devnull])
    assert len(rep["chain"]["iou_per_frame"]) == 6 and rep["chain"]["iou_per_frame"][0] == 1.0
    assert rep["reads"] == 2 * 5


def test_slim_and_latency_wiring(monkeypatch):
    """slim_decoder_bench --smoke and interactive_latency_bench at
    144x256 (a ResNet-34 ch 32 click model, ZoomIn 96) run end to end on
    the CPU: keys, session counts, the first call apart from the
    median."""
    rep = slim_decoder_bench.main(["--smoke", "--device", "cpu"])
    assert sorted(rep["fps"]) == ["0.5", "1.0"] and rep["reads"] == 2 * 11
    assert rep["speedup_slim_vs_ref"] == rep["median_fps"]["0.5"] / rep["median_fps"]["1.0"]
    for name, value in (("H", 144), ("W", 256), ("FBRS_CLICKS", 3), ("S2M_STROKES", 2),
                        ("ZOOM_IN", {"target_size": 96, "expansion_ratio": 1.4}),
                        ("make_fbrs_net", lambda: FBRSDeepLabModel("resnet34", ch=32))):
        monkeypatch.setattr(interactive_latency_bench, name, value)
    lat = interactive_latency_bench.main(["--device", "cpu"])
    assert len(lat["fbrs_s"]) == 3 and len(lat["s2m_s"]) == 2
    assert lat["fbrs_first_ms"] == 1e3 * lat["fbrs_s"][0]
    assert lat["s2m_scribble_median_ms"] == 1e3 * lat["s2m_s"][1]


def test_lifecycle_report_parsing():
    """Reports cut short by the kill drop out; the second run's reports
    of the same iterations count apart."""
    lines = ["lifecycle - It      2 [train] [p            ]: 1.0",
             "lifecycle - It      2 [train] [total_loss   ]: 2.5",
             "lifecycle - It      4 [train] [total_loss   ]: 2.4",
             "--- SIGKILL at about iteration 4; train exited -9 ---",
             "resumed at iteration 2",
             "lifecycle - It      4 [train] [p            ]: 0.15",
             "lifecycle - It      4 [train] [total_loss   ]: 2.2"]
    losses, shares = synthetic_lifecycle.reported(lines)
    assert losses == [2.5, 2.2] and shares == [1.0, 0.15]


ENTRY_POINTS = (bench, curriculum_ab, interactive_latency_bench, kernel_check, mfu_report,
                noc_synthetic, refine_sweep, serve_streaming_bench, slim_decoder_bench,
                synthetic_lifecycle, train_step_bench)


@pytest.mark.parametrize("module", ENTRY_POINTS, ids=lambda m: m.__name__.split(".")[-1])
def test_entry_point_defaults_to_the_card_and_refuses_without_one(module, monkeypatch):
    assert module.parse_args([]).device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        module.main([])
