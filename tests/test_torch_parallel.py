"""The port's multi-device inference paths on the CPU, against the JAX
package on the 8 virtual CPU devices that tests/conftest.py makes.

The port's meshes repeat the `cpu` device (an explicit devices= list),
so one process runs every position, as JAX's single controller does; no
process group is needed. Inputs are numpy arrays from a seed.

Tolerances: the sharded reads are exact top-k reads whose sums run in
another order than the reference's (JAX psums its shards' partials, the
port adds them on the query's device): 1e-5 of readouts near 1. The
sessions are held to the JAX unsharded session, which JAX's own tests
hold its sharded sessions equal to (test_sharded_memory.py:132,161;
test_object_sharded.py:52,88,215), with tests/test_torch_session.py's
bounds: probabilities within 1e-4 two rounds deep, and labels equal
where JAX decides by more than 1e-3.
"""
import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import convert_fusion_net, convert_prop_net
from mivos_tpu.config import MemoryConfig as JMemoryConfig
from mivos_tpu.core.inference import InferenceCore as JInferenceCore
from mivos_tpu.models.fusion import FusionNet as JFusionNet
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.ops.memory_read import memory_read as j_memory_read
from mivos_tpu.parallel import mesh as jmesh
from mivos_tpu.parallel import sharded_memory as jsm
from mivos_tpu_torch import eval_interactive_davis as cli
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.core.memory_bank import MemoryBank
from mivos_tpu_torch.eval.davis_interactive import (_adapt_sharding,
                                                    run_local_interactive,
                                                    run_local_interactive_fleet)
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.ops.memory_read import memory_read
from mivos_tpu_torch.parallel.dryrun import dryrun_multichip
from mivos_tpu_torch.parallel.mesh import make_mesh, make_mesh_nd
from mivos_tpu_torch.parallel.sharded_memory import (bank_sharding,
                                                     object_sharded_memory_read,
                                                     shard_bank,
                                                     sharded_bank_write,
                                                     sharded_memory_read)

CPU8 = ["cpu"] * 8
READ_ATOL = 1e-5
PROB_ATOL, MARGIN = 1e-4, 1e-3
T, H, W, K, TOP_K, MEM_FREQ = 4, 32, 48, 2, 10, 2   # the dry run's sizes


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bank(seed, k, m, n, cv=256):
    rng = np.random.RandomState(seed)
    return (rng.randn(k, m, 128).astype(np.float32),
            rng.randn(k, m, cv).astype(np.float32),
            rng.randn(n, 128).astype(np.float32))


# ---------------------------------------------------------------- reads

@pytest.mark.parametrize("d", [2, 4, 8])
def test_sharded_read_matches_jax(d):
    mk, mv, q = _bank(0, 2, 1024, 96)
    valid = np.arange(1024) < 900
    jm = jmesh.make_mesh(d)
    ref = jsm.sharded_memory_read(jm, *jsm.shard_bank(jm, jnp.asarray(mk),
                                                      jnp.asarray(mv)),
                                  jnp.asarray(q), top_k=20,
                                  valid=jnp.asarray(valid))
    mesh = make_mesh(d, devices=CPU8)
    out = sharded_memory_read(mesh, *shard_bank(mesh, torch.from_numpy(mk),
                                                torch.from_numpy(mv)),
                              torch.from_numpy(q), top_k=20,
                              valid=torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=READ_ATOL)


def test_small_bank_degenerates_gracefully():
    """top_k above every shard's rows: the pool is the whole bank, as in
    JAX's test_small_bank_degenerates_gracefully."""
    mk, mv, q = _bank(1, 1, 64, 32, cv=64)
    ref = j_memory_read(jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(q),
                        top_k=64, backend="xla_exact")
    mesh = make_mesh(8, devices=CPU8)
    out = sharded_memory_read(mesh, *shard_bank(mesh, torch.from_numpy(mk),
                                                torch.from_numpy(mv)),
                              torch.from_numpy(q), top_k=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=READ_ATOL)


def test_uneven_and_empty_shards_match_the_exact_read():
    """A session's live view: shards of 3, 1, 0 and 0 slots of 40 rows."""
    mk, mv, q = (torch.from_numpy(a) for a in _bank(2, 3, 160, 50))
    mesh = make_mesh(4, devices=CPU8)
    grid_k, grid_v = (np.empty(4, dtype=object) for _ in range(2))
    for i, (a, b) in enumerate(((0, 120), (120, 160), (160, 160), (160, 160))):
        grid_k[i], grid_v[i] = mk[:, a:b], mv[:, a:b]
    out = sharded_memory_read(mesh, grid_k, grid_v, q, top_k=50)
    ref = memory_read(mk, mv, q, top_k=50, backend="exact")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=READ_ATOL)
    grid_k[0], grid_v[0] = mk[:, :0], mv[:, :0]
    grid_k[1], grid_v[1] = mk[:, :0], mv[:, :0]
    with pytest.raises(ValueError, match="empty"):
        sharded_memory_read(mesh, grid_k, grid_v, q, top_k=50)


def test_2d_read_matches_jax():
    mk, mv, q = _bank(7, 2, 1024, 96)
    valid = np.arange(1024) < 900
    jm = jmesh.make_mesh_nd(object=2, data=4)
    ref = jsm.sharded_memory_read(
        jm, *jsm.shard_bank(jm, jnp.asarray(mk), jnp.asarray(mv),
                            object_axis="object"),
        jnp.asarray(q), top_k=20, valid=jnp.asarray(valid), object_axis="object")
    mesh = make_mesh_nd(object=2, data=4, devices=CPU8)
    grids = shard_bank(mesh, torch.from_numpy(mk), torch.from_numpy(mv),
                       object_axis="object")
    assert grids[0][1, 2].shape == (1, 256, 128)   # object 1, rows 512-767
    out = sharded_memory_read(mesh, *grids, torch.from_numpy(q), top_k=20,
                              valid=torch.from_numpy(valid), object_axis="object")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=READ_ATOL)


@pytest.mark.parametrize("backend", ["exact", "auto"])
def test_object_sharded_read_matches_jax_exact(backend):
    """'exact' on each shard against JAX's exact read; 'auto' (on the CPU
    the kernel algorithm's plain version, a superset of the top-k whose
    extra weights are below e^-30 of the row max here) likewise."""
    mk, mv, q = _bank(11, 2, 512, 96)
    valid = np.arange(512) < 472
    ref = j_memory_read(jnp.asarray(mk), jnp.asarray(mv), jnp.asarray(q),
                        top_k=20, valid=jnp.asarray(valid), backend="xla_exact")
    mesh = make_mesh(2, axis="object", devices=CPU8)
    grids = shard_bank(mesh, torch.from_numpy(mk), torch.from_numpy(mv),
                       axis=None, object_axis="object")
    out = object_sharded_memory_read(mesh, *grids, torch.from_numpy(q), top_k=20,
                                     valid=torch.from_numpy(valid), backend=backend)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.fixture(scope="module")
def bank_write_case():
    """A bank, a frame's rows and their offset (slot 5: an interior
    position shard's), and JAX's sharded_bank_write of them over 8
    position shards (the dense result whatever the layout)."""
    rng = np.random.RandomState(3)
    k, cap, n, c = 2, 8, 16, 32
    bank = rng.randn(k, cap * n, c).astype(np.float32)
    data = rng.randn(k, n, c).astype(np.float32)
    row = 5 * n
    jm = jmesh.make_mesh(8)
    ref = np.asarray(jsm.sharded_bank_write(
        jm, jax.device_put(jnp.asarray(bank), jsm.bank_sharding(jm)),
        jnp.asarray(data), row))
    return bank, data, row, ref


@pytest.mark.parametrize("copies", [1, 2])
def test_sharded_bank_write_matches_jax(bank_write_case, copies):
    """A frame's rows land in the shard that owns them, against JAX's
    sharded_bank_write: 8 position shards, or 4 held twice over a second
    mesh axis (every copy of the owner is written)."""
    bank, data, row, ref = bank_write_case
    k, n, c = data.shape
    mesh = make_mesh_nd(copy=copies, data=8 // copies, devices=CPU8)
    sh = bank_sharding(mesh, "data")
    grid = sharded_bank_write(mesh, sh.shard(torch.from_numpy(bank)),
                              torch.from_numpy(data), row)
    for c0 in range(copies):
        np.testing.assert_array_equal(
            torch.cat(list(grid[c0]), dim=1).numpy(), ref)
    local_m = bank.shape[1] // mesh.shape["data"]
    with pytest.raises(ValueError, match="one shard"):   # straddles two
        sharded_bank_write(mesh, grid, torch.zeros(k, n, c), local_m - n // 2)


def test_sharded_bank_keeps_whole_slots():
    """A 3-position bank (not a power of two) rounds its capacity up to
    whole slots per shard; the live view follows the committed slots."""
    n = 4
    bank = MemoryBank(1, n, key_dim=8, val_dim=8, device="cpu",
                      mesh=make_mesh(3, devices=CPU8))
    seed = torch.arange(2 * n * 8, dtype=torch.float32).reshape(1, 2 * n, 8)
    bank.reset(7, seed, seed)
    assert bank.cap == 9 and [x.shape[1] for x in bank.keys] == [3 * n] * 3
    assert bank.num_slots == 2
    bank.write(2, torch.ones(1, n, 8), torch.ones(1, n, 8))
    bank.write(3, torch.full((1, n, 8), 2.0), torch.full((1, n, 8), 2.0))
    bank.num_slots = 3
    keys, _ = bank.live(include_transient=True)   # slots 0-3
    assert [x.shape[1] for x in keys] == [3 * n, n, 0]
    np.testing.assert_array_equal(keys[0][:, :2 * n].numpy(), seed.numpy())
    assert float(keys[0][:, 2 * n:].mean()) == 1.0 and float(keys[1].mean()) == 2.0


# ---------------------------------------------------------------- meshes

def test_meshes_never_stand_in_for_missing_devices():
    with pytest.raises(ValueError, match="need 9 devices"):
        make_mesh(9, devices=CPU8)
    with pytest.raises(ValueError, match=">= 1"):
        make_mesh_nd(object=16, data=0, devices=CPU8)
    if torch.cuda.device_count() == 0:
        with pytest.raises(ValueError):
            make_mesh()
        with pytest.raises(ValueError, match="need 2 devices"):
            make_mesh_nd(object=1, data=2)
    m = make_mesh_nd(object=2, data=4, devices=CPU8)
    assert m.shape == {"object": 2, "data": 4} and m.size == 8
    assert m.sub(object=1).axis_names == ("data",)


# ---------------------------------------------------------------- sessions

def _mask(seed):
    labels = np.random.RandomState(seed).randint(0, K + 1, (H, W))
    fg = (labels[None] == np.arange(1, K + 1)[:, None, None]).astype(np.float32)
    return np.concatenate([1.0 - fg.sum(0, keepdims=True), fg], 0)[..., None]


@pytest.fixture(scope="module")
def nets():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    prop = init_params(PropagationNetwork(top_k=TOP_K, read_backend="exact"), gen)
    fuse = init_params(FusionNet(), gen)
    images = np.random.RandomState(0).rand(T, H, W, 3).astype(np.float32)
    return prop, fuse, images


@pytest.fixture(scope="module")
def jax_session(nets):
    """The JAX unsharded two-round session: frame 0, then frame T-1
    (fusion): per round the labels and the (T, K+1, H, W) probabilities.
    It runs JAX's per-frame path (mem_profile=1), whose small step
    functions compile in about 9 s on an 8-core CPU against 15 s for the scan
    passes; JAX holds the two paths to the same labels
    (tests/test_inference_core.py::test_host_offload_profile_matches_device)."""
    prop, fuse, images = nets
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}  # noqa: E731
    core = JInferenceCore(JPropagation(top_k=TOP_K, read_backend="xla_exact"),
                          convert_prop_net(sd(prop)), JFusionNet(),
                          convert_fusion_net(sd(fuse)), images, K,
                          mem=JMemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ,
                                            mem_profile=1))
    out = []
    for idx, seed in ((0, 1), (T - 1, 2)):
        lab = np.array(core.interact(jnp.asarray(_mask(seed)), idx))
        out.append((lab, np.stack([np.asarray(core.get_prob(t))[..., 0]
                                   for t in range(T)])))
    return out


SESSIONS = {
    "bank": (lambda: make_mesh(8, devices=CPU8), dict(bank_sharded=True)),
    "object": (lambda: make_mesh(2, axis="object", devices=CPU8),
               dict(object_sharded=True)),
    "2d": (lambda: make_mesh_nd(object=2, data=4, devices=CPU8),
           dict(object_sharded=True, bank_sharded=True)),
}


@pytest.mark.parametrize("mode", list(SESSIONS))
def test_sharded_session_matches_jax(nets, jax_session, mode):
    prop, fuse, images = nets
    make, sharding = SESSIONS[mode]
    mesh = make()
    core = InferenceCore(prop, fuse, images, K, mesh=mesh, device="cpu",
                         mem=MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ,
                                          **sharding))
    assert core.device == torch.device("cpu")
    assert [(s.lo, s.hi) for s in core.shards] == (
        [(0, 1), (1, 2)] if "object_sharded" in sharding else [(0, K)])
    for (jlab, jprob), (idx, seed) in zip(jax_session, ((0, 1), (T - 1, 2))):
        lab = core.interact(_mask(seed), idx).copy()
        prob = np.stack([core.get_prob(t)[:, 0].numpy() for t in range(T)])
        np.testing.assert_allclose(prob, jprob, atol=PROB_ATOL)
        top2 = -np.sort(-jprob, axis=1)[:, :2]
        lw, uw, lh, uh = core.pad
        decided = (top2[:, 0] - top2[:, 1] > MARGIN)[:, lh:core.nh - uh,
                                                     lw:core.nw - uw]
        assert (lab == jlab)[decided].all()
    if sharding.get("bank_sharded"):
        bank = core.shards[0].bank
        assert len(bank.keys) == (8 if mode == "bank" else 4)
        assert bank.cap % len(bank.keys) == 0
        # Early slots live in the first shard only.
        assert bank.live(False)[0][-1].shape[1] == 0


@pytest.mark.parametrize("route", ["bank", "object", "2d"])
def test_segment_logits_routes_sharded_banks(nets, route):
    """PropagationNetwork.segment_logits with bank_mesh (grids of position
    shards, the exact sharded read), object_mesh (grids of object
    shards, each read on its own device) or both (the 2D read) against
    the same read on the whole bank; read_memory(gather=False), as the
    sessions read, gives each object shard's rows of that readout."""
    import copy

    prop, _, images = nets
    mk, mv, _ = _bank(5, K, 18, 1, cv=512)      # 3 frames of 2x3 keys
    feats = prop.get_query_values(torch.from_numpy(images[0]))
    ref = prop.segment_logits(torch.from_numpy(mk), torch.from_numpy(mv), None,
                              *feats)
    net = copy.copy(prop)
    obj = None if route == "bank" else "object"
    if route == "bank":
        net.bank_mesh = mesh = make_mesh(3, devices=CPU8)
    elif route == "object":
        net.object_mesh = mesh = make_mesh(K, axis="object", devices=CPU8)
    else:
        net.bank_mesh = net.object_mesh = mesh = make_mesh_nd(
            object=K, data=3, devices=CPU8)
    grids = shard_bank(mesh, torch.from_numpy(mk), torch.from_numpy(mv),
                       axis=None if route == "object" else "data", object_axis=obj)
    out = net.segment_logits(*grids, None, *feats)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-4)
    whole = net.read_memory(*grids, None, feats[3])
    parts = net.read_memory(*grids, None, feats[3], gather=False)
    assert len(parts) == (1 if route == "bank" else K)
    np.testing.assert_array_equal(torch.cat(parts).detach().numpy(),
                                  whole.detach().numpy())


def test_session_validation_errors(nets):
    prop, _, images = nets
    cpu2 = make_mesh(2, devices=CPU8)
    with pytest.raises(ValueError, match="requires a mesh"):
        InferenceCore(prop, None, images, 1, mem=MemoryConfig(bank_sharded=True))
    with pytest.raises(ValueError, match="requires a mesh"):
        InferenceCore(prop, None, images, 1, mem=MemoryConfig(object_sharded=True))
    with pytest.raises(ValueError, match="2D mesh"):
        InferenceCore(prop, None, images, 1, mesh=cpu2,
                      mem=MemoryConfig(object_sharded=True, bank_sharded=True))
    with pytest.raises(ValueError, match="divisible"):
        InferenceCore(prop, None, images, 3,
                      mesh=make_mesh(2, axis="object", devices=CPU8),
                      mem=MemoryConfig(object_sharded=True))
    with pytest.raises(ValueError, match="km"):
        InferenceCore(prop, None, images, 1, mesh=cpu2,
                      mem=MemoryConfig(bank_sharded=True, km=5.0))
    with pytest.raises(ValueError, match="first device"):
        InferenceCore(prop, None, images, 1, mesh=cpu2, device="cuda:0",
                      mem=MemoryConfig(bank_sharded=True))


# ---------------------------------------------------------------- entry points

def test_adapt_sharding_downgrades_indivisible_k():
    mem = MemoryConfig(object_sharded=True, bank_sharded=True)
    mesh = make_mesh_nd(object=2, data=4, devices=CPU8)
    m2, s2 = _adapt_sharding(mem, mesh, 4)
    assert m2 is mem and s2 is mesh
    m3, s3 = _adapt_sharding(mem, mesh, 3)
    assert not m3.object_sharded and m3.bank_sharded
    assert s3.axis_names == ("data",) and s3.size == 8
    m4, s4 = _adapt_sharding(dataclasses.replace(mem, bank_sharded=False), mesh, 3)
    assert not m4.object_sharded and s4 is None


@pytest.fixture(scope="module")
def protocol(nets):
    """An S2M net and two 3-frame 48x64 sequences, K = 2 and 1."""
    s2m = init_params(S2MNetwork(), torch.Generator().manual_seed(2))
    t, h, w = 3, 48, 64
    rng = np.random.RandomState(3)
    sequences = {}
    for name, k in (("two", 2), ("one", 1)):
        gt = np.zeros((t, h, w), np.int32)
        gt[:, 8:24, 8:28] = 1
        if k == 2:
            gt[:, 28:44, 36:60] = 2
        sequences[name] = (rng.rand(t, h, w, 3).astype(np.float32), gt, k)
    return nets[0], s2m, sequences


def test_local_protocol_with_object_sharding(protocol):
    """The hermetic protocol (robot, S2M, propagation) on an object mesh:
    one sequence divides it, the other runs unsharded."""
    prop, s2m, sequences = protocol
    summary = run_local_interactive(
        prop, None, s2m, sequences, max_nb_interactions=2,
        max_time_per_interaction=1000,
        mem=MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ, object_sharded=True),
        mesh=make_mesh(2, axis="object", devices=CPU8), device="cpu")
    assert 0.0 <= summary["auc"] <= 1.0
    assert {r["sequence"] for r in summary["rounds"]} == {"one", "two"}


def test_fleet_matches_serial_metric_values(protocol):
    """One session per sequence per device: each sequence's J&F values
    equal the serial run's (robot state is per sequence; only the
    wall-clock times differ)."""
    prop, s2m, sequences = protocol
    mem = MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)
    kw = dict(max_nb_interactions=2, max_time_per_interaction=1000, mem=mem)
    serial = run_local_interactive(prop, None, s2m, sequences, device="cpu", **kw)
    fleet = run_local_interactive_fleet(prop, None, s2m, sequences,
                                        devices=["cpu", "cpu"], **kw)
    assert set(fleet["records"]) == set(serial["records"])
    for name, recs in serial["records"].items():
        np.testing.assert_allclose([v for _, v in fleet["records"][name]],
                                   [v for _, v in recs], atol=1e-6)


def test_fleet_rejects_sharded_sessions():
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_local_interactive_fleet(None, None, None, {},
                                    mem=MemoryConfig(bank_sharded=True))


def test_cli_sharding_flags(monkeypatch, tmp_path):
    base = ["--output", str(tmp_path), "--device", "cpu"]
    args = cli.parse_args(base + ["--bank_sharded", "--object_shards", "2"])
    assert args.bank_sharded and args.object_shards == 2 and not args.fleet
    with pytest.raises(SystemExit, match="exclusive"):
        cli.main(base + ["--fleet", "--object_shards", "2"])
    # The mesh is over the host's cards and never repeats one.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = cli.session_mesh(args)
    assert mesh.shape == {"object": 2, "data": 2}
    assert [str(d) for d in mesh.devices.reshape(-1)] == [
        "cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert cli.session_mesh(argparse.Namespace(
        bank_sharded=True, object_shards=0)).shape == {"data": 4}
    assert cli.session_mesh(argparse.Namespace(
        bank_sharded=False, object_shards=3)).shape == {"object": 3}
    with pytest.raises(SystemExit, match="must divide"):
        cli.session_mesh(argparse.Namespace(bank_sharded=True, object_shards=3))
    with pytest.raises(ValueError, match="need 8 devices"):
        cli.session_mesh(argparse.Namespace(bank_sharded=False, object_shards=8))


def test_dryrun_multichip_on_eight_cpu_positions():
    report = dryrun_multichip(8, CPU8)
    assert set(report) == {"trainer", "sharded_read", "bank_session",
                           "object_session", "session_2d"}
    assert "gloo world 8" in report["trainer"]
    assert "8 object shards" in report["object_session"]
