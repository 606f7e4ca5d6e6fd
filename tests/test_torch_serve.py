"""The PyTorch port's serving path against the JAX package's, on the CPU.

(a) Two rounds through the port's SessionManager and the JAX one on the
fixture of tests/test_torch_session.py (T=8, 45x62 frames padded to
48x64, K=2, top_k=10, mem_freq=2, the same weights): labels agree where
JAX's probabilities decide by more than MARGIN. (b) The chunk stream of
InferenceCore.interact(chunk_cb=...) in both packages. (c) The manager's
semantics, ported from tests/test_serve.py (T=3, 48x64). (d) The HTTP
API: both servers answer the same requests with the same status codes
and keys. (e) `python -m mivos_tpu_torch.serve` in a subprocess. (f) No
CPU fallback. Plus the launch counters under threads and the fleet.
"""
import io
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

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
from mivos_tpu.serve import SessionManager as JSessionManager
from mivos_tpu.serve import make_server as jmake_server
from mivos_tpu.utils.tensor import labels_to_probs as jlabels_to_probs
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.inference import InferenceCore
from mivos_tpu_torch.eval.fleet import fleet_map, propagate_videos
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.ops.cuda import memory_read as cmr
from mivos_tpu_torch.serve import SessionManager, make_server
from mivos_tpu_torch.serve.server import CapacityError, SessionNotFound
from mivos_tpu_torch.utils.tensor import labels_to_probs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T, RH, RW, K = 8, 45, 62, 2          # parity fixture (test_torch_session.py)
TOP_K, MEM_FREQ = 10, 2
ROUNDS = (3, 7)
PROB_ATOL = 1e-4      # fp32 conv/matmul summation order, two rounds deep
MARGIN = 1e-3         # labels must agree where JAX decides by more than this
ST, SH, SW = 3, 48, 64               # manager semantics (test_serve.py)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module's sessions: the suite runs
    several test processes on the same cores, and torch's OpenMP pool in
    each of them then spins against the others (a two-round session that
    takes a second alone took minutes so)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _numpy_sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def nets():
    """The port's random-init nets and their JAX counterparts."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    prop = init_params(PropagationNetwork(top_k=TOP_K, read_backend="exact"),
                       gen)
    fuse = init_params(FusionNet(), gen)
    jax_nets = (JPropagation(top_k=TOP_K, read_backend="xla_exact"),
                convert_prop_net(_numpy_sd(prop)), JFusionNet(),
                convert_fusion_net(_numpy_sd(fuse)))
    return prop, fuse, jax_nets


def _mem():
    return MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)


def _jmem():
    return JMemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ)


def _video(seed, t=T, h=RH, w=RW):
    return (np.random.RandomState(seed).rand(t, h, w, 3) * 255).astype(np.uint8)


def _labels(h=SH, w=SW):
    lab = np.zeros((h, w), np.uint8)
    lab[8:24, 8:28] = 1
    lab[28:44, 36:60] = 2
    return lab


def _manager(nets, max_sessions=3):
    return SessionManager(nets[0], mem=_mem(), devices=["cpu"],
                          max_sessions=max_sessions)


def _probs(core, jax_core=False):
    if jax_core:
        return np.stack([np.asarray(core.get_prob(t))[..., 0]
                         for t in range(core.t)])
    return np.stack([core.get_prob(t)[:, 0].numpy() for t in range(core.t)])


# ------------------------------------------------------------------- (a)

@pytest.fixture(scope="module")
def parity_rounds(nets):
    prop, fuse, jnets = nets
    video = _video(0)
    rng = np.random.RandomState(1)
    rounds = [(idx, rng.randint(0, K + 1, (RH, RW)).astype(np.uint8))
              for idx in ROUNDS]
    jmgr = JSessionManager(*jnets, mem=_jmem(), devices=[jax.devices()[0]])
    mgr = SessionManager(prop, fuse, mem=_mem(), devices=["cpu"])
    jsid, sid = jmgr.create(video, K), mgr.create(video, K)
    out = []
    for idx, lab in rounds:
        jlab, lab_t = jmgr.interact(jsid, lab, idx), mgr.interact(sid, lab, idx)
        out.append((jlab, _probs(jmgr._get(jsid).core, jax_core=True), lab_t,
                    _probs(mgr._get(sid).core), mgr.progress(sid),
                    mgr.masks(sid)))
    return mgr._get(sid).core.pad, out


@pytest.mark.parametrize("round_i", [0, 1])
def test_manager_matches_jax_session(parity_rounds, round_i):
    (lw, uw, lh, uh), out = parity_rounds
    jlab, jprob, lab, prob, progress, masks = out[round_i]
    assert lab.shape == (T, RH, RW) and lab.dtype == np.uint8
    np.testing.assert_allclose(prob, jprob, atol=PROB_ATOL, rtol=0)
    top2 = np.sort(jprob, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0])[:, lh:48 - uh, lw:64 - uw] > MARGIN
    assert decided.mean() > 0.5, decided.mean()
    np.testing.assert_array_equal(lab[decided], jlab[decided])
    # The round's stream and /masks hold the returned labels.
    assert progress["round"] == round_i + 1 and progress["done"]
    np.testing.assert_array_equal(progress["frames"], np.arange(T))
    np.testing.assert_array_equal(progress["masks"], lab)
    np.testing.assert_array_equal(masks, lab)


# ------------------------------------------------------------------- (b)

@pytest.mark.parametrize("t,idx", [(12, 5), (33, 0)])
def test_chunk_stream_matches_jax(nets, t, idx):
    """The same chunks as the JAX scan (16-frame chunks, then 4-frame
    tails; at T=33 the 32-frame pass is whole 16-frame chunks and splits
    its last), each propagated frame once, equal to the final labels."""
    prop, _, (jprop, jparams, _, _) = nets
    video = _video(3, t=t)
    mask = np.array(jlabels_to_probs(jnp.asarray(_labels(RH, RW)), K))
    jcore = JInferenceCore(jprop, jparams, None, None, video, K, mem=_jmem())
    jgot = []
    jcore.interact(jnp.asarray(mask), idx,
                   chunk_cb=lambda tis, labs: jgot.append(list(tis)))
    core = InferenceCore(prop, None, video, K, mem=_mem(), device="cpu")
    got = []
    final = core.interact(mask, idx, chunk_cb=lambda tis, labs: got.append(
        (list(tis), labs.copy()))).copy()
    assert [tis for tis, _ in got] == jgot
    seen = []
    for tis, labs in got:
        assert labs.shape == (len(tis), RH, RW) and labs.dtype == np.uint8
        np.testing.assert_array_equal(labs, final[tis])
        seen += tis
    assert sorted(seen) == [ti for ti in range(t) if ti != idx]


def test_progress_hooks_leave_the_round_unchanged(nets):
    """total_cb gets the frames the passes propagate (front - back - 2),
    step_cb runs once for each, and a round with hooks returns what the
    same round returns without them."""
    prop, fuse, _ = nets
    video, mask = _video(4), labels_to_probs(_labels(RH, RW), K)
    plain = InferenceCore(prop, fuse, video, K, mem=_mem(), device="cpu")
    hooked = InferenceCore(prop, fuse, video, K, mem=_mem(), device="cpu")
    # Round 2 on frame 6 runs to the end (7) and back to frame 2.
    for idx, frames in ((2, [0, 1, 3, 4, 5, 6, 7]), (6, [3, 4, 5, 7])):
        totals, steps, chunks = [], [], []
        ref = plain.interact(mask, idx).copy()
        out = hooked.interact(mask, idx, total_cb=totals.append,
                              step_cb=lambda: steps.append(1),
                              chunk_cb=lambda tis, labs: chunks.extend(tis))
        assert totals == [len(frames)] and len(steps) == len(frames)
        assert sorted(chunks) == frames
        np.testing.assert_array_equal(out, ref)


# ------------------------------------------------------------------- (c)

@pytest.fixture(scope="module")
def manager(nets):
    return _manager(nets)


class TestSessionManager:
    def test_create_interact_masks_close(self, manager):
        sid = manager.create(_video(0, ST, SH, SW), K)
        out = manager.interact(sid, _labels(), 0)
        assert out.shape == (ST, SH, SW) and out.dtype == np.uint8
        assert out.max() <= K
        assert (out[0] == _labels()).mean() > 0.99
        np.testing.assert_array_equal(manager.masks(sid), out)
        assert manager.close(sid) and not manager.close(sid)

    def test_bad_video_shape_rejected(self, manager):
        with pytest.raises(ValueError, match="T, H, W, 3"):
            manager.create(np.zeros((SH, SW, 3), np.uint8), 1)

    def test_warm_runs_and_cleans_up(self, manager):
        before = len(manager)
        assert manager.warm(ST, SH, SW, K) > 0 and len(manager) == before
        assert manager.warm(ST, SH, SW, K, interactions=3) > 0
        assert len(manager) == before

    def test_metrics(self, manager):
        sid = manager.create(_video(9, ST, SH, SW), K)
        manager.interact(sid, _labels(), 0)
        st = manager.stats()
        assert st["created"] >= 1 and st["interactions"] >= 1
        assert st["interact_p50_s"] is not None and st["devices"] == 1
        manager.close(sid)

    def test_lru_eviction(self, manager):
        sids = [manager.create(_video(s, ST, SH, SW), 1) for s in range(4)]
        assert len(manager) <= 3
        with pytest.raises(KeyError):
            manager.interact(sids[0], _labels(), 0)  # evicted (oldest)
        assert manager.masks(sids[-1]).shape == (ST, SH, SW)
        for s in sids[1:]:
            manager.close(s)

    def test_masks_are_a_snapshot(self, manager):
        sid = manager.create(_video(12, ST, SH, SW), K)
        out1 = manager.interact(sid, _labels(), 0)
        snap = out1.copy()
        inv = np.where(_labels() == 0, 1, 0).astype(np.uint8)
        manager.interact(sid, inv, ST - 1)
        np.testing.assert_array_equal(out1, snap)
        manager.close(sid)


class TestCapacity:
    def test_hard_cap_times_out_when_all_busy(self, manager):
        sids = [manager.create(_video(40 + i, ST, SH, SW), 1)
                for i in range(3)]
        held = [manager._get(s).lock for s in sids]
        for lk in held:
            lk.acquire()  # simulate in-flight interactions
        try:
            with pytest.raises(CapacityError):
                manager.create(_video(50, ST, SH, SW), 1, timeout=0.2)
            assert len(manager) == 3
        finally:
            for lk in held:
                lk.release()
        for s in sids:
            manager.close(s)

    def test_blocked_create_proceeds_when_room_frees(self, manager):
        sids = [manager.create(_video(60 + i, ST, SH, SW), 1)
                for i in range(3)]
        held = [manager._get(s).lock for s in sids]
        for lk in held:
            lk.acquire()
        result = {}
        th = threading.Thread(target=lambda: result.update(
            sid=manager.create(_video(70, ST, SH, SW), 1, timeout=10.0)))
        th.start()
        th.join(0.2)
        assert th.is_alive()  # genuinely blocked at capacity
        held[0].release()
        manager.close(sids[0])  # frees a slot + notifies
        th.join(10.0)
        assert not th.is_alive() and "sid" in result
        assert len(manager) <= manager.max_sessions
        for lk in held[1:]:
            lk.release()
        for s in sids[1:] + [result["sid"]]:
            manager.close(s)


def test_hammer_mixed_ops(manager):
    """4 threads x mixed create/interact/masks/close: only the pressure
    outcomes (KeyError on eviction, CapacityError when every slot is
    busy), the session count bounded, the counters consistent."""
    errs, created = [], []

    def worker(seed):
        rng = np.random.RandomState(seed)
        try:
            for i in range(3):
                try:
                    sid = manager.create(_video(seed * 10 + i, ST, SH, SW), K)
                except CapacityError:
                    continue
                created.append(sid)
                try:
                    out = manager.interact(sid, _labels(), 0)
                    assert out.shape == (ST, SH, SW)
                    assert manager.masks(sid).shape == (ST, SH, SW)
                except KeyError:
                    pass
                if rng.rand() < 0.5:
                    manager.close(sid)
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(s,)) for s in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120.0)
    assert not any(th.is_alive() for th in threads)
    assert not errs, errs
    assert len(manager) <= manager.max_sessions
    assert created and manager.stats()["created"] >= len(created)


class TestEvictionRace:
    def test_evicted_session_marked_closed(self, nets):
        mgr = _manager(nets, max_sessions=1)
        sid_a = mgr.create(_video(20, ST, SH, SW), 1)
        s_a = mgr._get(sid_a)
        mgr.create(_video(21, ST, SH, SW), 1)  # evicts A (idle LRU)
        assert s_a.closed
        with pytest.raises(KeyError):
            mgr.interact(sid_a, _labels(), 0)

    def test_interact_resolved_before_eviction_404s(self, nets, monkeypatch):
        mgr = _manager(nets, max_sessions=1)
        sid_a = mgr.create(_video(22, ST, SH, SW), 1)
        stale = mgr._get(sid_a)
        mgr.create(_video(23, ST, SH, SW), 1)
        monkeypatch.setattr(mgr, "_get", lambda sid: stale)
        with pytest.raises(SessionNotFound):
            mgr.interact(sid_a, _labels(), 0)
        with pytest.raises(SessionNotFound):
            mgr.masks(sid_a)

    def test_busy_session_never_evicted(self, nets):
        mgr = _manager(nets, max_sessions=1)
        s = mgr._get(mgr.create(_video(24, ST, SH, SW), 1))
        s.lock.acquire()
        try:
            with pytest.raises(CapacityError):
                mgr.create(_video(25, ST, SH, SW), 1, timeout=0.2)
            assert not s.closed and len(mgr) == 1
        finally:
            s.lock.release()


def _wait_locked(lock):
    for _ in range(4000):
        if lock.locked():
            return
        time.sleep(0.005)
    raise AssertionError("the interaction never took the session lock")


class TestShutdown:
    def test_drain_waits_for_inflight_interact(self, nets):
        mgr = _manager(nets, max_sessions=2)
        sid = mgr.create(_video(30, ST, SH, SW), K)
        result = {}
        th = threading.Thread(target=lambda: result.update(
            out=mgr.interact(sid, _labels(), 0)))
        th.start()
        _wait_locked(mgr._get(sid).lock)
        assert mgr.shutdown(timeout=120.0)
        th.join(10.0)
        assert not th.is_alive()
        assert result["out"].shape == (ST, SH, SW)  # in-flight completed
        assert len(mgr) == 0
        with pytest.raises(CapacityError):
            mgr.create(_video(31, ST, SH, SW), 1, timeout=0.1)
        with pytest.raises(CapacityError):
            mgr.interact(sid, _labels(), 0)

    def test_shutdown_idle_manager(self, nets):
        mgr = _manager(nets, max_sessions=2)
        mgr.create(_video(32, ST, SH, SW), 1)
        assert mgr.shutdown(timeout=5.0) and len(mgr) == 0
        with pytest.raises(CapacityError):
            mgr.create(_video(33, ST, SH, SW), 1, timeout=0.1)


class TestProgress:
    def test_manager_progress_lifecycle(self, nets):
        mgr = _manager(nets)
        sid = mgr.create(_video(40, ST, SH, SW), K)
        p = mgr.progress(sid)
        assert p["round"] == 0 and p["done"] and len(p["frames"]) == 0
        out = mgr.interact(sid, _labels(), 0)
        p = mgr.progress(sid)
        assert p["round"] == 1 and p["done"]
        np.testing.assert_array_equal(p["frames"], np.arange(ST))
        np.testing.assert_array_equal(p["masks"], out)

    def test_masks_nonblocking_while_busy(self, nets):
        mgr = _manager(nets)
        sid = mgr.create(_video(41, ST, SH, SW), K)
        done = mgr.interact(sid, _labels(), 0)
        s = mgr._get(sid)
        s.lock.acquire()  # a round in flight
        try:
            got = {}
            th = threading.Thread(
                target=lambda: got.update(masks=mgr.masks(sid)))
            th.start()
            th.join(10.0)
            assert not th.is_alive(), "masks() blocked on a busy session"
            np.testing.assert_array_equal(got["masks"], done)
        finally:
            s.lock.release()
        np.testing.assert_array_equal(mgr.masks(sid), done)

    def test_progress_polls_during_interact(self, nets):
        """Every mid-round snapshot already equals the final masks at its
        frames: the stream is authoritative per chunk."""
        mgr = _manager(nets)
        sid = mgr.create(_video(4, 12, SH, SW), K)
        snaps, result = [], {}
        th = threading.Thread(target=lambda: result.update(
            out=mgr.interact(sid, _labels(), 0)))
        th.start()
        while th.is_alive():
            snaps.append(mgr.progress(sid))
            time.sleep(0.01)
        th.join()
        final = result["out"]
        for p in snaps:
            if p["round"] == 1 and not p["done"]:
                for i, ti in enumerate(p["frames"]):
                    np.testing.assert_array_equal(p["masks"][i], final[ti])
        p = mgr.progress(sid)
        assert p["done"] and len(p["frames"]) == 12
        np.testing.assert_array_equal(p["masks"], final)


# ------------------------------------------------------------------- (d)

def _request(url, method="GET", arrays=None, data=None):
    """(status, sorted JSON or npz keys, decoded body) of one request."""
    if arrays is not None:
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        data = buf.getvalue()
    req = urllib.request.Request(url, data, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            code, ctype, body = r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        code, ctype, body = e.code, e.headers["Content-Type"], e.read()
    if ctype == "application/json":
        obj = json.loads(body)
        return code, sorted(obj), obj
    with np.load(io.BytesIO(body)) as z:
        obj = {k: z[k] for k in z.files}
    return code, sorted(obj), obj


def _exchange(base):
    """A fixed script of requests; returns {step: (status, keys, body)}."""
    mp4 = os.path.join(REPO, "examples", "example.mp4")
    r = {"healthz": _request(base + "/healthz")}
    r["create"] = _request(base + f"/v1/sessions?num_objects={K}", "POST",
                           {"video": _video(7)})
    sid = r["create"][2]["session_id"]
    one = f"{base}/v1/sessions/{sid}"
    r["interact"] = _request(one + "/interact", "POST",
                             {"labels": _labels(RH, RW), "frame": np.int64(0)})
    r["masks"] = _request(one + "/masks")
    r["progress"] = _request(one + "/progress")
    r["metrics"] = _request(base + "/metrics")
    r["interact_missing_key"] = _request(one + "/interact", "POST",
                                         {"labels": _labels(RH, RW)})
    r["interact_bad_shape"] = _request(
        one + "/interact", "POST",
        {"labels": np.zeros((8, 8), np.uint8), "frame": np.int64(0)})
    r["unknown_route"] = _request(base + "/v1/nothing")
    r["delete"] = _request(one, "DELETE")
    r["masks_unknown"] = _request(one + "/masks")
    r["progress_unknown"] = _request(one + "/progress")
    r["interact_unknown"] = _request(one + "/interact", "POST",
                                     {"labels": _labels(RH, RW),
                                      "frame": np.int64(0)})
    with open(mp4, "rb") as f:
        r["create_mp4"] = _request(
            base + "/v1/sessions?num_objects=1&format=mp4&min_side=64",
            "POST", data=f.read())
    return r


EXPECTED = {"healthz": 200, "create": 200, "interact": 200, "masks": 200,
            "progress": 200, "metrics": 200, "interact_missing_key": 400,
            "interact_bad_shape": 400, "unknown_route": 404, "delete": 200,
            "masks_unknown": 404, "progress_unknown": 404,
            "interact_unknown": 404, "create_mp4": 200}


@pytest.fixture(scope="module")
def exchanges(nets):
    prop, fuse, jnets = nets
    managers = {
        "jax": JSessionManager(*jnets, mem=_jmem(), devices=[jax.devices()[0]]),
        "torch": SessionManager(prop, fuse, mem=_mem(), devices=["cpu"])}
    out = {}
    for name, mgr in managers.items():
        srv = (jmake_server if name == "jax" else make_server)(mgr, port=0)
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        host, port = srv.server_address[:2]
        try:
            out[name] = _exchange(f"http://{host}:{port}")
            sid = out[name]["create_mp4"][2]["session_id"]
            out[name]["create_mp4_masks_shape"] = mgr.masks(sid).shape
        finally:
            srv.shutdown()
            srv.server_close()
    return out


@pytest.mark.parametrize("step", sorted(EXPECTED))
def test_http_status_and_keys_match_jax(exchanges, step):
    code, keys, _ = exchanges["torch"][step]
    jcode, jkeys, _ = exchanges["jax"][step]
    assert (code, keys) == (jcode, jkeys) and code == EXPECTED[step]


def test_http_bodies(exchanges):
    ex = exchanges["torch"]
    masks = ex["interact"][2]["masks"]
    assert masks.shape == (T, RH, RW) and masks.max() <= K
    np.testing.assert_array_equal(ex["masks"][2]["masks"], masks)
    np.testing.assert_array_equal(ex["progress"][2]["masks"], masks)
    assert int(ex["progress"][2]["done"]) == 1
    assert ex["delete"][2] == {"closed": True}
    assert "RuntimeError" in ex["interact_bad_shape"][2]["error"]
    assert ex["metrics"][2]["interactions"] == 1
    # mp4 upload: cv2 decodes the container, the short side becomes 64.
    shape = ex["create_mp4_masks_shape"]
    assert shape == exchanges["jax"]["create_mp4_masks_shape"]
    assert len(shape) == 3 and min(shape[1:]) == 64


# ------------------------------------------------------------------- (e)

def test_serve_entry_point_drains_on_sigterm(nets, tmp_path):
    prop, fuse, _ = nets
    torch.save(prop.state_dict(), tmp_path / "prop.pth")
    torch.save(fuse.state_dict(), tmp_path / "fusion.pth")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "mivos_tpu_torch.serve", "--device", "cpu",
         "--port", "0", "--prop_model", str(tmp_path / "prop.pth"),
         "--fusion_model", str(tmp_path / "fusion.pth"), "--dtype", "float32"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        line = ""
        deadline = time.monotonic() + 120
        while "serving on" not in line:
            left = deadline - time.monotonic()
            assert left > 0, "the server did not start in 120 s"
            if select.select([proc.stdout], [], [], left)[0]:
                line = proc.stdout.readline()
                assert line, f"the server exited early ({proc.wait()})"
        url = line.split()[2]
        code, _, body = _request(url + "/healthz")
        assert code == 200 and body == {"ok": True, "sessions": 0}
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "shutdown complete (drained=True)" in out


# ------------------------------------------------------------------- (f)

def test_no_cpu_fallback(nets, monkeypatch):
    """Without a card and without `devices` the manager and the fleet
    raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SessionManager(nets[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet_map(lambda item, dev: item, [1, 2])


# ---------------------------------------------------- launch counters, fleet

class _PyItemDict(dict):
    """A dict whose item reads run Python code: the interpreter may
    switch threads there, between the read and the write of `+= 1`
    (CPython switches only at calls and jumps, so a plain dict's
    increment would seldom be split, and a missing lock not show)."""

    def __getitem__(self, key):
        return super().__getitem__(key)


def test_launch_counters_exact_under_threads(monkeypatch):
    """8 threads x 10,000 counted launches with the interpreter switching
    threads every microsecond: no increment is lost."""
    monkeypatch.setattr(cmr, "_LAUNCHES", _PyItemDict.fromkeys(cmr._LAUNCHES, 0))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(10_000):
                cmr._launch("readout_merge", 0)

        threads = [threading.Thread(target=hammer) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60.0)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    counts = cmr.launch_counts()
    assert counts["readout_merge"] == 80_000
    assert sum(counts.values()) == 80_000


def test_fleet_runs_every_video_on_its_lane(nets):
    """propagate_videos on two CPU lanes equals a direct session per
    video; fleet_map keeps the order and reports a failed item."""
    prop, fuse, _ = nets
    videos = [_video(s, ST, SH, SW) for s in (5, 6, 7)]
    masks = [labels_to_probs(_labels(), K).numpy() for _ in videos]
    got = propagate_videos(prop, fuse, videos, masks, mem=_mem(),
                           devices=["cpu", "cpu"])
    for video, mask, out in zip(videos, masks, got):
        core = InferenceCore(prop, fuse, video, K, mem=_mem(), device="cpu")
        np.testing.assert_array_equal(out, core.interact(mask, 0))
    assert fleet_map(lambda i, dev: (i, dev.type), [3, 1, 2],
                     devices=["cpu", "cpu"]) == [(3, "cpu"), (1, "cpu"),
                                                 (2, "cpu")]

    def fail(i, dev):
        raise ValueError(i)

    with pytest.raises(RuntimeError, match="fleet item"):
        fleet_map(fail, [0, 1], devices=["cpu"])
