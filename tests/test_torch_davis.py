"""The PyTorch port's DAVIS interactive protocol against the JAX package.

The JAX modules on this path use cv2; the port does not, so that it
runs where neither cv2 nor PIL is installed. Each replacement is held
to the cv2 call it replaces, the metrics and the robot to the JAX ones
on fixed label maps, and the DAVIS processor to the JAX one in lockstep: the same
robot scribbles go to both every round, since with random weights one
flipped label changes the next scribble and the two loops would part.
All on the CPU; the port's processor reads with its exact top-k path,
the JAX one with `xla_exact`.
"""
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage

from mivos_tpu.checkpoint.convert import (convert_fusion_net, convert_prop_net,
                                          convert_s2m)
from mivos_tpu.config import MemoryConfig as JMemoryConfig
from mivos_tpu.core.davis_processor import DAVISProcessor as JDAVISProcessor
from mivos_tpu.eval import davis_contract
from mivos_tpu.eval import davis_metrics as jm
from mivos_tpu.eval import robot as jrobot
from mivos_tpu.interactive.scribbles import scribbles2mask as j_scribbles2mask
from mivos_tpu.models.fusion import FusionNet as JFusionNet
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.models.s2m import S2MNetwork as JS2MNetwork
from mivos_tpu_torch import eval_interactive_davis as cli
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.core.davis_processor import DAVISProcessor
from mivos_tpu_torch.eval import davis_metrics as tm
from mivos_tpu_torch.eval import robot as trobot
from mivos_tpu_torch.eval.davis_interactive import (run_davis_interactive,
                                                    run_local_interactive)
from mivos_tpu_torch.interactive.scribbles import (draw_line, is_empty,
                                                   scribbles2mask)
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.utils.palette import save_indexed_png

REPO = Path(__file__).resolve().parents[1]
EXACT = 1e-9   # metrics: float64 from the same integer counts


def _random_scribbles(seed, t, k):
    """Per-frame polylines in [0,1]^2, with single-point paths and
    points that land on exact .5 pixel positions (np.round ties)."""
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(t):
        lines = []
        for _ in range(rng.randint(0, 4)):
            path = rng.rand(rng.randint(1, 7), 2)
            if rng.rand() < 0.5:
                path[0] = [0.5, 0.25]
            lines.append({"path": path.tolist(),
                          "object_id": int(rng.randint(0, k + 1))})
        frames.append(lines)
    return {"scribbles": frames}


def _blobs(rng, t, h, w, k, shift=0):
    """(t, h, w) labels: k ellipses of distinct random sizes."""
    yy, xx = np.mgrid[0:h, 0:w]
    lab = np.zeros((t, h, w), np.int32)
    centre = rng.rand(k, 2) * [h, w]
    radii = rng.uniform(0.1, 0.35, (k, 2)) * [h, w]
    for ti in range(t):
        for o in range(k):
            cy, cx = centre[o] + ti * shift
            inside = ((yy - cy) / radii[o, 0]) ** 2 + ((xx - cx) / radii[o, 1]) ** 2 <= 1
            lab[ti][inside] = o + 1
    return lab


# ---------------------------------------------------------------- cv2

@pytest.mark.parametrize("seed,hw", [(0, (45, 62)), (1, (45, 62)),
                                     (2, (480, 854))])
def test_scribbles2mask_matches_jax(seed, hw):
    scr = _random_scribbles(seed, 4, 3)
    np.testing.assert_array_equal(scribbles2mask(scr, hw),
                                  j_scribbles2mask(scr, hw))


def test_draw_line_matches_cv2_line():
    rng = np.random.RandomState(0)
    for n in range(400):
        h, w = rng.randint(1, 70, 2)
        a = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        b = (int(rng.randint(0, w)), int(rng.randint(0, h)))
        if n % 4 == 0:   # steep and near-vertical segments
            b = (int(np.clip(a[0] + rng.randint(-3, 4), 0, w - 1)), b[1])
        ref = np.full((h, w), -1, np.int32)
        cv2.line(ref, a, b, 5, thickness=1)
        out = np.full((h, w), -1, np.int32)
        draw_line(out, a, b, 5)
        np.testing.assert_array_equal(out, ref, err_msg=f"{a} -> {b}")


def _random_masks(seed, n=40):
    rng = np.random.RandomState(seed)
    for i in range(n):
        h, w = rng.randint(3, 90, 2)
        m = (rng.rand(h, w) > rng.uniform(0.02, 0.6)).astype(np.uint8)
        if i % 2:
            m = cv2.dilate(m, np.ones((5, 5), np.uint8))
        yield m


@pytest.mark.parametrize("seed", [0, 1])
def test_erode3x3_matches_cv2(seed):
    for m in _random_masks(seed):
        np.testing.assert_array_equal(
            trobot.erode3x3(m), cv2.erode(m, np.ones((3, 3), np.uint8)))


@pytest.mark.parametrize("seed", [0, 1])
def test_chamfer_distance_matches_cv2(seed):
    """OpenCV's IPP build sums a few pixels' steps in another order
    (0.04% of pixels here), one float32 ulp apart; every other pixel,
    and every unreachable one (FLT_MAX), is equal."""
    n_diff = n_px = 0
    for m in _random_masks(seed):
        ref = cv2.distanceTransform(m, cv2.DIST_L2, 3)
        out = trobot.chamfer_distance(m)
        assert out.dtype == np.float32
        np.testing.assert_array_equal(out >= 3e38, ref >= 3e38)
        np.testing.assert_array_max_ulp(out, ref, maxulp=1)
        n_diff += int((out != ref).sum())
        n_px += m.size
    assert n_diff <= 1e-3 * n_px, (n_diff, n_px)


def test_components_match_cv2_on_tie_free_fixture():
    """scipy.ndimage.label finds cv2's 8-connected components, numbered
    in another order. Blobs here have distinct areas and some join only
    diagonally; with two largest blobs of equal area the two libraries
    could pick different ones, which is why fixtures avoid ties."""
    rng = np.random.RandomState(3)
    err = np.zeros((60, 90), np.uint8)
    for i, (y, x) in enumerate([(2, 2), (20, 30), (40, 60), (5, 70), (45, 5)]):
        err[y:y + 3 + i, x:x + 4 + 2 * i] = 1
    err[25 + 3 + 1, 30 + 4 + 2] = 1        # joins blob 1 diagonally
    err |= (rng.rand(60, 90) > 0.97).astype(np.uint8)
    n, lab_cv, stats, _ = cv2.connectedComponentsWithStats(err, connectivity=8)
    lab_sp, n_sp = ndimage.label(err, structure=np.ones((3, 3), int))
    assert n_sp == n - 1
    for c in range(1, n):
        ids = np.unique(lab_sp[lab_cv == c])
        assert len(ids) == 1 and ((lab_sp == ids[0]) == (lab_cv == c)).all()
    areas = np.bincount(lab_sp.ravel())[1:]
    assert (areas == areas.max()).sum() == 1
    largest_cv = 1 + int(np.argmax(stats[1:, cv2.CC_STAT_AREA]))
    assert ((lab_sp == 1 + int(np.argmax(areas))) == (lab_cv == largest_cv)).all()


@pytest.mark.parametrize("r", [1, 2, 3, 5, 8, 13, 20])
def test_ellipse_disc_matches_cv2(r):
    ref = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (2 * r + 1, 2 * r + 1))
    np.testing.assert_array_equal(tm.ellipse_disc(r), ref)
    if r == 8:   # the F-measure disc at 480p
        assert tm.boundary_radius(480, 854) == 8 and ref.sum() == 213


# ---------------------------------------------------------------- metrics

@pytest.mark.parametrize("t,h,w,k", [(4, 40, 60, 3), (2, 480, 854, 2)])
def test_jf_matches_jax(t, h, w, k):
    rng = np.random.RandomState(t)
    gt = _blobs(rng, t, h, w, k, shift=2)
    pred = _blobs(rng, t, h, w, k, shift=-1)
    pred[0][pred[0] == 1] = 0            # an object missing from a frame
    gt[-1][gt[-1] == 2] = 0
    ref_j, ref_f = jm.batched_jf(pred, gt, k)
    j, f = tm.batched_jf(pred, gt, k)
    assert j.shape == f.shape == (k, t)
    np.testing.assert_allclose(j, ref_j, atol=EXACT, rtol=0)
    np.testing.assert_allclose(f, ref_f, atol=EXACT, rtol=0)
    assert 0.0 < f.mean() < 1.0
    assert abs(tm.sequence_jf(pred, gt, k) - jm.sequence_jf(pred, gt, k)) <= EXACT
    for ti in range(t):
        g, p = gt[ti] == 1, pred[ti] == 1
        assert tm.db_eval_iou(g, p) == jm.db_eval_iou(g, p)
        for th in (0.008, 2.0):
            assert abs(tm.db_eval_boundary(g, p, th)
                       - jm.db_eval_boundary(g, p, th)) <= EXACT


def test_db_eval_boundary_edge_cases_match_jax():
    a = np.zeros((30, 40), bool)
    a[5:20, 5:25] = True
    empty = np.zeros_like(a)
    for g, p in ((a, a), (a, empty), (empty, a), (empty, empty),
                 (a, np.roll(a, 12, axis=1))):
        assert tm.db_eval_boundary(g, p) == jm.db_eval_boundary(g, p)
        assert tm.db_eval_iou(g, p) == jm.db_eval_iou(g, p)


def test_summarize_session_matches_jax():
    rng = np.random.RandomState(4)
    records = {f"s{i}": sorted([(float(t), float(v)) for t, v in
                                zip(rng.uniform(0, 240, 8), rng.rand(8))])
               for i in range(3)}
    ref = jm.summarize_session(records, max_time=240.0)
    out = tm.summarize_session(records, max_time=240.0)
    assert out.keys() == ref.keys()
    for key in ("auc", "metric_at_60s"):
        assert abs(out[key] - ref[key]) <= EXACT
    np.testing.assert_allclose(out["curve"]["metric"], ref["curve"]["metric"],
                               atol=EXACT, rtol=0)


# ---------------------------------------------------------------- robot

def _robot_cases():
    rng = np.random.RandomState(7)
    cases = {}
    gt = _blobs(rng, 3, 48, 64, 2, shift=1)
    cases["round0"] = (np.zeros_like(gt), gt, 2, None)
    gt = _blobs(rng, 4, 60, 80, 3, shift=2)
    pred = _blobs(rng, 4, 60, 80, 3, shift=-2)
    cases["errors"] = (pred, gt, 3, None)
    cases["candidates"] = (pred, gt, 3, [1, 3])
    sq = np.zeros((2, 40, 50), np.int32)
    sq[:, 10:22, 15:27] = 1             # thins to a point: chamfer fallback
    cases["square"] = (np.zeros_like(sq), sq, 1, None)
    edge = np.zeros((2, 40, 50), np.int32)
    edge[:, :15, 30:] = 1               # touches the top and right border
    edge[:, 25:, :12] = 2
    edge[1, 1:3, 1:3] = 2               # below min_blob_px
    cases["border"] = (edge * (rng.rand(*edge.shape) > 0.3), edge, 2, None)
    gt = _blobs(rng, 2, 480, 854, 3, shift=9)
    cases["480p"] = (np.roll(gt, 20, axis=2), gt, 3, None)
    return cases


ROBOT_CASES = _robot_cases()


@pytest.mark.parametrize("name", list(ROBOT_CASES))
def test_robot_matches_jax(name):
    pred, gt, k, cand = ROBOT_CASES[name]
    ref = jrobot.InteractiveScribblesRobot().interact(pred, gt, k, cand, "s")
    out = trobot.InteractiveScribblesRobot().interact(pred, gt, k, cand, "s")
    assert out == ref
    assert not is_empty(out)
    assert davis_contract.check_scribbles(out, gt.shape[0], k) == []
    if name == "square":
        blob = trobot.erode3x3((gt[0] == 1).astype(np.uint8))
        skel = trobot._longest_skeleton_path(trobot.zhang_suen_thin(blob))
        assert len(skel) < 4   # the distance-transform ridge was used


def test_robot_helpers_match_jax():
    blob = (_blobs(np.random.RandomState(2), 1, 50, 70, 1)[0] == 1)
    np.testing.assert_array_equal(trobot.zhang_suen_thin(blob),
                                  jrobot.zhang_suen_thin(blob))
    skel = trobot.zhang_suen_thin(blob)
    np.testing.assert_array_equal(trobot._longest_skeleton_path(skel),
                                  jrobot._longest_skeleton_path(skel))


@pytest.mark.parametrize("only_last", [True, False])
def test_local_session_matches_jax(only_last):
    """Both sessions get the same predictions each round: equal
    scribbles (this round's, or all rounds' merged per frame), and J&F
    records equal to 1e-9."""
    rng = np.random.RandomState(8)
    seqs = {"a": (_blobs(rng, 3, 48, 64, 2, shift=2), 2),
            "b": (_blobs(rng, 4, 40, 56, 1, shift=1), 1)}
    preds = {n: [np.roll(gt, r, axis=2) * (rng.rand(*gt.shape) > 0.1 * r)
                 for r in range(3)] for n, (gt, _) in seqs.items()}
    out = {}
    for tag, mod in (("jax", jrobot), ("port", trobot)):
        sess = mod.LocalInteractiveSession(seqs, max_nb_interactions=3,
                                           max_time=1e6)
        got = []
        with sess:
            while sess.next():
                name, scr, new = sess.get_scribbles(only_last)
                rnd = len(sess.records[name])
                got.append((name, scr, new))
                sess.submit_masks(preds[name][rnd],
                                  [rnd] if rnd % 2 else None)
        out[tag] = (got, sess.get_report())
    assert out["port"][0] == out["jax"][0]
    if not only_last:   # each round carries the sequence's earlier lines
        got, grew = out["port"][0], False
        for (_, prev, _), (_, cur, new) in zip(got, got[1:]):
            if new:
                continue
            for f0, f1 in zip(prev["scribbles"], cur["scribbles"]):
                assert f1[:len(f0)] == f0
            grew |= sum(map(len, cur["scribbles"])) > sum(map(len, prev["scribbles"]))
        assert grew
    for name in seqs:
        jf = [v for _, v in out["port"][1][name]]
        ref = [v for _, v in out["jax"][1][name]]
        np.testing.assert_allclose(jf, ref, atol=EXACT, rtol=0)


# ---------------------------------------------------------------- processor

T, RH, RW, K = 6, 45, 62, 2
TOP_K, MEM_FREQ, ROUNDS = 10, 2, 8
PROB_ATOL, TIE_ATOL, MARGIN = 1e-4, 1e-3, 1e-3


def _sd(module):
    return {k: v.numpy() for k, v in module.state_dict().items()}


def _nets(seed=0, top_k=TOP_K, read_backend="exact"):
    gen = torch.Generator().manual_seed(seed)
    return (init_params(PropagationNetwork(top_k=top_k,
                                           read_backend=read_backend), gen),
            init_params(FusionNet(), gen), init_params(S2MNetwork(), gen))


def _video(seed, t, h, w, k):
    rng = np.random.RandomState(seed)
    gt = _blobs(rng, t, h, w, k, shift=1.5)
    colours = rng.rand(k + 1, 3)
    images = (colours[gt] + 0.1 * rng.randn(t, h, w, 3)).astype(np.float32)
    return images, gt


@pytest.fixture(scope="module")
def lockstep():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    prop, fuse, s2m = _nets()
    images, gt = _video(1, T, RH, RW, K)
    jproc = JDAVISProcessor(
        JPropagation(top_k=TOP_K, read_backend="xla_exact"),
        convert_prop_net(_sd(prop)), JFusionNet(),
        convert_fusion_net(_sd(fuse)), JS2MNetwork(), convert_s2m(_sd(s2m)),
        images, K, mem=JMemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ))
    proc = DAVISProcessor(prop, fuse, s2m, images, K,
                          mem=MemoryConfig(top_k=TOP_K, mem_freq=MEM_FREQ))
    calls = []
    for meth in ("interact", "update_mask_only"):
        orig = getattr(proc.processor, meth)

        def counted(mask, idx, _orig=orig, _meth=meth):
            calls.append(_meth)
            return _orig(mask, idx)
        setattr(proc.processor, meth, counted)
    robot = trobot.InteractiveScribblesRobot()
    jpred, cand, rounds, hard = np.zeros_like(gt), None, [], set()
    with torch.no_grad():
        for _ in range(ROUNDS):
            scr = robot.interact(jpred, gt, K, candidates=cand)
            assert not is_empty(scr)
            jlab, jnext, jidx = jproc.interact(scr)
            lab, nxt, idx = proc.interact(scr)
            jprob = np.stack([np.asarray(jproc.processor.get_prob(t))[..., 0]
                              for t in range(T)])
            prob = np.stack([proc.processor.get_prob(t)[:, 0].numpy()
                             for t in range(T)])
            if jnext is None:   # the pass overwrote frames up to the
                inter = jproc.processor.interacted   # nearest interactions
                back = max([t for t in inter if t < jidx] + [-1])
                front = min([t for t in inter if t > jidx] + [T])
                hard = {t for t in hard if not back < t < front}
            hard.add(jidx)
            rounds.append((np.array(jlab), jprob, lab.copy(), prob,
                           (jnext, jidx), (nxt, idx), sorted(hard)))
            jpred, cand = np.array(jlab), jnext
    return proc, rounds, calls


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_lockstep_probabilities_match_jax(lockstep, rnd):
    """Frames that hold an S2M mask hold softmax(1000 * logits), which
    is 250-Lipschitz in the S2M logits. Where it is not saturated (two
    classes near-tied: a second class above 1e-3), the frameworks' ~1e-6
    logit rounding (test_torch_s2m) grows to ~1e-4, so those pixels are
    held to TIE_ATOL; every other pixel to PROB_ATOL."""
    _, rounds, _ = lockstep
    _, jprob, _, prob, _, _, hard = rounds[rnd]
    assert prob.shape == jprob.shape == (T, K + 1, 48, 64)
    assert np.isfinite(prob).all()
    held = np.ones((T, 48, 64), bool)
    for t in hard:
        held[t] = np.sort(jprob[t], axis=0)[-2] < 1e-3
    assert held.mean() > 0.85, held.mean()
    out, ref = prob.transpose(0, 2, 3, 1), jprob.transpose(0, 2, 3, 1)
    np.testing.assert_allclose(out[held], ref[held], atol=PROB_ATOL, rtol=0)
    np.testing.assert_allclose(out[~held], ref[~held], atol=TIE_ATOL, rtol=0)


@pytest.mark.parametrize("rnd", range(ROUNDS))
def test_lockstep_labels_match_jax_where_decided(lockstep, rnd):
    proc, rounds, _ = lockstep
    jlab, jprob, lab, _, jnext, nxt, _ = rounds[rnd]
    assert nxt == jnext
    assert lab.shape == (T, RH, RW) and lab.dtype == np.uint8
    top2 = np.sort(jprob, axis=1)[:, -2:]
    lw, uw, lh, uh = proc.pad
    decided = (top2[:, 1] - top2[:, 0])[:, lh:48 - uh, lw:64 - uw] > MARGIN
    touched = [t for t in range(T) if jprob[t, 1:].max() > 0]   # else default
    assert decided[touched].mean() > 0.5, decided[touched].mean()
    np.testing.assert_array_equal(lab[decided], jlab[decided])


def test_lockstep_propagates_on_rounds_2_5_7(lockstep):
    _, rounds, calls = lockstep
    want = ["interact" if r in (2, 5, 7) else "update_mask_only"
            for r in range(ROUNDS)]
    assert calls == want
    assert [r[5][0] is None for r in rounds] == [c == "interact" for c in want]


# ---------------------------------------------------------------- loops

def test_run_local_interactive_meets_the_contract(monkeypatch):
    seen = []
    orig = trobot.LocalInteractiveSession.get_scribbles

    def recording(self, only_last=True):
        out = orig(self, only_last)
        seen.append(out)
        return out
    monkeypatch.setattr(trobot.LocalInteractiveSession, "get_scribbles",
                        recording)
    prop, fuse, s2m = _nets(seed=2)
    seqs = {}
    for i, k in enumerate((2, 1)):
        images, gt = _video(10 + i, 4, 48, 64, k)
        seqs[f"v{i}"] = (images, gt, k)
    summary = run_local_interactive(prop, fuse, s2m, seqs,
                                    max_nb_interactions=4,
                                    max_time_per_interaction=1000,
                                    mem=MemoryConfig(top_k=TOP_K))
    assert davis_contract.check_session_methods(
        trobot.LocalInteractiveSession) == []
    assert davis_contract.check_summary(summary) == []
    assert len(seen) == 8
    for res in seen:
        assert davis_contract.check_get_scribbles_result(res) == []
        k = seqs[res[0]][2]
        assert davis_contract.check_scribbles(res[1], 4, k) == []
    assert 0.0 <= summary["auc"] <= 1.0
    assert [len(v) for v in summary["records"].values()] == [4, 4]
    rounds = summary["rounds"]
    assert [r["propagated"] for r in rounds if not r["skipped"]][:3] == [
        False, False, True]
    assert all(r["interact_s"] >= 0 and r["robot_s"] >= 0 for r in rounds)


def _write_davis(root, videos, t, h, w, seed=0):
    rng = np.random.RandomState(seed)
    for v in videos:
        for sub in ("JPEGImages/480p", "Annotations/480p"):
            os.makedirs(root / sub / v, exist_ok=True)
        lab = np.zeros((h, w), np.uint8)
        lab[8:24, 8:28] = 1
        lab[28:44, 36:60] = 2
        for f in range(t):
            Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
                root / "JPEGImages/480p" / v / f"{f:05d}.jpg")
            save_indexed_png(str(root / "Annotations/480p" / v / f"{f:05d}.png"),
                             np.roll(lab, f, axis=1))
    os.makedirs(root / "ImageSets/2017", exist_ok=True)
    (root / "ImageSets/2017/val.txt").write_text("".join(v + "\n" for v in videos))


def test_davis_dataset_matches_jax(tmp_path):
    from mivos_tpu.data.video_datasets import DAVISTestDataset as JDataset
    from mivos_tpu_torch.data.video_datasets import DAVISTestDataset
    _write_davis(tmp_path, ["seq_a", "seq_b"], 3, 48, 64)
    ref, out = JDataset(str(tmp_path)), DAVISTestDataset(str(tmp_path))
    assert out.videos == ref.videos == ["seq_a", "seq_b"]
    assert len(out) == len(ref) == 2
    for i in range(2):
        lab, ids = out.load_labels(i)
        jlab, jids = ref.load_labels(i)
        np.testing.assert_array_equal(lab, jlab)
        assert ids == jids == [1, 2]
        d, jd = out[i], ref[i]
        assert d["info"] == jd["info"]
        for key in ("rgb", "gt"):
            assert d[key].shape == jd[key].shape and d[key].dtype == np.float32
            np.testing.assert_array_equal(d[key], np.asarray(jd[key]))


def test_run_davis_interactive_with_stub_session(tmp_path, monkeypatch):
    from test_davis_interactive_loop import H, StubSession, T as ST, W
    import types
    pkg = types.ModuleType("davisinteractive")
    sess_pkg = types.ModuleType("davisinteractive.session")
    sess_mod = types.ModuleType("davisinteractive.session.session")
    sess_mod.DavisInteractiveSession = StubSession
    sess_pkg.session, pkg.session = sess_mod, sess_pkg
    monkeypatch.setitem(sys.modules, "davisinteractive", pkg)
    monkeypatch.setitem(sys.modules, "davisinteractive.session", sess_pkg)
    monkeypatch.setitem(sys.modules, "davisinteractive.session.session",
                        sess_mod)
    assert davis_contract.check_session_methods(StubSession) == []
    assert davis_contract.check_session_ctor(StubSession) == []
    _write_davis(tmp_path / "davis" / "trainval", ["seq_a", "seq_b"], ST, H, W)
    prop, fuse, s2m = _nets(seed=3)
    summary = run_davis_interactive(
        prop, fuse, s2m, davis_root=str(tmp_path / "davis"),
        out_path=str(tmp_path / "out"), save_mask=True,
        mem=MemoryConfig(top_k=TOP_K))
    assert summary["num_interactions"] == 4
    assert (tmp_path / "out" / "summary.json").exists()
    saved = sorted((tmp_path / "out").rglob("*.png"))
    assert len(saved) == 2 * ST     # the last masks of each sequence
    lab = np.asarray(Image.open(saved[0]))
    assert lab.shape == (H, W) and lab.max() <= 2


def test_cli_local_robot_on_disk(tmp_path):
    _write_davis(tmp_path / "davis" / "trainval", ["vid"], 3, 48, 64)
    prop, fuse, s2m = _nets(seed=4)
    paths = {}
    for name, net in (("prop", prop), ("fusion", fuse), ("s2m", s2m)):
        sd = dict(net.state_dict())
        for key in list(sd):   # reference checkpoints carry BN counters
            if key.endswith("running_var"):
                sd[key.replace("running_var", "num_batches_tracked")] = torch.tensor(0)
        paths[name] = tmp_path / f"{name}.pth"
        torch.save(sd, paths[name])
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "mivos_tpu_torch.eval_interactive_davis",
           "--local_robot", "--device", "cpu", "--dtype", "float32",
           "--top_k", str(TOP_K), "--davis", str(tmp_path / "davis"),
           "--output", str(out), "--save_mask",
           "--prop_model", str(paths["prop"]),
           "--fusion_model", str(paths["fusion"]),
           "--s2m_model", str(paths["s2m"])]
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    assert "'auc'" in r.stdout
    assert (out / "summary.json").exists()
    rounds = [d for d in out.iterdir() if d.is_dir()]
    assert len(rounds) >= 1
    assert all(len(list((d / "vid").glob("*.png"))) == 3 for d in rounds)


def test_cli_refuses_cuda_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--output", str(tmp_path), "--device", "cuda"])
