"""The port's headless GUI session (interactive/gui_session.py) on the CPU.

The cases of tests/test_gui_session.py against the port (T=4, 48x64,
K=2), then one drive of the same strokes through the JAX GuiSession and
the port's on padded 45x62 frames with the same weights: drawn maps and
crop/stitch equal, S2M within tests/test_torch_s2m.py's tolerance,
propagated labels equal where JAX decides (tests/test_torch_session.py's
margin). And the thick-line rasterizer against cv2.line.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mivos_tpu.checkpoint.convert import (convert_fusion_net, convert_prop_net,
                                          convert_s2m)
from mivos_tpu.config import MemoryConfig as JMemoryConfig
from mivos_tpu.data.transforms import im_denormalize as j_im_denormalize
from mivos_tpu.interactive.gui_session import GuiSession as JGuiSession
from mivos_tpu.interactive.s2m_controller import S2MController as JS2MController
from mivos_tpu.models.fusion import FusionNet as JFusionNet
from mivos_tpu.models.propagation import PropagationNetwork as JPropagation
from mivos_tpu.models.s2m import S2MNetwork as JS2MNetwork
from mivos_tpu.ops.aggregate import aggregate_sbg as j_aggregate_sbg
from mivos_tpu.utils.palette import overlay_davis as j_overlay_davis
from mivos_tpu.utils.tensor import labels_to_probs as j_labels_to_probs
from mivos_tpu_torch.data.transforms import im_denormalize
from mivos_tpu_torch.config import MemoryConfig
from mivos_tpu_torch.interactive.gui_session import GuiSession
from mivos_tpu_torch.interactive.interaction import (CropperInteraction,
                                                     FreeInteraction,
                                                     LocalInteraction,
                                                     ScribbleInteraction)
from mivos_tpu_torch.interactive.s2m_controller import S2MController
from mivos_tpu_torch.interactive.scribbles import draw_line
from mivos_tpu_torch.models.fusion import FusionNet
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork
from mivos_tpu_torch.ops.aggregate import aggregate_sbg
from mivos_tpu_torch.utils.palette import overlay_davis
from mivos_tpu_torch.utils.tensor import labels_to_probs
from mivos_tpu_torch.utils.timer import Timer

T, H, W, K = 4, 48, 64, 2
PT, PH, PW = 6, 45, 62       # parity drive: padded to 48x64
PROB_ATOL = 1e-4             # tests/test_torch_session.py, test_torch_s2m.py
MARGIN = 1e-3                # labels must agree where JAX decides by more


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


def _np(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def port_nets():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    return (init_params(PropagationNetwork(top_k=10, read_backend="exact"), gen),
            init_params(FusionNet(), gen), init_params(S2MNetwork(), gen))


@pytest.fixture(scope="module")
def session(port_nets):
    prop, fuse, s2m = port_nets
    images = np.random.RandomState(0).rand(T, H, W, 3).astype(np.float32)
    return GuiSession(prop, fuse, S2MController(s2m, K, device="cpu"), None,
                      images, K, mem=MemoryConfig(top_k=10), device="cpu")


class TestFreeInteraction:
    def test_paint_predict_undo(self, session):
        session.goto(0)
        assert isinstance(session.start_interaction("free"), FreeInteraction)
        session.push_point(5, 5, 1)
        session.push_point(30, 30, 1)
        session.end_path()
        mask = session.predict().copy()   # predict returns the live frame
        assert mask.shape == (H, W) and (mask == 1).any()
        session.push_point(5, 5, 0)   # erase with object 0
        session.push_point(30, 30, 0)
        session.end_path()
        erased = session.predict()
        assert (erased == 1).sum() < (mask == 1).sum()
        assert session.undo()         # undo restores the painted map
        np.testing.assert_array_equal(session.current_mask(), mask)

    def test_brush_size_respected(self, session):
        session.goto(1)
        session.brush_size = 11
        session.start_interaction("free")
        session.push_point(10, 24, 1)
        session.push_point(50, 24, 1)
        session.end_path()
        mask = session.predict()
        # cv2's 11-pixel line: rows 19-29, round caps of radius 6 (18-30).
        rows = np.where((mask == 1).any(axis=1))[0]
        assert rows.min() == 18 and rows.max() == 30
        session.brush_size = 3


class TestScribbleInteraction:
    def test_s2m_scribble_produces_distribution(self, session):
        session.goto(2)
        assert isinstance(session.start_interaction("scribble"),
                          ScribbleInteraction)
        session.push_point(8, 8, 1)
        session.push_point(40, 30, 1)
        session.end_path()
        mask = session.predict()
        assert mask.shape == (H, W)
        assert set(np.unique(mask)) <= {0, 1, 2}
        prob = session.interacted_mask
        assert tuple(prob.shape) == (K + 1, H, W, 1)
        np.testing.assert_allclose(prob.sum(0).numpy(), 1.0, atol=1e-5)


class TestLocalControl:
    def test_crop_stitch_roundtrip(self, session):
        session.goto(3)
        session.start_interaction("free")
        session.push_point(5, 5, 1)
        session.push_point(20, 20, 1)
        session.end_path()
        before = session.predict().copy()
        session.enter_local((16, 47, 8, 39))  # lx, ux, ly, uy
        assert session.in_local_mode
        assert isinstance(session.local_interactions["interact"][0],
                          CropperInteraction)
        assert isinstance(session.start_interaction("free"), FreeInteraction)
        session.push_point(4, 10, 2)   # local coordinates
        session.push_point(25, 25, 2)
        session.end_path()
        session.predict()
        after = session.finish_local()
        assert not session.in_local_mode
        assert isinstance(session.this_frame_interactions[-1],
                          LocalInteraction)
        assert (after == 2).any()
        outside = (slice(0, 7), slice(0, 14))   # far outside the box
        np.testing.assert_array_equal(after[outside], before[outside])


class TestSessionMisc:
    def test_compose_frame_modes(self, session):
        session.goto(0)
        frames = {}
        for mode in ("davis", "fade", "light"):
            session.viz_mode = mode
            frames[mode] = session.compose_frame()
            assert frames[mode].shape == (H, W, 3)
            assert frames[mode].dtype == np.uint8
        assert not np.array_equal(frames["davis"], frames["fade"])
        session.viz_mode = "davis"

    def test_object_hotkey_bounds(self, session):
        session.set_object(2)
        assert session.current_object == 2
        with pytest.raises(AssertionError):
            session.set_object(K + 1)
        session.set_object(1)

    def test_save_masks_and_overlays(self, session, tmp_path):
        from PIL import Image

        session.save_masks(str(tmp_path / "m"))
        names = sorted(os.listdir(tmp_path / "m"))
        assert len(names) == T
        for ti, name in enumerate(names):
            np.testing.assert_array_equal(
                np.asarray(Image.open(tmp_path / "m" / name)),
                session.processor.np_masks[ti])
        session.save_overlays(str(tmp_path / "o"))
        assert len(os.listdir(tmp_path / "o")) == T

    def test_propagation_after_interaction(self, session):
        session.goto(0)
        session.start_interaction("free")
        session.push_point(5, 5, 1)
        session.push_point(30, 30, 1)
        session.end_path()
        session.predict()
        totals, steps = [], []
        masks = session.run_propagation(total_cb=totals.append,
                                        step_cb=lambda: steps.append(1))
        assert masks.shape == (T, H, W)
        assert totals == [T - 1] and len(steps) == T - 1
        assert session.interacted_mask is None


class TestClickInteractionInSession:
    def test_click_flow_with_fake_controller(self, session):
        """Click mode routes through the f-BRS controller contract:
        interact(image, x, y, positive) -> (nh, nw) object map; undo()
        -> the previous map (reference interaction.py:265-335)."""

        class FakeFBRS:
            def __init__(self):
                self.history = []

            def unanchor(self):
                pass

            def interact(self, image, x, y, positive):
                m = np.zeros((image.shape[0], image.shape[1]), np.float32)
                y0, x0 = int(y), int(x)
                m[max(0, y0 - 5):y0 + 5, max(0, x0 - 5):x0 + 5] = \
                    1.0 if positive else 0.0
                self.history.append(m)
                return m

            def undo(self):
                self.history.pop()
                return self.history[-1] if self.history else None

        session.goto(0)
        session.fbrs_controller = FakeFBRS()
        session.current_object = 1
        it = session.start_interaction("click")
        session.push_point(30, 20, False)   # positive click (neg=False)
        m1 = session.predict().copy()
        assert (m1[15:25, 25:35] == 1).all()
        session.push_point(50, 40, False)
        m2 = session.predict().copy()
        assert (m2[35:45, 45:55] == 1).all() and not (m2[15:25, 25:35] == 1).all()
        assert session.undo()
        np.testing.assert_array_equal(session.current_mask(), m1)
        assert it.can_undo() is False   # one click left in the history
        session.fbrs_controller = None


class TestMinimapZoom:
    def test_zoom_limits_and_steps(self, session):
        session.zoom_pixels = 150
        assert session.zoom_in() == 125
        for _ in range(10):
            session.zoom_in()
        assert session.zoom_pixels == 50
        for _ in range(20):
            session.zoom_out()
        assert session.zoom_pixels == 300

    def test_zoom_rect_clamped_inside_frame(self, session):
        session.zoom_pixels = 40
        session.set_cursor_pos(-10, -10)
        y0, y1, x0, x1 = session.zoom_rect()
        assert (y0, x0) == (0, 0) and (y1 - y0, x1 - x0) == (40, 40)
        session.set_cursor_pos(10 ** 4, 10 ** 4)
        y0, y1, x0, x1 = session.zoom_rect()
        assert y1 == session.height and x1 == session.width
        assert (y1 - y0, x1 - x0) == (40, 40)
        session.set_cursor_pos(32, 24)
        assert session.zoom_rect() == (4, 44, 12, 52)

    def test_minimap_patch_is_zoom_window_of_viz(self, session):
        session.zoom_pixels = 40
        session.set_cursor_pos(40, 20)
        viz = session.compose_frame()
        y0, y1, x0, x1 = session.zoom_rect()
        np.testing.assert_array_equal(session.minimap_patch(viz),
                                      viz[y0:y1, x0:x1])
        session.zoom_pixels = 300   # larger than the frame: all of it
        assert session.minimap_patch(viz).shape[:2] == (H, W)

    def test_minimap_frozen_in_local_mode(self, session):
        session.goto(0)
        session.zoom_pixels = 40
        snapshot_before = session.compose_frame()
        session.enter_local((10, 40, 10, 40))
        try:
            np.testing.assert_array_equal(session.minimap_patch(),
                                          snapshot_before)
            assert session.compose_local_frame().shape == (31, 31, 3)
        finally:
            session.finish_local()
        assert session._minimap_local_snapshot is None
        assert session.minimap_patch().shape[:2] == (40, 40)


# ------------------------------------------------------- parity with JAX

def _stroke(s, mode, points, arg, brush=None):
    if brush is not None:
        s.brush_size = brush
    it = s.start_interaction(mode)
    for x, y in points:
        s.push_point(x, y, arg)
    s.end_path()
    return it


def _drive(s):
    """The same strokes through either package's GuiSession; returns
    numpy snapshots."""
    out = {}
    s.goto(4)   # S2M on a frame no propagation has reached
    it = _stroke(s, "scribble", [(5, 5), (25, 18), (30, 35)], 1)
    _stroke(s, "scribble", [(50, 5), (55, 40)], 2)
    s.predict()
    out.update(scribble_map=it.drawn_map.copy(), scribble_prob=_np(it.out_prob),
               scribble_mask=s.current_mask().copy())
    s.goto(0)
    it = _stroke(s, "free", [(5, 5), (30, 20), (40, 40)], 1, brush=7)
    _stroke(s, "free", [(50, 10), (55, 40), (75, 52)], 2)   # off the canvas
    s.predict()
    out.update(free_map=it.drawn_map.copy(), free_mask=_np(it.out_mask))
    s.enter_local((10, 40, 5, 30))
    local = _stroke(s, "free", [(3, 3), (20, 15), (-4, 40)], 2, brush=3)
    s.predict()
    s.finish_local()
    cropper = s.local_interactions["interact"][0]
    out.update(crop_prob=_np(cropper.out_prob), crop_image=_np(cropper.im_crop),
               local_map=local.drawn_map.copy(),
               stitched_prob=_np(s.this_frame_interactions[-1].out_prob),
               stitched_labels=s.current_mask().copy())
    for name, frame, stroke in (("round1", None, None),
                                ("round2", 5, [(10, 30), (40, 30)])):
        if frame is not None:
            s.goto(frame)
            _stroke(s, "free", stroke, 1)
            s.predict()
        totals = []
        labels = s.run_propagation(total_cb=totals.append).copy()
        out[name] = (totals, labels, np.stack(
            [_np(s.processor.get_prob(t)) for t in range(PT)]))
    return out


@pytest.fixture(scope="module")
def drives(port_nets):
    prop, fuse, s2m = port_nets
    sd = lambda m: {k: v.numpy() for k, v in m.state_dict().items()}  # noqa: E731
    images = np.random.RandomState(1).randn(PT, PH, PW, 3).astype(np.float32)
    jsession = JGuiSession(
        JPropagation(top_k=10, read_backend="xla_exact"),
        convert_prop_net(sd(prop)), JFusionNet(), convert_fusion_net(sd(fuse)),
        JS2MController(JS2MNetwork(), convert_s2m(sd(s2m)), K), None, images,
        K, mem=JMemoryConfig(top_k=10, mem_freq=2))
    tsession = GuiSession(prop, fuse, S2MController(s2m, K, device="cpu"), None,
                          images, K, mem=MemoryConfig(top_k=10, mem_freq=2),
                          device="cpu")
    with jax.default_device(jax.devices()[0]):
        jout = _drive(jsession)
    return jout, _drive(tsession), tsession.processor.pad


@pytest.mark.parametrize("name", ["scribble_map", "free_map", "local_map",
                                  "crop_prob", "crop_image", "stitched_prob"])
def test_drawn_maps_and_crops_equal_jax(drives, name):
    jout, out, _ = drives
    assert out[name].shape == jout[name].shape
    np.testing.assert_array_equal(out[name], jout[name])


def test_free_and_stitched_masks_match_jax(drives):
    jout, out, _ = drives
    np.testing.assert_allclose(out["free_mask"], jout["free_mask"], atol=1e-6,
                               rtol=0)
    np.testing.assert_array_equal(out["stitched_labels"],
                                  jout["stitched_labels"])


def test_s2m_scribble_matches_jax(drives):
    jout, out, (lw, uw, lh, uh) = drives
    assert out["scribble_prob"].shape == (K, 48, 64, 1)
    np.testing.assert_allclose(out["scribble_prob"], jout["scribble_prob"],
                               atol=PROB_ATOL, rtol=0)
    jp = jout["scribble_prob"][:, lh:48 - uh, lw:64 - uw, 0]
    fg = np.sort(np.concatenate([np.prod(1 - jp, 0, keepdims=True), jp]), 0)
    decided = fg[-1] - fg[-2] > MARGIN
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(out["scribble_mask"][decided],
                                  jout["scribble_mask"][decided])


@pytest.mark.parametrize("name", ["round1", "round2"])
def test_propagation_matches_jax(drives, name):
    jout, out, (lw, uw, lh, uh) = drives
    (jtotals, jlab, jprob), (totals, lab, prob) = jout[name], out[name]
    assert totals == jtotals
    prob = prob[:, :, 0]     # (T, K+1, nh, nw)
    jprob = jprob[..., 0]
    np.testing.assert_allclose(prob, jprob, atol=PROB_ATOL, rtol=0)
    top2 = np.sort(jprob, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0])[:, lh:48 - uh, lw:64 - uw] > MARGIN
    assert decided.mean() > 0.5
    np.testing.assert_array_equal(lab[decided], jlab[decided])


# ------------------------------------------------------------ thick lines

def _segments(h, w, n, seed):
    """n random segments on an (h, w) map; every fourth ends on a border,
    every tenth is a single point, every third has an end up to 40 px
    off the map and every sixth both (a GUI stroke dragged past the
    canvas)."""
    rng = np.random.RandomState(seed)
    segs = []
    for i in range(n):
        p0 = (int(rng.randint(w)), int(rng.randint(h)))
        p1 = (int(rng.randint(w)), int(rng.randint(h)))
        if i % 4 == 0:
            p1 = [(0, p1[1]), (w - 1, p1[1]), (p1[0], 0), (p1[0], h - 1)][i % 16 // 4]
        if i % 3 == 2:
            p1 = (int(rng.randint(-40, w + 40)), int(rng.randint(-40, h + 40)))
        if i % 6 == 5:
            p0 = (int(rng.randint(-40, w + 40)), int(rng.randint(-40, h + 40)))
        if i % 10 == 1:
            p1 = p0
        segs.append((p0, p1))
    return segs


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("thickness", [1, 2, 3, 5, 9])
def test_draw_line_matches_cv2_line(thickness, dtype):
    h, w = 120, 160
    for p0, p1 in _segments(h, w, 200, seed=thickness):
        ref = cv2.line(np.zeros((h, w), dtype), p0, p1, 7, thickness=thickness)
        out = np.zeros((h, w), dtype)
        draw_line(out, p0, p1, 7, thickness)
        np.testing.assert_array_equal(out, ref, err_msg=f"{p0} -> {p1}")


@pytest.mark.parametrize("thickness", [1, 3, 9])
def test_draw_line_matches_cv2_line_far_off_the_map(thickness):
    """Ends thousands of pixels away: cv2.line clips the segment before
    it draws, to the map grown by the thickness when thicker than 1."""
    h, w = 120, 160
    rng = np.random.RandomState(thickness)
    for _ in range(100):
        p0, p1 = [(int(rng.randint(-3000, w + 3000)),
                   int(rng.randint(-3000, h + 3000))) for _ in range(2)]
        ref = cv2.line(np.zeros((h, w), np.uint8), p0, p1, 7,
                       thickness=thickness)
        out = np.zeros((h, w), np.uint8)
        draw_line(out, p0, p1, 7, thickness)
        np.testing.assert_array_equal(out, ref, err_msg=f"{p0} -> {p1}")


# ---------------------------------------------------------------- helpers

@pytest.mark.parametrize("keep_bg,hard", [(True, False), (False, False),
                                          (True, True)])
def test_aggregate_sbg_matches_jax(keep_bg, hard):
    p = np.random.RandomState(2).rand(3, 9, 11, 1).astype(np.float32)
    p[0, 0, 0] = 0.0   # exercises the 1e-7 clamp
    p[1, 0, 1] = 1.0
    ref = np.asarray(j_aggregate_sbg(jnp.asarray(p), keep_bg, hard))
    out = aggregate_sbg(torch.from_numpy(p), keep_bg, hard).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


def test_labels_to_probs_matches_jax():
    lab = np.random.RandomState(3).randint(0, 4, (7, 9)).astype(np.uint8)
    ref = np.asarray(j_labels_to_probs(jnp.asarray(lab), 3))
    out = labels_to_probs(lab, 3)
    assert out.dtype == torch.float32 and tuple(out.shape) == (4, 7, 9, 1)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("alpha,fade", [(0.5, False), (0.5, True), (0.9, False)])
def test_overlay_and_denormalize_match_jax(alpha, fade):
    rng = np.random.RandomState(4)
    img = rng.randn(12, 15, 3).astype(np.float32)
    np.testing.assert_array_equal(im_denormalize(img), j_im_denormalize(img))
    rgb = (im_denormalize(img) * 255).astype(np.uint8)
    mask = rng.randint(0, 12, (12, 15)).astype(np.uint8)
    np.testing.assert_array_equal(overlay_davis(rgb, mask, alpha, fade),
                                  j_overlay_davis(rgb, mask, alpha, fade))


def test_timer_accumulates_only_while_running():
    t = Timer()
    assert t.count() == 0.0 and str(t) == "0.00"
    t.start()
    while t.count() <= 0.0:
        pass
    paused = t.pause().count()
    assert paused > 0.0 and t.count() == paused
    assert t.start().count() >= paused
