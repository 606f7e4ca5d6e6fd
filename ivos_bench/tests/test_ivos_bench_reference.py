"""The plain reference against the port on the CPU, at a tiny size.

Only this test imports both. The networks keep their published widths
at a 64x96 frame; the session runs the tiny cell's rounds. Against the
port's `exact` read backend the two agree to float32 rounding; against
`plain` (the CUDA kernel's threshold algorithm as dense ops) they part
by the algorithm's extra entries, a few 1e-6 in the mean.
"""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ivos_bench.cell import play
from ivos_bench.check import Gap, changed, due
from ivos_bench.clips import interaction_mask, make_clip
from ivos_bench.interactions import mask
from ivos_bench.reference import nets as ref_nets
from ivos_bench.reference.session import Session
from ivos_bench.weights import make_weights

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
H, W, K, T = 64, 90, 2, 10
ROUNDS = [0, 7, 3]


@pytest.fixture(scope="module")
def inputs():
    torch.manual_seed(0)
    sd, fsd = make_weights(11, torch.float32, "cpu")
    frames, labels = make_clip(11, 0, T, H, W, K, "cpu")
    return sd, fsd, frames, labels


def _port(sd, fsd, backend):
    from mivos_tpu_torch.models.fusion import FusionNet
    from mivos_tpu_torch.models.propagation import PropagationNetwork

    prop = PropagationNetwork(top_k=50, read_backend=backend)
    prop.load_state_dict(sd)
    fuse = FusionNet()
    fuse.load_state_dict(fsd)
    return prop, fuse


def _session_gap(inputs, backend):
    from mivos_tpu_torch.config import MemoryConfig
    from mivos_tpu_torch.core.inference import InferenceCore

    sd, fsd, frames, labels = inputs
    prop, fuse = _port(sd, fsd, backend)
    core = InferenceCore(prop, fuse, frames, K, mem=MemoryConfig(mem_freq=2),
                         device="cpu")
    got = play(core, ROUNDS, (frames, labels), K, mask.setup(None, 11, "cpu"))
    rprop, rfuse = ref_nets.build(sd, "cpu", 50, fsd)
    ref = Session(rprop, rfuse, frames, K, 2, cache_queries=True)
    gap, compared = Gap("cpu"), 0
    for r, idx in enumerate(ROUNDS):
        before = list(ref.prob)
        after = ref.interact(interaction_mask(labels[idx], K), idx)
        assert sorted(changed(before, after, idx)) == due(T, ROUNDS[:r], idx)
        for ti in changed(before, after, idx):
            gap.add(got[r][1][ti], after[ti], ref.pad)
            compared += 1
    assert compared == 9 + 8 + 5   # every propagated frame of the 3 rounds
    return gap.numbers()


def test_networks_match_the_port(inputs):
    sd, fsd, frames, _ = inputs
    prop, fuse = _port(sd, fsd, "exact")
    rprop, rfuse = ref_nets.build(sd, "cpu", 50, fsd)
    img = torch.randn(1, 3, H + 0, 96)
    masks = torch.rand(K, 1, H, 96)
    with torch.no_grad():
        f16, f8, f4, k16, v16 = prop.get_query_values(img[0].movedim(0, -1))
        r8, r4, rk, rv = rprop.get_query_values(img)
        for a, b in ((f8, r8), (f4, r4), (k16, rk), (v16, rv)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
        mk, mv = prop.memorize(img[0].movedim(0, -1), masks.movedim(1, -1))
        rmk, rmv = rprop.memorize(img, masks)
        torch.testing.assert_close(mk, rmk.transpose(1, 2), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(mv, rmv.transpose(1, 2), rtol=1e-4, atol=1e-4)
        readout = torch.randn(K, 24, 512)
        logits = prop.decode(readout, f8, f4, v16)
        x = torch.cat([readout.transpose(1, 2).reshape(K, 512, 4, 6),
                       rv.expand(K, -1, -1, -1)], 1)
        torch.testing.assert_close(logits.movedim(-1, 1), rprop.decoder(x, r8, r4),
                                   rtol=1e-4, atol=1e-4)
        attn = prop.get_attention(mk, masks.movedim(1, -1), masks.movedim(1, -1), k16)
        rattn = rprop.get_attention(rmk[:1], masks[:1], masks[:1], rk)
        torch.testing.assert_close(attn[:1], rattn, rtol=1e-4, atol=1e-5)


def test_exact_read_matches_the_port():
    from mivos_tpu_torch.ops.memory_read import memory_read

    g = torch.Generator().manual_seed(3)
    mk = torch.randn(K, 128, 700, generator=g)
    mv = torch.randn(K, 512, 700, generator=g)
    qk = torch.randn(128, 40, generator=g)
    rprop = ref_nets.PropagationNetwork(50)
    ours = rprop.read(mk, mv, qk, block_bytes=4 * K * 700 * 7)   # blocks of 7 queries
    port = memory_read(mk.transpose(1, 2), mv.transpose(1, 2), qk.t(), top_k=50,
                       backend="exact")
    torch.testing.assert_close(ours, port.transpose(1, 2), rtol=1e-5, atol=1e-5)


def test_session_matches_the_port_exact_read(inputs):
    numbers = _session_gap(inputs, "exact")
    assert numbers["prob_mae"] < 1e-6
    assert numbers["frame_mae_max"] < 1e-5


def test_session_matches_the_port_plain_read(inputs):
    numbers = _session_gap(inputs, "plain")
    assert numbers["prob_mae"] < 1e-4
    assert numbers["frame_mae_max"] < 1e-3


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("mivos_tpu_torch", "mivos_tpu", "jax"), (
                    f"{path.name} imports {name}")
    code = ("import sys, ivos_bench.reference.nets, ivos_bench.reference.session, "
            "ivos_bench.reference.precision, ivos_bench.check, ivos_bench.weights, "
            "ivos_bench.clips, ivos_bench.counts;"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mivos_tpu_torch', 'mivos_tpu', 'jax', 'jaxlib', 'flax'});"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REFERENCE.parents[1],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_reference_bank_cap_is_the_deployments():
    """The reference thins a pass at the cap the benchmark's sessions run
    under: the program's default."""
    from mivos_tpu_torch.config import MemoryConfig

    from ivos_bench.reference.session import BANK_CAP_FRAMES

    assert BANK_CAP_FRAMES == MemoryConfig().bank_cap_frames
