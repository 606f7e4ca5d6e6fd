"""The accuracy paths of the PyTorch port against the JAX package's
scripts: `accuracy_envelope` (scripts/accuracy_envelope.py),
`envelope_diagnose` (scripts/envelope_diagnose.py) and `full_protocol`
(scripts/full_protocol_tpu.py).

The scripts' inputs equal the JAX scripts' bit for bit (the drifting
textures and blobs, the synthetic sequences of the pretraining
distribution). Both CLIs run end to end on the CPU at a tiny size, where
the fast path's read is the kernels' plain version against the exact
read: the envelope at 6 frames of 64x96, K = 2, random init, passing its
JAX gates; the protocol at 1 sequence, 6 frames, 2 rounds, 64x64, on
random-init weights saved as .pth. `envelope_diagnose` reads the
envelope's dump and writes the JAX script's report, key for key and
value for value (exact: numpy on the same arrays).
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mivos_tpu_torch import accuracy_envelope, envelope_diagnose, full_protocol
from mivos_tpu_torch.checkpoint.manager import save_params
from mivos_tpu_torch.models.initializer import init_params
from mivos_tpu_torch.models.propagation import PropagationNetwork
from mivos_tpu_torch.models.s2m import S2MNetwork

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVELOPE_KEYS = ("label_agreement", "agreement_margin_1e-3", "agreement_margin_1e-2",
                 "frac_margin_1e-2", "prob_err_median", "prob_err_p99", "prob_err_max",
                 "frames", "objects", "hw", "fast_s", "exact_s", "weights",
                 "fusion_weights", "fast_config")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread (tests/test_torch_serve.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_session_inputs_match_jax():
    jenv = _script("accuracy_envelope")
    for got, want in zip(accuracy_envelope.make_session_inputs(3),
                         jenv.make_session_inputs(3)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_trained_session_inputs_match_jax(monkeypatch):
    jenv = _script("accuracy_envelope")
    t, h, w, k = 5, 48, 80, 3
    monkeypatch.setattr(jenv, "T", t)
    monkeypatch.setattr(jenv, "H", h)
    monkeypatch.setattr(jenv, "W", w)
    monkeypatch.setattr(jenv, "K", k)
    for got, want in zip(accuracy_envelope.make_trained_session_inputs(11, t, h, w, k),
                         jenv.make_trained_session_inputs(11)):
        np.testing.assert_array_equal(got, np.asarray(want))


def test_protocol_sequences_match_jax():
    jfp = _script("full_protocol_tpu")
    got, want = full_protocol.build_sequences(2, 4, 32, 48, 2), jfp.build_sequences(2, 4, 32, 48, 2)
    assert list(got) == list(want)
    for name in got:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def envelope_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("envelope")
    accuracy_envelope.main(["--device", "cpu", "--frames", "6", "--hw", "64", "96",
                            "--objects", "2", "--dump-dir", str(tmp)])
    return tmp


def test_envelope_cli_passes_its_gates(envelope_run, capsys):
    args = accuracy_envelope.parse_args(["--device", "cpu", "--frames", "4", "--hw", "64",
                                         "96", "--objects", "2", "--dump-dir",
                                         str(envelope_run), "--tag", "_again",
                                         "--fast-towers-fp32", "--fast-fusion-fp32"])
    report = accuracy_envelope.envelope(args, log=lambda *a: None)
    assert set(ENVELOPE_KEYS) <= set(report)
    assert report["fast_config"] == {"towers_fp32": True, "fusion_fp32": True,
                                     "read_refine": 0}
    accuracy_envelope.check_gates(report)
    d = np.load(report["dump"])
    assert d["out_f"].shape == (4, 64, 96) and d["prob_f"].shape == (4, 3, 64, 96, 1)
    np.testing.assert_allclose(d["prob_f"].sum(1), 1.0, atol=1e-5)


def test_envelope_diagnose_matches_jax(envelope_run, tmp_path):
    jdiag = _script("envelope_diagnose")
    dump = str(envelope_run / "envelope_arrays.npz")
    mine, theirs = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    envelope_diagnose.main([dump, "--ablation", f"same={dump}", "--margin", "0.001",
                            "--out", mine])
    import sys
    argv = sys.argv
    try:
        sys.argv = ["envelope_diagnose.py", dump, "--ablation", f"same={dump}",
                    "--margin", "0.001", "--out", theirs]
        jdiag.main()
    finally:
        sys.argv = argv
    with open(mine) as f, open(theirs) as g:
        assert json.load(f) == json.load(g)


def test_full_protocol_cli_tiny(tmp_path):
    gen = torch.Generator().manual_seed(0)
    save_params(str(tmp_path / "prop_synthetic.pth"), init_params(PropagationNetwork(), gen))
    save_params(str(tmp_path / "s2m_synthetic.pth"), init_params(S2MNetwork(), gen))
    out = tmp_path / "report.json"
    full_protocol.main(["--device", "cpu", "--frames", "6", "--rounds", "2",
                        "--sequences", "1", "--hw", "64", "64", "--weights",
                        str(tmp_path), "--out", str(out)])
    with open(out) as f:
        report = json.load(f)
    assert report["fusion"] == "off"
    for tag in ("fast", "exact"):
        recs = report[tag]["summary"]["records"]["synth0"]
        assert len(recs) == 2 and all(0.0 <= jf <= 1.0 for _, jf in recs)
        assert len(report[tag]["per_round_s"]["synth0"]) == 2
    assert report["max_round_jf_delta"] < full_protocol.JF_DELTA_MAX
