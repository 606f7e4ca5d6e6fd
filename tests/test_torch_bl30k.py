"""`generation/bl30k.py` of the PyTorch port against the JAX package's:
`SceneConfig`, `paths_separated` and `SceneGenerator` give the same
scenes, bit for bit, from the same seed (exact: both are numpy on the
same Generator streams); `write` writes the same files."""
import dataclasses
import json
import os

import numpy as np
import pytest

from mivos_tpu.generation import bl30k as jbl30k
from mivos_tpu_torch.generation import bl30k

OBJS = [f"obj{i:03d}" for i in range(17)]
TEXTURES = [f"tex{i}.jpg" for i in range(5)]


def test_scene_config_matches_jax():
    assert dataclasses.asdict(bl30k.SceneConfig()) == dataclasses.asdict(jbl30k.SceneConfig())


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("cfg_kw", [{}, {"n_frames": 40, "degree": 3, "min_num_obj": 5,
                                        "max_num_obj": 8, "min_separation": 1.2}])
def test_scenes_match_jax_bit_for_bit(seed, cfg_kw):
    def mapped(name):
        return int(name[3:]) % 3 == 0

    mine = bl30k.SceneGenerator(bl30k.SceneConfig(**cfg_kw), OBJS, TEXTURES,
                                is_mapped=mapped, seed=seed)
    theirs = jbl30k.SceneGenerator(jbl30k.SceneConfig(**cfg_kw), OBJS, TEXTURES,
                                   is_mapped=mapped, seed=seed)
    for sid in (0, 1, 2, 99):
        a, b = mine.scene(sid), theirs.scene(sid)
        assert json.dumps(a) == json.dumps(b)   # floats by their repr: bit for bit
    objs = [m for m in a["modules"] if m["module"] == "object.ObjectTrajectoryRunner"]
    assert cfg_kw.get("min_num_obj", 3) <= len(objs) <= cfg_kw.get("max_num_obj", 5)


def test_paths_separated_matches_jax():
    rng = np.random.default_rng(0)
    polys = [rng.normal(0, 1, (5, 3)) for _ in range(6)]
    for i in range(1, 6):
        for tol in (0.1, 0.75, 3.0):
            assert bl30k.paths_separated(polys[:i], polys[i], tol) == \
                jbl30k.paths_separated(polys[:i], polys[i], tol)
    assert bl30k.paths_separated([], polys[0], 10.0)


def test_write_matches_jax(tmp_path):
    root = tmp_path / "shapenet"
    mtl = root / "obj003" / "models"
    mtl.mkdir(parents=True)
    (mtl / "model_normalized.mtl").write_text("newmtl a\nmap_Kd tex.png\n")
    kw = dict(obj_root=str(root), seed=3)
    a = bl30k.SceneGenerator(bl30k.SceneConfig(), OBJS, TEXTURES, **kw).write(
        str(tmp_path / "mine"), 5, 3)
    b = jbl30k.SceneGenerator(jbl30k.SceneConfig(), OBJS, TEXTURES, **kw).write(
        str(tmp_path / "theirs"), 5, 3)
    assert [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    for p, q in zip(a, b):
        with open(p) as f, open(q) as g:
            assert f.read() == g.read()
