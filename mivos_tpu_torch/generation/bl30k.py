"""BL30K synthetic-scene config generator (counterpart of
mivos_tpu/generation/bl30k.py, numpy only: the same scene from the same
seed, bit for bit).

Reference: generation/blender/{generate_yaml.py,gen_utils.py} — emits
one BlenderProc YAML config per scene: 160 frames, 3-5 ShapeNet objects
following degree-4 polynomial trajectories (control points constrained
to a bounding block with per-frame speed limits and sticky static
states), a polynomial camera + look-at trajectory, 1-3 sphere lights,
and probabilistic texture replacement. Object paths are rejection-
sampled so no two trajectories come within `min_separation` of each
other (continuous-time check via bounded scalar minimization).

Rework (not a translation): one dataclass config + explicit
np.random.Generator per scene (the reference leans on the global
numpy RNG), and the trajectory/separation math is vectorized.
Rendering the scenes needs ShapeNet and BlenderProc, which are not
part of this package.
"""
from __future__ import annotations

import dataclasses
import json
import os
from os import path
from typing import Dict, List, Optional, Sequence

import numpy as np
import numpy.polynomial.polynomial as npoly


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    n_frames: int = 160
    res_x: int = 768
    res_y: int = 512
    degree: int = 4
    min_num_obj: int = 3
    max_num_obj: int = 5
    cam_fov: tuple = (0.7, 0.8)
    obj_scale: tuple = (1.25, 3.0)
    scale_change: tuple = (0.8, 1.25)
    obj_max_tsl_per_frame: float = 0.03
    obj_max_rot_per_frame: float = 0.02
    cam_max_tsl_per_frame: float = 0.10
    cam_look_at_max_shift: float = 0.10
    enter_static_prob: float = 0.10
    conti_static_prob: float = 0.35
    num_lights: tuple = (1, 3)
    light_strength: tuple = (1000.0, 15000.0)
    light_radius: float = 11.0
    sky_light: tuple = (0.1, 1.0)
    mapped_replace_prob: float = 0.5
    unmapped_replace_prob: float = 1.0
    # bounding volumes (x/z "base" extent, y "into-screen" extent)
    cam_block: tuple = (-0.3, 0.3, -6.0, -5.0)
    look_block: tuple = (-0.5, 0.5, 3.0, 4.0)
    obj_block: tuple = (-1.05, 1.05, -2.0, 5.0)
    min_separation: float = 0.75


def _block_point(rng, block) -> np.ndarray:
    lo_b, hi_b, lo_y, hi_y = block
    return np.asarray([rng.uniform(lo_b, hi_b), rng.uniform(lo_y, hi_y),
                       rng.uniform(lo_b, hi_b)])


def _step_in_block(rng, curr, max_delta, block) -> np.ndarray:
    """Propose a fresh block point, clamp the per-axis step to
    max_delta (reference gen_utils.py:86-96)."""
    target = _block_point(rng, block)
    step = np.clip(target - curr, -np.abs(max_delta), np.abs(max_delta))
    return curr + step


def _control_points(rng, cfg: SceneConfig, block, per_frame_limit: float
                    ) -> np.ndarray:
    """degree+1 control points with sticky static segments
    (reference generate_yaml.py:139-155)."""
    pts = np.zeros((cfg.degree + 1, 3))
    pts[0] = _block_point(rng, block)
    max_dist = per_frame_limit * cfg.n_frames / cfg.degree
    static = rng.random() < cfg.enter_static_prob
    for i in range(1, cfg.degree + 1):
        if static:
            pts[i] = pts[i - 1]
            if rng.random() > cfg.conti_static_prob:
                static = False
        else:
            delta = rng.normal(0.0, max_dist, 3)
            pts[i] = _step_in_block(rng, pts[i - 1], delta, block)
            if rng.random() < cfg.enter_static_prob:
                static = True
    return pts


def _fit_poly(cfg: SceneConfig, pts: np.ndarray) -> List[List[float]]:
    xs = np.linspace(0.0, 1.0, cfg.degree + 1)
    return npoly.polyfit(xs, pts, deg=cfg.degree).astype(float).tolist()


def paths_separated(prev_polys: Sequence[np.ndarray], cand: np.ndarray,
                    tol: float, samples: int = 512) -> bool:
    """Min distance between two polynomial paths over t in [0, 1] must
    exceed tol (reference gen_utils.py:27-41 solves a bounded scalar
    optimization; a dense t-grid is equally tight at these degrees and
    has no optimizer dependency)."""
    t = np.linspace(0.0, 1.0, samples)
    c = npoly.polyval(t, np.asarray(cand))          # (3, samples)
    for p in prev_polys:
        d = npoly.polyval(t, np.asarray(p)) - c
        if np.min(np.linalg.norm(d, axis=0)) < tol:
            return False
    return True


class SceneGenerator:
    """Emits BlenderProc scene configs for BL30K.

    obj_list: ShapeNet model names; texture_list: texture file names.
    `mapped` lookup (does the model ship a texture map?) is injectable
    for testing; default reads model_normalized.mtl like the reference
    (generate_yaml.py:171-180).
    """

    def __init__(self, cfg: SceneConfig, obj_list: Sequence[str],
                 texture_list: Sequence[str],
                 obj_root: Optional[str] = None,
                 is_mapped=None, seed: int = 0):
        self.cfg = cfg
        self.obj_list = list(obj_list)
        self.texture_list = list(texture_list)
        self.obj_root = obj_root
        self._is_mapped = is_mapped or self._mtl_is_mapped
        self.seed = seed

    def _mtl_is_mapped(self, obj_name: str) -> bool:
        if self.obj_root is None:
            return False
        mtl = path.join(self.obj_root, obj_name, "models",
                        "model_normalized.mtl")
        try:
            with open(mtl) as f:
                return any("map_Kd" in line for line in f)
        except OSError:
            return False

    def scene(self, scene_id: int) -> Dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, scene_id]))

        d: Dict = {
            "version": 2,
            "setup": {"blender_install_path": "/home/<env:USER>/blender/",
                      "pip": []},
            "global": {"all": {"output_dir": f"<args:2>/{scene_id:06d}"}},
            "modules": [{"module": "main.Initializer", "config": {}}],
        }

        # Camera trajectory.
        cam = {
            "module": "camera.CameraTrajectoryRunner",
            "config": {
                "intrinsics": {"resolution_x": cfg.res_x,
                               "resolution_y": cfg.res_y,
                               "fov": float(rng.uniform(*cfg.cam_fov))},
                "cam_poses": {
                    "location_poly": _fit_poly(cfg, _control_points(
                        rng, cfg, cfg.cam_block,
                        cfg.cam_max_tsl_per_frame)),
                    "look_at_poly": _fit_poly(cfg, _control_points(
                        rng, cfg, cfg.look_block,
                        cfg.cam_look_at_max_shift)),
                },
            },
        }
        d["modules"].append(cam)

        # Objects with pairwise-separated trajectories.
        n_obj = int(rng.integers(cfg.min_num_obj, cfg.max_num_obj + 1))
        prev_polys: List[np.ndarray] = []
        for _ in range(n_obj):
            for _attempt in range(50):
                pts = _control_points(rng, cfg, cfg.obj_block,
                                      cfg.obj_max_tsl_per_frame)
                cand = np.asarray(_fit_poly(cfg, pts))
                if paths_separated(prev_polys, cand, cfg.min_separation):
                    break
            prev_polys.append(cand)

            name = self.obj_list[int(rng.integers(len(self.obj_list)))]
            mapped = self._is_mapped(name)
            replace_p = (cfg.mapped_replace_prob if mapped
                         else cfg.unmapped_replace_prob)
            obj = {
                "module": "object.ObjectTrajectoryRunner",
                "config": {
                    "path": f"<args:0>/{name}/models/model_normalized.obj",
                    "seed": int(rng.integers(0, 2 ** 31)),
                    "location_poly": cand.tolist(),
                    "scale": float(rng.uniform(*cfg.obj_scale)),
                    "scale_change": float(rng.uniform(*cfg.scale_change)),
                    "max_rot_per_frame": cfg.obj_max_rot_per_frame,
                },
            }
            if rng.random() < replace_p and self.texture_list:
                tex = self.texture_list[
                    int(rng.integers(len(self.texture_list)))]
                obj["config"]["texture"] = f"<args:1>/{tex}"
            d["modules"].append(obj)

        # Lights on a sphere + sky light.
        n_lights = int(rng.integers(cfg.num_lights[0], cfg.num_lights[1] + 1))
        for _ in range(n_lights):
            v = rng.normal(0.0, 1.0, 3)
            pos = cfg.light_radius * v / np.linalg.norm(v)
            d["modules"].append({
                "module": "lighting.LightRunner",
                "config": {
                    "location": pos.tolist(),
                    "strength": float(rng.uniform(*cfg.light_strength)),
                    "color": (0.5 + 0.5 * rng.random(3)).tolist(),
                },
            })
        d["modules"].append({
            "module": "lighting.SkyLight",
            "config": {"strength": float(rng.uniform(*cfg.sky_light))},
        })

        # Renderers + writer (generate_yaml.py:100-122).
        d["modules"] += [
            {"module": "renderer.SimRgbRenderer",
             "config": {"resolution_x": cfg.res_x,
                        "resolution_y": cfg.res_y,
                        "output_key": "colors"}},
            {"module": "renderer.SegMapPngRenderer",
             "config": {"resolution_x": cfg.res_x,
                        "resolution_y": cfg.res_y,
                        "map_by": "instance"}},
            {"module": "writer.RGBSegWriter", "config": {}},
        ]
        return d

    def write(self, out_dir: str, start: int, count: int) -> List[str]:
        os.makedirs(out_dir, exist_ok=True)
        written = []
        for sid in range(start, start + count):
            cfg_dict = self.scene(sid)
            p = path.join(out_dir, f"{sid:06d}")
            try:
                import yaml

                with open(p + ".yaml", "w") as f:
                    yaml.safe_dump(cfg_dict, f, sort_keys=False)
                written.append(p + ".yaml")
            except ImportError:
                with open(p + ".json", "w") as f:
                    json.dump(cfg_dict, f, indent=1)
                written.append(p + ".json")
        return written
