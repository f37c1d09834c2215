"""Scene JSON loading — bit-compatible with BOTH reference schema dialects.

The reference has two scene-JSON dialects with overlapping keys:

- **cpuonly** (``CPUOnly/src/scene_loader.cpp:87-184``,
  ``scene_loader.h:13-81``): ``settings.samples_per_pixel``, single
  ``light`` object with ``radius``/``shadow_samples`` soft-shadow fields,
  camera with independent ``sensor_width_mm``, sky-gradient background,
  scalar-or-vec3 ``transform.scale``.
- **gpu** (``GPUandCPU/include/scene.h:242-414``): ``settings.spp``,
  ``miss_color`` background, ``lights`` array (with single-``light``
  back-compat, ``scene.h:304-332``), integer-truncated light intensity
  (``scene.h:315``), aspect-derived sensor width.

``load_scene_config`` auto-detects the dialect (overridable) and returns a
normalized :class:`SceneConfig`; defaults match each dialect's C++ struct
initializers.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from .transform import Transform

__all__ = ["SceneConfig", "SceneNodeConfig", "load_scene_config", "resolve_mesh_path"]


@dataclasses.dataclass
class SceneNodeConfig:
    name: str = ""
    type: str = "mesh"
    path: str = ""
    transform: Transform = dataclasses.field(default_factory=Transform)
    material: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SceneConfig:
    # settings
    max_bounces: int
    spp: int
    diffuse_bounce: bool
    # camera
    camera_position: Tuple[float, float, float]
    camera_look_at: Tuple[float, float, float]
    camera_up: Tuple[float, float, float]
    focal_length_mm: float
    sensor_height_mm: float
    sensor_width_mm: Optional[float]  # None => derive from aspect (gpu/hw1)
    pixel_width: int
    pixel_height: int
    # background: ("sky", None) for the gradient, ("miss", rgb) for constant
    background: Tuple[str, Optional[Tuple[float, float, float]]]
    # lights / nodes
    lights: List[dict]
    nodes: List[SceneNodeConfig]
    dialect: str = "cpuonly"


def _vec3(v, default):
    if v is None:
        return tuple(default)
    return (float(v[0]), float(v[1]), float(v[2]))


def _parse_transform(node: dict) -> Transform:
    t = Transform()
    tr = node.get("transform")
    if not isinstance(tr, dict):
        return t
    if "position" in tr:
        t.position = np.asarray(tr["position"], dtype=np.float32)
    if "rotation" in tr:
        t.rotation_deg = np.asarray(tr["rotation"], dtype=np.float32)
    if "scale" in tr:
        sc = tr["scale"]
        if isinstance(sc, (int, float)):
            # scalar scale (CPUOnly only, scene_loader.cpp:39-46)
            t.scale = np.full(3, float(sc), dtype=np.float32)
        else:
            t.scale = np.asarray(sc, dtype=np.float32)
    return t


def _parse_material(node: dict) -> dict:
    mat = node.get("material")
    out: dict = {}
    if not isinstance(mat, dict):
        return out
    for key in ("kd", "ks", "shininess", "kr"):
        if key in mat:
            out[key] = float(mat[key])
    for key in ("albedo", "specular_color", "emission"):
        if key in mat:
            out[key] = _vec3(mat[key], (0, 0, 0))
    return out


def detect_dialect(root: dict) -> str:
    """gpu if the file uses any gpu-only key, else cpuonly."""
    settings = root.get("settings", {})
    if "spp" in settings or "miss_color" in root or "lights" in root:
        return "gpu"
    return "cpuonly"


def load_scene_config(path: str, dialect: str = "auto") -> SceneConfig:
    with open(path) as f:
        root = json.load(f)
    if dialect == "auto":
        dialect = detect_dialect(root)
    if dialect not in ("cpuonly", "gpu"):
        raise ValueError(f"unknown scene dialect {dialect!r}")
    gpu = dialect == "gpu"

    # --- settings (defaults: scene_loader.h:24-28 vs scene.h:15-19) ---
    s = root.get("settings", {})
    max_bounces = int(s.get("max_bounces", 1 if gpu else 8))
    spp = int(s.get("spp" if gpu else "samples_per_pixel", 1 if gpu else 100))
    spp = max(spp, 1)
    diffuse_bounce = bool(s.get("diffuse_bounce", True))

    # --- camera (defaults: scene.h Camera ctor vs scene_loader.h:40-49) ---
    c = root.get("camera", {})
    if gpu:
        cam_defaults = dict(
            position=(0.0, 0.0, 0.0), look_at=(0.0, 1.0, 0.0), up=(0.0, 0.0, 1.0),
            width=100, height=100, sensor_width=None,
        )
    else:
        cam_defaults = dict(
            position=(0.0, 0.0, 0.0), look_at=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0),
            width=540, height=360, sensor_width=36.0,
        )
    sensor_width = c.get("sensor_width_mm", cam_defaults["sensor_width"])
    config_camera = dict(
        camera_position=_vec3(c.get("position"), cam_defaults["position"]),
        camera_look_at=_vec3(c.get("look_at"), cam_defaults["look_at"]),
        camera_up=_vec3(c.get("up"), cam_defaults["up"]),
        focal_length_mm=float(c.get("focal_length_mm", 50.0)),
        sensor_height_mm=float(c.get("sensor_height_mm", 24.0)),
        sensor_width_mm=None if gpu else float(sensor_width),
        pixel_width=int(c.get("pixel_width", cam_defaults["width"])),
        pixel_height=int(c.get("pixel_height", cam_defaults["height"])),
    )

    # --- background ---
    if gpu:
        background = ("miss", _vec3(root.get("miss_color"), (0.0, 0.0, 0.0)))
    else:
        background = ("sky", None)  # gradient, CPUOnly/include/raytracer.h:226-229

    # --- lights ---
    lights: List[dict] = []

    def _light_from(obj: dict) -> dict:
        intensity = float(obj.get("intensity", 1.0))
        if gpu:
            # GPU dialect truncates intensity to int (scene.h:315).
            intensity = float(int(intensity))
        return dict(
            position=_vec3(obj.get("position"), (0.0, 0.0, 0.0)),
            color=_vec3(obj.get("color"), (1.0, 1.0, 1.0)),
            intensity=intensity,
            radius=float(obj.get("radius", 0.0)) if not gpu else 0.0,
            shadow_samples=int(obj.get("shadow_samples", 1)) if not gpu else 1,
        )

    if gpu and isinstance(root.get("lights"), list):
        lights = [_light_from(l) for l in root["lights"] if isinstance(l, dict)]
    if not lights and isinstance(root.get("light"), dict):
        lights = [_light_from(root["light"])]
    if not lights:
        if gpu:
            # fallback light, GPUandCPU/src/main.cu:328-336
            lights = [dict(position=(-3.0, 0.0, 1.0), color=(1.0, 1.0, 1.0),
                           intensity=1.0, radius=0.0, shadow_samples=1)]
        else:
            # LightParams defaults, scene_loader.h:31-37
            lights = [dict(position=(-3.0, 0.0, 1.0), color=(1.0, 1.0, 1.0),
                           intensity=1.0, radius=0.0, shadow_samples=1)]

    # --- scene nodes ---
    nodes: List[SceneNodeConfig] = []
    for item in root.get("scene", []):
        if not isinstance(item, dict):
            continue
        node = SceneNodeConfig(
            name=str(item.get("name", "")),
            type=str(item.get("type", "mesh")),
            path=str(item.get("path", "")),
            transform=_parse_transform(item),
            material=_parse_material(item),
        )
        if node.path:
            nodes.append(node)

    return SceneConfig(
        max_bounces=max_bounces,
        spp=spp,
        diffuse_bounce=diffuse_bounce,
        background=background,
        lights=lights,
        nodes=nodes,
        dialect=dialect,
        **config_camera,
    )


def resolve_mesh_path(scene_path: str, mesh_path: str) -> str:
    """Mesh path resolution: scene-relative, then cwd, then project-relative.

    Mirrors ``GPUandCPU/src/main.cu:119-147``; the CPUOnly loader's
    base-dir resolution (``scene_loader.cpp:76-83``) is subsumed by the
    scene-relative attempt.
    """
    if os.path.isabs(mesh_path):
        return mesh_path
    base_dir = os.path.dirname(os.path.abspath(scene_path))
    candidates = [
        os.path.join(base_dir, mesh_path),
        mesh_path,
        os.path.join(os.path.dirname(os.path.dirname(base_dir)),
                     mesh_path[2:] if mesh_path.startswith("./") else mesh_path),
    ]
    for cand in candidates:
        if os.path.exists(cand):
            return cand
    return candidates[0]
