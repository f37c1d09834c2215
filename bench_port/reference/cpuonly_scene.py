"""The benchmark's own loader of the CPUOnly scene schema: a configuration
file and the OBJ files it names -> plain numpy arrays.

The CPUOnly renderer's schema (``HW2/HW2/CPUOnly/include/scene_loader.h``
``:24-37``, ``src/scene_loader.cpp``) differs from the gpu one that
``scene.py`` reads in four places, taken here: a camera whose sensor
width is its own (``sensor_width_mm``, 36 mm by default) rather than
derived from the pixel aspect; one ``light`` with an area ``radius`` and
its ``shadow_samples``, its intensity kept as written (the gpu loader
truncates it); the sky gradient in place of a miss colour; and a scalar
``transform.scale``.  The OBJ parsing, the transform and the padded
triangle soup are ``scene.py``'s.

Materials take the keys the CPUOnly loader reads (``albedo``, ``kd``,
``ks``, ``specular_color``, ``shininess``, ``kr``, ``emission``) over
the defaults of ``material.h``.  The course's ``cpuonly_mirror.json``
spells its specular colours ``specularColor``, which is not among them,
so the default 0.04 stands, as in the C++ renderer's own image of the
scene (``tests/goldens/cpuonly_mirror.png``).
"""

from __future__ import annotations

import os

import numpy as np

from .scene import (MATERIAL_DEFAULTS, PAD, SceneArrays, _obj, _transform,
                    screen_box)

__all__ = ["build", "screen_box"]

MATERIAL_KEYS = tuple(MATERIAL_DEFAULTS)


def _camera(c: dict) -> dict:
    """The CPUOnly camera (``camera.h``): the frame from look-at and up in
    float64, a sensor of ``sensor_width_mm`` x ``sensor_height_mm``."""
    width, height = int(c["pixel_width"]), int(c["pixel_height"])
    center = np.asarray(c.get("position", (0, 0, 0)), np.float64)
    look_at = np.asarray(c.get("look_at", (0, 0, 0)), np.float64)
    up = np.asarray(c.get("up", (0, 0, 1)), np.float64)

    def unit_or(v):
        n = float(np.sqrt(np.dot(v, v)))
        return np.array([0.0, 0.0, 1.0]) if n < 1e-12 else v / n

    forward = unit_or(look_at - center)
    right = unit_or(np.cross(forward, up))
    up2 = np.cross(right, forward)
    vh = float(c.get("sensor_height_mm", 24.0)) / 1000.0
    vw = float(c.get("sensor_width_mm", 36.0)) / 1000.0
    vu, vv = vw * right, -vh * up2
    du, dv = vu / float(width), vv / float(height)
    corner = (center + float(c.get("focal_length_mm", 50.0)) / 1000.0
              * forward - 0.5 * vu - 0.5 * vv)

    def f32(a):
        return np.asarray(a, np.float32)

    return dict(center=f32(center), pixel00=f32(corner + 0.5 * (du + dv)),
                du=f32(du), dv=f32(dv), width=width, height=height)


def build(cfg: dict, settings: dict, root: str) -> SceneArrays:
    """``cfg``: a configuration file's contents (a CPUOnly scene JSON with
    ``scene_dir``, relative to ``root``); ``settings``: the traffic's
    ``max_bounces`` and ``diffuse_bounce``.  ``lights`` also holds each
    light's ``radius`` and ``shadow_samples``."""
    if cfg.get("dialect") != "cpuonly":
        raise ValueError("this loader reads the cpuonly dialect only")
    scene_dir = os.path.join(root, cfg["scene_dir"])
    tris, norms, ids, mats = [], [], [], []
    next_id = 0
    for node in cfg["scene"]:
        first = next_id
        tri, nrm, oid, next_id = _obj(
            os.path.join(scene_dir, node["path"]), next_id)
        tri, nrm = _transform(tri, nrm, node.get("transform", {}))
        tris.append(tri)
        norms.append(np.zeros_like(tri) if nrm is None else nrm)
        ids.append(oid)
        given = node.get("material", {})
        mat = {**MATERIAL_DEFAULTS,
               **{k: given[k] for k in MATERIAL_KEYS if k in given}}
        mats += [mat] * (next_id - first)
    tri, nrm, oid = (np.concatenate(a) for a in (tris, norms, ids))
    t = tri.shape[0]
    padded = max(-(-t // PAD) * PAD, PAD)
    if padded > t:
        tri = np.concatenate([tri, np.broadcast_to(tri[0, 0],
                                                   (padded - t, 3, 3))])
        nrm = np.concatenate([nrm, np.zeros((padded - t, 3, 3), np.float32)])
        oid = np.concatenate([oid, np.full(padded - t, -1, np.int32)])
    light = cfg["light"]
    return SceneArrays(
        vertices=np.ascontiguousarray(tri, np.float32),
        normals=np.ascontiguousarray(nrm, np.float32),
        obj_id=oid.astype(np.int32), num_triangles=t,
        materials={k: np.array([m[k] for m in mats], np.float32)
                   for k in MATERIAL_KEYS},
        lights=dict(
            position=np.array([light.get("position", (-3, 0, 1))],
                              np.float32),
            color=np.array([light.get("color", (1, 1, 1))], np.float32),
            intensity=np.array([float(light.get("intensity", 1.0))],
                               np.float32),
            radius=np.array([float(light.get("radius", 0.0))], np.float32),
            shadow_samples=[int(light.get("shadow_samples", 1))]),
        camera=_camera(cfg["camera"]),
        miss_color=np.zeros(3, np.float32),  # the sky gradient instead
        max_bounces=max(1, int(settings["max_bounces"])),
        diffuse_bounce=bool(settings["diffuse_bounce"]))
