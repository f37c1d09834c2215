"""The program's scene, built through the port's own scene builder from a
configuration file and a traffic file."""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def build_scene(cfg: dict, settings: dict, root: str, device,
                differentiable: bool = False):
    """``raytracinginonesemester_tpu_torch`` ``Scene`` of the configuration
    ``cfg`` (a gpu scene JSON with ``scene_dir``) at the traffic's
    ``max_bounces`` and ``diffuse_bounce``, spp 1, with its block grid."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene as build
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    def vec(v):
        return tuple(float(x) for x in v)

    def material(m: dict) -> dict:
        return {k: vec(v) if isinstance(v, (list, tuple)) else float(v)
                for k, v in m.items()}

    nodes = []
    for node in cfg["scene"]:
        tr = node.get("transform", {})
        nodes.append(SceneNodeConfig(
            name=node.get("name", ""), type="mesh",
            path=os.path.join(root, cfg["scene_dir"], node["path"]),
            transform=Transform(
                position=np.asarray(tr.get("position", (0, 0, 0)), np.float32),
                rotation_deg=np.asarray(tr.get("rotation", (0, 0, 0)),
                                        np.float32),
                scale=np.asarray(tr.get("scale", (1, 1, 1)), np.float32)),
            material=material(node.get("material", {}))))
    cam = cfg["camera"]
    lights = [dict(position=vec(l["position"]),
                   color=vec(l.get("color", (1, 1, 1))),
                   intensity=float(int(l.get("intensity", 1.0))),
                   radius=0.0, shadow_samples=1)
              for l in (cfg.get("lights") or [cfg["light"]])]
    config = SceneConfig(
        max_bounces=int(settings["max_bounces"]), spp=1,
        diffuse_bounce=bool(settings["diffuse_bounce"]),
        camera_position=vec(cam["position"]),
        camera_look_at=vec(cam["look_at"]),
        camera_up=vec(cam.get("up", (0, 0, 1))),
        focal_length_mm=float(cam["focal_length_mm"]),
        sensor_height_mm=float(cam.get("sensor_height_mm", 24.0)),
        sensor_width_mm=None, pixel_width=int(cam["pixel_width"]),
        pixel_height=int(cam["pixel_height"]),
        background=("miss", vec(cfg.get("miss_color", (0, 0, 0)))),
        lights=lights, nodes=nodes, dialect="gpu")
    scene = build(config, device=device)
    if differentiable:
        scene = dataclasses.replace(scene, differentiable=True)
    return scene
