"""Render window of the CPUOnly dialect: as ``render_frames`` (one client
calls ``render_scene_frames`` again as soon as its last call has been
synchronised, ``frames_per_call`` frames a call at the next sample
indices, ``check_pixels_per_call`` pixels of each call gathered on the
card), on a scene of the CPUOnly schema that the port's own scene builder
builds in the cpuonly dialect, checked against the plain CPUOnly tracer
(``reference/cpuonly.py``) at the jitter that the port resolved.
"""

from __future__ import annotations

import os
import types

from ..reference import cpuonly as reference
from ..reference import cpuonly_scene as ref_scene
from . import render_frames


def build_scene(cfg: dict, settings: dict, root: str, device):
    """``raytracinginonesemester_tpu_torch`` ``Scene`` of ``cfg`` (a CPUOnly
    scene JSON with ``scene_dir``) at the traffic's ``max_bounces`` and
    ``diffuse_bounce``, spp 1, with its block grid: the nodes' transforms
    and materials read by the port's own parser, the camera and the light
    at the CPUOnly schema's defaults where ``cfg`` gives none
    (``scene_loader.h:24-49``)."""
    from raytracinginonesemester_tpu_torch.scene import config as port_cfg
    from raytracinginonesemester_tpu_torch.scene.build import build_scene as build

    def vec(v):
        return tuple(float(x) for x in v)

    nodes = [port_cfg.SceneNodeConfig(
        name=node.get("name", ""), type="mesh",
        path=os.path.join(root, cfg["scene_dir"], node["path"]),
        transform=port_cfg._parse_transform(node),
        material=port_cfg._parse_material(node)) for node in cfg["scene"]]
    cam, light = cfg["camera"], cfg["light"]
    config = port_cfg.SceneConfig(
        max_bounces=int(settings["max_bounces"]), spp=1,
        diffuse_bounce=bool(settings["diffuse_bounce"]),
        camera_position=vec(cam.get("position", (0, 0, 0))),
        camera_look_at=vec(cam.get("look_at", (0, 0, 0))),
        camera_up=vec(cam.get("up", (0, 0, 1))),
        focal_length_mm=float(cam.get("focal_length_mm", 50.0)),
        sensor_height_mm=float(cam.get("sensor_height_mm", 24.0)),
        sensor_width_mm=float(cam.get("sensor_width_mm", 36.0)),
        pixel_width=int(cam["pixel_width"]),
        pixel_height=int(cam["pixel_height"]),
        background=("sky", None),
        lights=[dict(position=vec(light.get("position", (-3, 0, 1))),
                     color=vec(light.get("color", (1, 1, 1))),
                     intensity=float(light.get("intensity", 1.0)),
                     radius=float(light.get("radius", 0.0)),
                     shadow_samples=int(light.get("shadow_samples", 1)))],
        nodes=nodes, dialect="cpuonly")
    return build(config, device=device)


class Entry(render_frames.Entry):
    def __init__(self, run):
        from raytracinginonesemester_tpu_torch.render import renderer

        self.run = run
        t = run.traffic
        self.renderer = renderer
        self.frames = int(t["frames_per_call"])
        self.jitter = t["jitter"]
        self.scene = build_scene(run.cfg, t, run.root, run.device)
        # spp-1 frames: "auto" is the pixel centres in this dialect
        self.ref_jitter = renderer.resolve_jitter_mode(self.scene,
                                                       self.jitter, 1)
        cam = run.cfg["camera"]
        self.w, self.h = int(cam["pixel_width"]), int(cam["pixel_height"])
        # half of the checked pixels in the box the triangles project to
        boxed = types.SimpleNamespace(**vars(run))
        boxed.cfg = {**run.cfg, "check_box": run.cfg["cpuonly_check_box"]}
        self.pool = self._pool(boxed, run.keep_pixels
                               or int(t["check_pixels_per_call"]))
        self.offset = run.seed % render_frames.OFFSET_SPAN
        self.kept = []
        self.harness_s = 0.0
        self.out = None
        self.call()  # warm-up: the build, the plan, the calibration
        self.out = None

    def _reference(self, samples, dtype):
        # the scene as the benchmark's own CPUOnly loader reads it
        arrays = ref_scene.build(self.run.cfg, self.run.traffic,
                                 self.run.root)
        return reference.pixels(arrays, samples, self.ref_jitter,
                                self.run.device, dtype)
