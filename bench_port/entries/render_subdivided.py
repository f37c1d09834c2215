"""Render window of a subdivided mesh: ``render_frames``' window (one
client calls ``render_scene_frames`` again as soon as its last call has
been synchronised, ``frames_per_call`` frames a call at the next sample
indices, ``check_pixels_per_call`` pixels of each call gathered on the
card), on the configuration's scene with its mesh subdivided
``subdivide_levels`` times (the port's ``scene.subdivide``) and its block
grid rebuilt at 512 lanes, as ``chip_smoke.py`` builds its large scene;
checked against ``reference/subdivided.py``, which subdivides with its
own code.
"""

from __future__ import annotations

import dataclasses

from .. import program
from ..reference import subdivided as reference
from . import render_frames


def build_scene(cfg: dict, settings: dict, root: str, device):
    """``program.build_scene`` of ``cfg``, its geometry subdivided
    ``cfg["subdivide_levels"]`` times and its block grid rebuilt over the
    result at 512 lanes."""
    from raytracinginonesemester_tpu_torch.ops.accel import build_block_grid
    from raytracinginonesemester_tpu_torch.scene.subdivide import (
        subdivide_geometry)

    scene = program.build_scene(cfg, settings, root, device)
    geom = subdivide_geometry(scene.geometry, int(cfg["subdivide_levels"]))
    grid = build_block_grid(geom.vertices, geom.num_triangles,
                            block_size=512, normals=geom.normals,
                            obj_ids=geom.obj_id)
    return dataclasses.replace(scene, geometry=geom, accel=grid)


class Entry(render_frames.Entry):
    def __init__(self, run):
        from raytracinginonesemester_tpu_torch.render import renderer

        self.run = run
        t = run.traffic
        self.renderer = renderer
        self.frames = int(t["frames_per_call"])
        self.jitter = t["jitter"]
        # "auto" is "wang" in the gpu dialect (render/renderer.py)
        self.ref_jitter = "wang" if self.jitter == "auto" else self.jitter
        self.scene = build_scene(run.cfg, t, run.root, run.device)
        cam = run.cfg["camera"]
        self.w, self.h = int(cam["pixel_width"]), int(cam["pixel_height"])
        self.pool = self._pool(run, run.keep_pixels
                               or int(t["check_pixels_per_call"]))
        self.offset = run.seed % render_frames.OFFSET_SPAN
        self.kept = []
        self.harness_s = 0.0
        self.out = None
        self.call()  # warm-up: the build, the plan, the calibration
        self.out = None

    def _reference(self, samples, dtype):
        # the scene as the benchmark's own loader reads and subdivides it
        arrays = reference.build(self.run.cfg, self.run.traffic,
                                 self.run.root)
        return reference.pixels(arrays, samples, self.ref_jitter,
                                self.run.device, dtype)
