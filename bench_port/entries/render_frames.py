"""Render window: one client calls ``render_scene_frames`` again as soon as
its last call has been synchronised.  Each call renders the traffic's
``frames_per_call`` frames at the next sample indices, so no frame is
rendered twice; the seed sets the first sample index.

What the check compares: ``check_pixels_per_call`` pixels of each call's
frames, drawn from the seed, gathered on the card once the call has
synchronised (one gather launch a call, timed in ``harness_s``), and
traced again by the reference once the window has closed.
"""

from __future__ import annotations

import time

import torch

from .. import program
from ..reference import render_frames as reference
from ..reference import scene as ref_scene

POOL = 64  # index sets drawn in set-up; call i keeps set i % POOL
OFFSET_SPAN = 2 ** 30  # first sample indices; the kernels take int32


class Entry:
    unit = "frame"

    def __init__(self, run):
        from raytracinginonesemester_tpu_torch.render import renderer

        self.run = run
        t = run.traffic
        self.renderer = renderer
        self.frames = int(t["frames_per_call"])
        self.jitter = t["jitter"]
        # "auto" is "wang" in the gpu dialect (render/renderer.py)
        self.ref_jitter = "wang" if self.jitter == "auto" else self.jitter
        self.scene = program.build_scene(run.cfg, t, run.root, run.device)
        cam = run.cfg["camera"]
        self.w, self.h = int(cam["pixel_width"]), int(cam["pixel_height"])
        self.pool = self._pool(run, run.keep_pixels
                               or int(t["check_pixels_per_call"]))
        self.offset = run.seed % OFFSET_SPAN
        self.kept = []
        self.harness_s = 0.0
        self.out = None
        self.call()  # warm-up: the build, the plan, the calibration
        self.out = None

    def _pool(self, run, keep: int) -> torch.Tensor:
        """POOL index sets of ``keep`` pixels of a call's frames, drawn
        from the seed on the card: half over the whole frames, half over
        the configuration's ``check_box`` (x0, y0, x1, y1 inclusive: the
        pixels that the scene's triangles project to, where the work is;
        the frog covers a few percent of its frame), or the whole frame."""
        gen = torch.Generator(device=run.device)
        gen.manual_seed(run.seed)
        x0, y0, x1, y1 = run.cfg.get("check_box",
                                     (0, 0, self.w - 1, self.h - 1))

        def draw(hi):
            return torch.randint(0, hi, (POOL, keep - keep // 2),
                                 generator=gen, device=run.device)

        whole = draw(self.frames * self.h * self.w)[:, :keep // 2]
        f, x, y = (draw(self.frames), draw(x1 - x0 + 1) + x0,
                   draw(y1 - y0 + 1) + y0)
        return torch.cat([whole, (f * self.h + y) * self.w + x], dim=1)

    def call(self) -> int:
        self.first = self.offset
        self.out = self.renderer.render_scene_frames(
            self.scene, self.frames, jitter_mode=self.jitter,
            sample_offset=self.offset)
        self.offset += self.frames
        return self.frames

    def keep(self, i: int) -> None:
        h0 = time.perf_counter()
        idx = self.pool[i % POOL]
        self.kept.append((self.first, idx, self.out.reshape(-1, 3)[idx]))
        self.out = None
        self.harness_s += time.perf_counter() - h0

    def release(self) -> None:
        self.scene = self.out = None

    def samples(self):
        """(sample index, x, y) int64 (N, 3) and the program's radiance
        (N, 3) of every kept pixel, on the host."""
        rows, vals = [], []
        for first, idx, v in self.kept:
            idx = idx.cpu()
            f, rem = idx // (self.h * self.w), idx % (self.h * self.w)
            rows.append(torch.stack([first + f, rem % self.w, rem // self.w], 1))
            vals.append(v.float().cpu())
        return torch.cat(rows).long(), torch.cat(vals)

    def _reference(self, samples, dtype):
        # the scene as the benchmark's own loader reads it
        arrays = ref_scene.build(self.run.cfg, self.run.traffic, self.run.root)
        return reference.pixels(arrays, samples, self.ref_jitter,
                                self.run.device, dtype)

    def check(self, dtype=torch.float32) -> dict:
        samples, got = self.samples()
        return reference.compare(got, self._reference(samples, dtype))

    def control(self, dtype=torch.bfloat16) -> dict:
        samples, _ = self.samples()
        return reference.compare(self._reference(samples, dtype),
                                 self._reference(samples, torch.float32))
