"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises (exit != 0):

1. the card: ``nvidia-smi`` name and power limit, CUDA and nvcc versions;
2. build the CUDA kernels from ``raytracinginonesemester_tpu_torch/csrc``
   (ptxas registers and spills of every kernel);
3. each kernel against its plain PyTorch version on the card at 128x64:
   gpu dialect on the two-frog test scene at block sizes 128 and 512
   (emit flat and binned, bounce_step, resume, render flat and binned,
   terminal and full loop); cpuonly dialect on ``cpuonly_mirror.json``
   and an area-light variant with diffuse bounces (emit, bounce_step,
   resume, render); binned emit against flat emit (here and at 1080p),
   and binned emit at a chunk width of 126 (its staging's plain copies);
   the staged integrator's closest-hit kernel E (with gpu normals and two
   lights' fused shadows, ``shared_origin`` on and off; without normals,
   the cpuonly case) and occlusion kernel F (camera, bounce and shadow
   rays with per-ray windows, parked rays included, and bounce rays with
   NaN windows, none of which may come out blocked), two-frog 128x64 at
   block sizes 128 and 512;
4. reference images: the two-frog 128x64 render on the staged wavefront
   and with ``RT_WAVEFRONT=0`` (kernel D) against the JAX package's
   ``tests/goldens/torch_two_frog_128x64.npy``, the terminal two-frog
   render (D) against ``torch_two_frog_terminal_128x64.npy`` (both made
   by ``scripts/make_torch_golden.py``), and ``cpuonly_point.json`` and
   ``cpuonly_mirror.json`` at 160x100 against the C++ oracle's PNGs
   (at most one step per channel); then through the staged integrator
   (E and F): ``gpu_spheres``, ``gpu_diffuse``, ``gpu_frog`` and
   ``gpu_cornell`` with ``jitter_mode="reference_cpu"`` at their JSON
   sizes against the C++ oracle's ``tests/goldens/gpu_*.png``
   (``assert_images_close``'s rule), and ``cpuonly_point.json`` with 17
   shadow samples (F 17 times per light and bounce) within one step of
   its PNG;
5. the main path: frog 1920x1080, depth 8, diffuse bounces,
   ``render_scene_frames`` with 16 frames at the calibrated capacity,
   with the binned camera plan (its build time and size logged) and
   then with ``RT_BINNED=0``; frames compared.  Counted and timed apart
   (ms/frame, median of 3): one frame at a capacity of 8 tiles, which
   overflows into the resume kernel, ``images_close`` to frame 0 of the
   calibrated binned run (its max abs difference logged);
6. kernel D at full width: frog 1080p terminal (diffuse off, depth 4),
   16 frames, and the headline with ``RT_WAVEFRONT=0``, one 16-frame
   call;
7. the cpuonly dialect at full width: ``cpuonly_mirror.json`` at
   1920x1080 through whatever the dispatch picks, then with
   ``RT_WAVEFRONT=0`` (kernel D), and one frame at a capacity of 8
   tiles (resume), timed and compared with frame 0 of the first run as
   phase 5's is;
8. the staged integrator at full width, 4 frames per call through
   ``render_scene_frames``: the frog 1920x1080 (depth 8, diffuse) with
   ``jitter_mode="reference_cpu"`` (E every depth; F never, the gpu
   dialect fuses its shadows into E), and ``cpuonly_mirror.json`` at
   1920x1080 with its light at radius 0.15, 32 shadow samples and
   diffuse bounces (E and F);
9. the differentiable training path, ``bench.py --grad``'s workload:
   ``gpu_spheres.json`` at 960x540 with its camera, spp 1, 2 bounces,
   ``center`` jitter, a block grid with ``differentiable=True``, albedo,
   light intensity and vertices perturbed by 5% (``RandomState(0)``),
   Adam at lr 1e-3, 8 steps per call, the binned depth-0 plan at slack
   0.05: kernel B's oracle rows (flat and binned) against their plain
   version at 128x64 and at 960x540 (depths 0 and 1), a warm call and 3
   timed calls (ms/step, backward rays/s), the launches of one call
   (bounce_step's oracle variant 2 per step, segment_accum at least 1,
   closest and occluded 0), finite and nonzero gradients, bit-identical
   gradients from two identical steps, one step with the oracle off
   (kernels E and F) within 5e-2 of the oracle's gradients, kernel J on
   the inputs of its first launch in a training step bit for bit against
   its plain version and within 1e-5 of each bin's sum of |ct| against
   ``index_add_``, and the albedo recovery of ``tests/test_diff.py``
   (96x54, 60 Adam steps at lr 0.03) below 5% of the first loss;
10. the large-scene streamed path, ``bench.py --large 1000000``'s
   workload: the frog at 1920x1080 (spp 1, depth 8, diffuse, ``wang``)
   with its mesh subdivided 3 levels (1,270,912 triangles), the block
   grid at 512 lanes (2,483 blocks, over the plane budget: the fused
   kernels refuse it).  On the pixel-center camera rays (``bench.py:
   204-207``) G's winners against E's and H's against G's; on their
   shadow rays to the frog's light as the integrator spawns them (the
   missed rays' shade points parked at 1e30 with a zero direction, in
   the same tiles as the hits'), H's flags against I's and no parked ray
   blocked; on the hits' shadow rays alone, I's flags against F's and
   against I's full-width flags, exactly; one frame through
   ``render_scene_frames`` (G and
   I must launch, E, F, H and A-D must not; ms/frame median of 3 calls),
   the same frame with ``RT_STREAM_BLOCKMAJOR`` on (H; the frame must be
   the G/I frame bit for bit), and, off the dispatch, the same frame
   through kernels A and B (``render_tiles_wavefront_frames``, timed,
   ``images_close`` to the G/I frame); the host seconds of the
   subdivision, the grid build and the camera rays' plan;
11. each kernel against its plain version at its full-width shapes, both
   timed, with the least time the card could take (bound); E and F on
   the inputs of their first launches in single-frame renders of phase
   8's scenes, A's shadow walk apart (F on the facing shadow rays of the
   headline's binned emit, as its plain version walks them), J on those
   of phase 9 (also its glue, the sort that plans
   the runs and chunks, and its kernels on that plan, each timed alone),
   G, I and H on phase 10's camera
   and full-width shadow rays (each with its glue -- the rays' rows, G's
   and I's plan or H's gate, the tile order -- and the kernel alone on
   operands built once, each timed apart, and the tests and tested
   blocks of its own walk beside the JAX walk's that the bound counts; a
   CTA of theirs that stops has also copied up to two blocks it does not
   test), and E and F
   on the large scene too
   (E on the camera rays, F on the hits' shadow rays);
12. the TPU probes of ``scripts/`` (``raytracinginonesemester_tpu_torch/
   probes``, ``csrc/probes.cu``), on no render or training path (their
   launch counters, set to 0 before phase 5 and read after phase 10,
   must read 0): the probes' own run, each wrapper once through its
   entry point with the counters set to 0 just before and read just
   after (every probe must launch) -- P1 ``toy_mask`` in its three modes
   on the script's inputs and on a seeded hazard set (zero directions,
   NaN distances), P2 ``sel7`` and ``mm22`` and P3 ``dyn12`` and
   ``blk1`` on their scripts' inputs, all at the scripts' full widths;
   then each bit for bit against its plain version, timed as in phase
   11 (``mm22``'s bound at the card's bf16 tensor rate), and
   ``torch.matmul`` of ``mm22``'s stacked picks by qsel timed beside it
   (the product alone).

Every render of phases 4-8 and 10 runs with the launch counters set to 0
just before it and read just after; a kernel of that render that did not
run fails the script, and so does a kernel that must not run there;
phase 9's training call likewise.  The line before the last is the JSON
record of the kernels (emit, bounce_step, resume, render, closest,
occluded, segment_accum, closest_streamed, occluded_streamed,
closest_blockmajor, occluded_blockmajor, toy_mask, sel7, mm22, dyn12,
blk1; each with the launches of the run named in ``launches_in``, the
probes' from their own run in phase 12); the line before it holds the
variants (flat emit, terminal
render, cpuonly, E on bounce rays, A's shadow walk, B's oracle rows flat
and binned, E and F on the large scene, P1's other modes and hazard
set).  The last
line is ``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits non-zero before printing any
result.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# tolerance of the kernel-vs-plain comparisons (both are built without FMA
# contraction and with IEEE div/sqrt; powf and sqrtf may differ from
# torch's by an ulp): float rows within 4 ulp or 1e-5 abs, alive and rng
# rows exact
ULPS, ATOL = 4, 1e-5
FRAMES = 16
W, H = 1920, 1080
DEVICE = "cuda"
REPLACES = {
    "emit": "raytracinginonesemester_tpu/ops/megakernel.py:2108",
    "bounce_step": "raytracinginonesemester_tpu/ops/megakernel.py:2560",
    "resume": "raytracinginonesemester_tpu/ops/megakernel.py:2253",
    "render": "raytracinginonesemester_tpu/ops/megakernel.py:1536",
    "closest": "raytracinginonesemester_tpu/ops/pallas_kernels.py:222",
    "occluded": "raytracinginonesemester_tpu/ops/pallas_kernels.py:688",
    "segment_accum": "raytracinginonesemester_tpu/ops/diff_gather.py:46",
    "closest_streamed": "raytracinginonesemester_tpu/ops/pallas_kernels.py:994",
    "occluded_streamed":
        "raytracinginonesemester_tpu/ops/pallas_kernels.py:1425",
    "closest_blockmajor":
        "raytracinginonesemester_tpu/ops/pallas_kernels.py:1230",
    "occluded_blockmajor":
        "raytracinginonesemester_tpu/ops/pallas_kernels.py:1230",
    "toy_mask": "scripts/probe_toy_mask.py:23",
    "sel7": "scripts/probe_mm_select.py:41",
    "mm22": "scripts/probe_mm_select.py:56",
    "dyn12": "scripts/probe_dyn_reads.py:26",
    "blk1": "scripts/probe_dyn_reads.py:38",
}
PROBES = ["toy_mask", "sel7", "mm22", "dyn12", "blk1"]
PROBE_RUN = ("probes' own run (phase 12): each wrapper once on its script's "
             "inputs, P1 in 3 modes on 2 input sets")
SOURCE = "raytracinginonesemester_tpu_torch/csrc/megakernel.cu"
STREAM_SOURCE = "raytracinginonesemester_tpu_torch/csrc/block_stream.cu"
SOURCES = {"segment_accum":
           "raytracinginonesemester_tpu_torch/csrc/segment_accum.cu",
           "closest_streamed": STREAM_SOURCE,
           "occluded_streamed": STREAM_SOURCE,
           "closest_blockmajor": STREAM_SOURCE,
           "occluded_blockmajor": STREAM_SOURCE,
           **dict.fromkeys(PROBES,
                           "raytracinginonesemester_tpu_torch/csrc/probes.cu")}
STREAMED = ["closest_streamed", "occluded_streamed"]
BLOCKMAJOR = ["closest_blockmajor", "occluded_blockmajor"]
# bench.py --large 1000000: the frog mesh subdivided until >= 1e6
# triangles, 19,858 x 4^3 = 1,270,912 (bench.py:183-186)
LARGE_LEVELS = 3
FUSED = ["emit", "bounce_step", "resume", "render"]
STAGED_FRAMES = 4
FLT_EPSILON = 1.1920929e-7  # the cpuonly dialect's Moller-Trumbore epsilon
# the bound: FP32 arithmetic of one Moller-Trumbore test (megakernel.cu
# mt(): 46 adds, multiplies and the one divide; compares not counted)
# times the tests the kernel makes on this run's inputs (live lanes only,
# shadow walks up to their first hit; counted by the plain version's
# ``stats``) over the card's 67 TFLOP/s, against each input byte read
# once and each output byte written once over 3.35 TB/s (H100 SXM data
# sheet)
OPS_PER_PAIR = 46
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
PEAK_BF16 = 989e12  # dense bf16 tensor-core rate (mm22's product)
SCENES = os.path.join(REPO, "tests", "assets", "scenes")
# the training phase: bench.py --grad (bench.py:47-87)
GRAD_W, GRAD_H, GRAD_STEPS = 960, 540, 8
GRAD_KEYS = ("albedo", "light_intensity", "vertices")


def log(msg):
    print(msg, flush=True)


def images_close(ours, ref, max_bad_frac=2e-3, max_mean=0.5):
    """The rule of ``tests/conftest.py:assert_images_close`` on uint8
    images: at most 0.2% of channels off by more than one step, mean
    difference at most half a step."""
    import numpy as np

    diff = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
    bad, mean = float((diff > 1).mean()), float(diff.mean())
    return bad <= max_bad_frac and mean <= max_mean, bad, mean


def ulp_bad(a, b):
    import torch

    a64, b64 = a.double(), b.double()
    mag = torch.maximum(a.abs(), b.abs())
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    tol = torch.maximum(torch.full_like(a64, ATOL), ULPS * ulp.double())
    return int(((a64 - b64).abs() > tol).sum()), float((a64 - b64).abs().max())


def check_state(errs, name, where, st_k, rng_k, st_p, rng_p):
    """Kernel state vs plain state: alive and rng rows exact, float rows
    within tolerance; raises on any difference."""
    nt = st_k.shape[0] // 16
    a = st_k.reshape(nt, 16, -1)
    b = st_p.reshape(nt, 16, -1)
    alive = int((a[:, 12] != b[:, 12]).sum())
    rng = int((rng_k != rng_p).sum())
    rows = [ulp_bad(a[:, r], b[:, r]) for r in range(16)]
    beyond = sum(n for n, _ in rows)
    worst = max(m for _, m in rows)
    log(f"compare {name} {where}: alive mismatches {alive}, rng mismatches "
        f"{rng}, float rows beyond tol {beyond}, max_abs {worst:.3e}")
    errs[name] = max(errs.get(name, 0.0), worst)
    if alive or rng or beyond:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version ({where})")


def check_sums(errs, name, where, got, want):
    """Per-ray radiance (r, g, b) of a kernel vs its plain version."""
    got = [g.reshape(-1) for g in got]
    want = [w.reshape(-1) for w in want]
    res = [ulp_bad(g, w) for g, w in zip(got, want)]
    beyond = sum(n for n, _ in res)
    worst = max(m for _, m in res)
    log(f"compare {name} {where}: radiance beyond tol {beyond}, "
        f"max_abs {worst:.3e}")
    errs[name] = max(errs.get(name, 0.0), worst)
    if beyond:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version ({where})")


def check_binned_equiv(where, flat, binned):
    """Binned emit vs flat emit (the JAX contract): alive flags and
    radiance rows everywhere, and every alive lane's whole state and rng,
    bit for bit (the lanes of an empty-plan tile carry the canonical dead
    state, which only the radiance and alive rows are read from)."""
    nt = flat[0].shape[0] // 16
    a, b = flat[0].reshape(nt, 16, -1), binned[0].reshape(nt, 16, -1)
    alive = a[:, 12] > 0.0
    bad = sum(int((a[:, r] != b[:, r]).sum()) for r in (9, 10, 11, 12))
    bad += sum(int(((a[:, r] != b[:, r]) & alive).sum()) for r in range(13))
    ra, rb = flat[1].reshape(nt, 8, -1)[:, 0], binned[1].reshape(nt, 8, -1)[:, 0]
    bad += int(((ra != rb) & alive).sum())
    log(f"compare emit binned vs flat {where}: {int(alive.sum())} alive "
        f"lanes, differing values {bad}")
    if bad:
        raise AssertionError(f"binned emit differs from flat emit ({where})")


def check_hits(errs, name, where, got, want):
    """A closest-hit kernel's (hits[, normal, vis]) or an occlusion
    kernel's blocked flags vs its plain version (or vs another kernel of
    the same function): winner ids, hit flags, visibility and blocked
    flags exact; t, u, v and the normal within tolerance."""
    from raytracinginonesemester_tpu_torch.ops.intersect import HitData

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    exact, floats = [], []
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, HitData):
            exact += [(g.tri_idx, w.tri_idx), (g.hit, w.hit)]
            floats += [(g.t, w.t), (g.u, w.u), (g.v, w.v)]
        elif i == 1:
            floats.append((g, w))  # the shading normal
        else:
            exact.append((g, w))  # visibility or blocked flags
    mismatches = sum(int((g != w).sum()) for g, w in exact)
    res = [ulp_bad(g, w) for g, w in floats]
    beyond = sum(n for n, _ in res)
    worst = max((m for _, m in res), default=0.0)
    first = got[0]
    if isinstance(first, HitData):
        shown = f"{int(first.hit.sum())} of {first.hit.numel()} rays hit"
    else:
        shown = f"{int(first.sum())} of {first.numel()} rays blocked"
    log(f"compare {name} {where}: {shown}; exact fields mismatches "
        f"{mismatches}, floats beyond tol {beyond}, max_abs {worst:.3e}")
    errs[name] = max(errs.get(name, 0.0), worst)
    if mismatches or beyond:
        raise AssertionError(f"{name}: the results disagree ({where})")


def two_frog(width, height, block_size, device, diffuse=True):
    os.environ["RT_BLOCK_SIZE"] = str(block_size)
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from _torch_parity import two_frog_config

    cfg = two_frog_config(SceneConfig, SceneNodeConfig, Transform,
                          width=width, height=height, max_bounces=3,
                          diffuse_bounce=diffuse)
    scene = build_scene(cfg, device=device)
    os.environ.pop("RT_BLOCK_SIZE")
    return scene


def cpuonly_scene(name, device, width=None, height=None, **light):
    """A cpuonly JSON scene, optionally at another size or with its light
    changed (``radius``, ``shadow_samples``) and ``diffuse_bounce``."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        load_scene_config)

    path = os.path.join(SCENES, f"{name}.json")
    cfg = load_scene_config(path)
    if width:
        cfg = dataclasses.replace(cfg, pixel_width=width, pixel_height=height)
    if "diffuse_bounce" in light:
        cfg = dataclasses.replace(cfg, diffuse_bounce=light.pop("diffuse_bounce"))
    if light:
        cfg = dataclasses.replace(cfg, lights=[{**l, **light} for l in cfg.lights])
    return build_scene(cfg, scene_path=path, device=device)


class Frame:
    """One scene at one resolution: the padded tile stream, both depth-0
    plans and the keyword arguments of its kernels and plain versions."""

    def __init__(self, scene, jitter="wang", chunk=256):
        import torch

        from raytracinginonesemester_tpu_torch.ops import binned
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk
        from raytracinginonesemester_tpu_torch.render.renderer import (
            _swizzled_grid)

        self.scene = scene
        dev = scene.device
        xs, ys, _ = _swizzled_grid(scene.camera.width, scene.camera.height,
                                   device=dev)
        self.xs, self.ys, _, self.np_rays = mk._pad_tiles(xs, ys)
        self.nt = self.np_rays // mk.RAY_TILE
        self.rows = mk._scene_rows(scene, scene.accel)
        self.plan = mk.camera_tile_plan(scene.camera, self.xs, self.ys,
                                        scene.accel)
        t0 = time.time()
        self.cand = binned.build_camera_candidate_plan(
            scene.camera, self.xs, self.ys, scene.accel, mk.RAY_TILE,
            chunk=chunk)
        torch.cuda.synchronize()
        self.plan_s = time.time() - t0
        self.kw = mk.megakernel_kwargs(scene, jitter)
        self.kw.setdefault("jitter", jitter)
        self.cpuonly = scene.dialect == "cpuonly"
        self.pkw = dict(det_eps=self.kw.get("det_eps", 1e-8),
                        shadow_eps=self.kw.get("shadow_eps", 1e-3),
                        shadow_tmin=self.kw.get("shadow_tmin", 1e-4),
                        dialect=scene.dialect,
                        shadow_samples=self.kw.get("shadow_samples", 1))
        self.terminal = (bool(scene.terminal_only)
                         and not scene.diffuse_bounce and not self.cpuonly)

    def no_jitter(self):
        return {k: v for k, v in self.kw.items() if k != "jitter"}

    def has_work(self, binned):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        sh = mk._Shade(bool(self.scene.diffuse_bounce),
                       dialect=self.scene.dialect,
                       shadow_samples=self.pkw["shadow_samples"])
        return mk._has_work(self.scene, self.xs, self.ys, sh, self.plan,
                            self.cand if binned else None)

    def emit(self, binned, offset=0):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        return mk.emit_tiles(self.scene, self.xs, self.ys, offset,
                             plan=self.plan,
                             cand_plan=self.cand if binned else None,
                             rows=self.rows, **self.kw)

    def emit_plain(self, binned, offset=0, stats=None):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        return mk.emit_tiles_plain(
            self.rows, self.xs, self.ys, self.has_work(binned), offset,
            self.scene.diffuse_bounce, jitter=self.kw["jitter"],
            cand_plan=self.cand if binned else None, stats=stats,
            **self.pkw)

    def sorted_state(self, st, rng):
        import torch

        from raytracinginonesemester_tpu_torch.ops.wavefront import (
            sort_bounce_state)

        grid = self.scene.accel
        lo = [grid.aabb[c].amin() for c in range(3)]
        span = [torch.clamp(grid.aabb[3 + c].amax() - lo[c], min=1e-20)
                for c in range(3)]
        pix = torch.arange(self.np_rays, device=st.device)
        return sort_bounce_state(st, rng, pix, lo, span)

    def bounce(self, st, rng):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        return mk.bounce_step_tiles(self.scene, st, rng, rows=self.rows,
                                    **self.no_jitter())

    def bounce_plain(self, st, rng, stats=None):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        return mk.bounce_step_tiles_plain(self.rows, st, rng,
                                          self.scene.diffuse_bounce,
                                          stats=stats, **self.pkw)

    def resume(self, st, rng):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        return mk.resume_tiles(self.scene, st, rng, rows=self.rows,
                               **self.no_jitter())

    def resume_plain(self, st, rng, stats=None):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        return mk.resume_tiles_plain(self.rows, st, rng,
                                     self.scene.max_bounces,
                                     self.scene.diffuse_bounce, stats=stats,
                                     **self.pkw)

    def render(self, binned, spp=1, offset=0):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        out = mk.render_tiles(self.scene, self.xs, self.ys, spp, offset,
                              plan=self.plan,
                              cand_plan=self.cand if binned else None,
                              rows=self.rows, **self.kw)
        return out.unbind(1)

    def render_plain(self, binned, spp=1, offset=0, stats=None):
        from raytracinginonesemester_tpu_torch.ops import megakernel as mk

        return mk.render_tiles_plain(
            self.rows, self.xs, self.ys, self.has_work(binned), spp, offset,
            self.scene.max_bounces, self.terminal, self.scene.diffuse_bounce,
            jitter=self.kw["jitter"], cand_plan=self.cand if binned else None,
            stats=stats, **self.pkw)

    def scene_bytes(self, binned):
        r = self.rows
        n = sum(t.numel() * t.element_size() for t in (
            r.cam, r.lights, r.mats, r.tri, r.norm, r.ids, r.obj, r.aabb))
        if binned:
            n += (self.cand.stream.numel() * 4 + self.cand.meta.numel() * 4)
        return n


def check_small(dev, errs):
    """Phase 3: every kernel vs its plain version at 128x64."""
    import torch

    for bs in (128, 512):
        for diffuse in (True, False):
            f = Frame(two_frog(128, 64, bs, dev, diffuse=diffuse), chunk=128)
            where = f"128x64 block={bs} {'V2' if diffuse else 'terminal'}"
            emits = []
            for binned in (False, True):
                tag = f"{where} {'binned' if binned else 'flat'}"
                if diffuse:
                    emits.append(f.emit(binned))
                    check_state(errs, "emit", tag, *emits[-1],
                                *f.emit_plain(binned))
                got = f.render(binned, spp=2, offset=3)
                torch.cuda.synchronize()
                check_sums(errs, "render", f"{tag} spp=2",
                           got, [c.reshape(-1)[:got[0].numel()]
                                 for c in f.render_plain(binned, 2, 3)])
            if not diffuse:
                continue
            check_binned_equiv(where, *emits)
            # a chunk width that is not a multiple of 4: emit stages its
            # chunks with plain copies and ends each with single tests
            odd = Frame(f.scene, chunk=126)
            check_state(errs, "emit", f"{where} binned, chunk 126",
                        *odd.emit(True), *odd.emit_plain(True))
            st, rng = f.emit(False)
            st_s, rng_s, _ = f.sorted_state(st, rng)
            check_state(errs, "bounce_step", where, *f.bounce(st_s, rng_s),
                        *f.bounce_plain(st_s, rng_s))
            check_sums(errs, "resume", where, f.resume(st_s, rng_s),
                       f.resume_plain(st_s, rng_s))

    variants = {"cpuonly point mirror": ({}, "center", 1),
                "cpuonly area r=0.15 x4, diffuse": (
                    dict(radius=0.15, shadow_samples=4, diffuse_bounce=True),
                    "wang", 2)}
    for where, (light, jitter, spp) in variants.items():
        f = Frame(cpuonly_scene("cpuonly_mirror", dev, 128, 64, **light),
                  jitter=jitter, chunk=128)
        emits = []
        for binned in (False, True):
            emits.append(f.emit(binned))
            check_state(errs, "emit", f"{where} {binned=}", *emits[-1],
                        *f.emit_plain(binned))
        check_binned_equiv(where, *emits)
        st, rng = emits[1]
        st_s, rng_s, _ = f.sorted_state(st, rng)
        check_state(errs, "bounce_step", where, *f.bounce(st_s, rng_s),
                    *f.bounce_plain(st_s, rng_s))
        check_sums(errs, "resume", where, f.resume(st_s, rng_s),
                   f.resume_plain(st_s, rng_s))
        got = f.render(True, spp=spp, offset=1)
        check_sums(errs, "render", f"{where} binned spp={spp}", got,
                   [c.reshape(-1)[:got[0].numel()]
                    for c in f.render_plain(True, spp, 1)])


def emit_shadow_rays(frame, binned):
    """The facing shadow rays of ``frame``'s depth-0 pass, as its plain
    version walks them: [(origins, directions, tmin, tmax)] a light (and
    disk sample), the rays that face the light only."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    walks, real = [], mk._occluded_plain

    def recorded(rows, p, ld, dist, facing, det_eps, tmin, tmax=None):
        sel = facing.nonzero().squeeze(1)
        walks.append((torch.stack(p, 1)[sel].contiguous(),
                      torch.stack(ld, 1)[sel].contiguous(), float(tmin),
                      (dist if tmax is None else tmax)[sel].contiguous()))
        return real(rows, p, ld, dist, facing, det_eps, tmin, tmax)

    mk._occluded_plain = recorded
    try:
        frame.emit_plain(binned)
    finally:
        mk._occluded_plain = real
    return walks


def camera_rays(scene):
    """The camera rays of sample 0 with ``jitter_mode="reference_cpu"``
    (one mt19937(42) offset for every pixel), in the swizzled pixel
    order of the renderer."""
    import torch

    from raytracinginonesemester_tpu_torch.core.rng import jittered_samples
    from raytracinginonesemester_tpu_torch.render.renderer import (
        _swizzled_grid)

    cam = scene.camera
    xs, ys, _ = _swizzled_grid(cam.width, cam.height, device=scene.device)
    jx, jy = (float(v) for v in jittered_samples(1, 42, True)[0])
    o, d = cam.get_rays(xs.to(torch.float32) + jx, ys.to(torch.float32) + jy)
    return o.contiguous(), d.contiguous()


def block_rays(scene, seed=7):
    """Ray sets of kernels E and F on ``scene``'s device: the camera rays,
    seeded random bounce rays in the grid's box with the last eighth
    parked at 1e30 (half of those with every direction component
    negative, so their slab tests pass and the triangles decide), and
    seeded per-ray [tmin, tmax] windows."""
    import numpy as np
    import torch

    co, cd = camera_rays(scene)
    r = co.shape[0]
    rng = np.random.default_rng(seed)
    box = scene.accel.aabb.cpu().numpy()
    lo, hi = box[:3].min(axis=1), box[3:].max(axis=1)
    bo = (lo + rng.uniform(0, 1, (r, 3)) * (hi - lo)).astype(np.float32)
    bd = rng.normal(size=(r, 3)).astype(np.float32)
    k = r // 8
    bd[-k // 2:] = -np.abs(bd[-k // 2:])
    bd = (bd / np.linalg.norm(bd, axis=1, keepdims=True)).astype(np.float32)
    bo[-k:] = 1e30
    tmin = rng.uniform(0.0, 0.02, r).astype(np.float32)
    tmax = rng.uniform(0.05, 1.0, r).astype(np.float32)

    def dev(a):
        return torch.from_numpy(a).to(scene.device)

    return dict(camera=(co, cd), bounce=(dev(bo), dev(bd)),
                window=(dev(tmin), dev(tmax)))


def shadow_rays(o, d, hits, normal, light, eps=1e-3):
    """Shadow rays of E's hits toward ``light`` as the gpu dialect spawns
    them (``p = o + t d + n eps`` on [1e-4, dist]); missed rays' shade
    points parked at 1e30 (their dist is inf, their direction 0)."""
    import torch

    p = torch.where(hits.hit[:, None], o + hits.t[:, None] * d + normal * eps,
                    1e30)
    to = light - p
    dist = torch.sqrt((to * to).sum(dim=1))
    sd = to / torch.clamp(dist, min=1e-20)[:, None]
    return p, sd, torch.full_like(dist, 1e-4), dist


def _fields(out):
    """Every tensor of a ``block_closest`` result, in order."""
    out = out if isinstance(out, tuple) else (out,)
    h = out[0]
    return (h.t, h.u, h.v, h.tri_idx, h.hit) + out[1:]


def check_block_small(dev, errs):
    """Phase 3, staged integrator: kernels E and F vs their plain versions
    at 128x64."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk

    for bs in (128, 512):
        scene = two_frog(128, 64, bs, dev)
        grid, lights = scene.accel, scene.lights.position
        rays = block_rays(scene)
        co, cd = rays["camera"]
        where = f"128x64 block={bs}"
        fused = {}
        for shared in (False, True):
            kw = dict(return_normal=True, shadow_lights=lights,
                      shared_origin=shared)
            fused[shared] = bk.block_closest(co, cd, grid, 1e-4, **kw)
            check_hits(errs, "closest", f"{where} camera rays, normals, "
                       f"{lights.shape[0]} lights, shared_origin={shared}",
                       fused[shared],
                       bk.block_closest_plain(co, cd, grid, 1e-4, **kw))
        if not all(torch.equal(a, b) for a, b in zip(_fields(fused[False]),
                                                      _fields(fused[True]))):
            raise AssertionError("closest: shared_origin changed the results")
        for key in ("camera", "bounce"):
            o, d = rays[key]
            got = bk.block_closest(o, d, grid, 1e-4, det_eps=FLT_EPSILON)
            check_hits(errs, "closest", f"{where} {key} rays, no normals "
                       "(cpuonly)", got,
                       bk.block_closest_plain(o, d, grid, 1e-4,
                                              det_eps=FLT_EPSILON))
            if key == "bounce" and bool(got.hit[o[:, 0] >= 1e29].any()):
                raise AssertionError("closest: a parked ray hit")
        hits, normal, _ = fused[False]
        tmin, tmax = (w.clone() for w in rays["window"])
        tmax[::7], tmin[::11] = float("nan"), float("nan")
        sets = {"camera": (co, cd, *rays["window"]),
                "bounce": (*rays["bounce"], *rays["window"]),
                "bounce, NaN windows": (*rays["bounce"], tmin, tmax),
                "shadow": shadow_rays(co, cd, hits, normal, lights[0])}
        for key, (o, d, tmin, tmax) in sets.items():
            got = bk.block_occluded(o, d, grid, tmin, tmax)
            check_hits(errs, "occluded", f"{where} {key} rays, per-ray "
                       "[tmin, tmax]", got,
                       bk.block_occluded_plain(o, d, grid, tmin, tmax))
            if bool(got[o[:, 0] >= 1e29].any()):
                raise AssertionError("occluded: a parked ray came out blocked")
            if key.endswith("NaN windows") and bool(got[::7].any()
                                                    or got[::11].any()):
                raise AssertionError("occluded: a NaN window came out "
                                     "blocked")


def record_calls(module, names, fn, keep=2):
    """Run ``fn`` with ``module``'s functions ``names`` wrapped to record
    the arguments of their first ``keep`` calls -> {name: [(args,
    kwargs)]}."""
    seen = {n: [] for n in names}
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def recorded(*a, **k):
            if len(seen[n]) < keep:
                seen[n].append((a, k))
            return real[n](*a, **k)
        return recorded

    for n in names:
        w = wrap(n)
        # share the attributes (a wrapper's launch counter lives there)
        w.__dict__ = real[n].__dict__
        setattr(module, n, w)
    try:
        fn()
    finally:
        for n in names:
            setattr(module, n, real[n])
    return seen


def _sync():
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def counted(label, fn, need, never=()):
    """Run ``fn`` with the launch counters set to 0 just before it and
    read just after; every kernel in ``need`` must have launched, and
    none in ``never``."""
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    mk.reset_launch_counts()
    bk.reset_launch_counts()
    dg.reset_launch_counts()
    out = fn()
    _sync()
    counts = {**mk.launch_counts(), **mk.variant_launch_counts(),
              **bk.launch_counts(), **dg.launch_counts()}
    log(f"launch counts, {label}: {counts}")
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched ({counts})")
    extra = [k for k in never if counts[k]]
    if extra:
        raise AssertionError(f"{label}: {extra} launched, but this render "
                             f"must not take them ({counts})")
    return out, counts


def check_goldens(dev):
    """Phase 4: the card's renders against the reference images."""
    import numpy as np

    from raytracinginonesemester_tpu_torch.io.image import quantize, read_png
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene, render_scene_frames)

    goldens = os.path.join(REPO, "tests", "goldens")
    # (file, diffuse, RT_WAVEFRONT, capacity, kernels that must run): the
    # staged wavefront at the golden's own capacity of 8 tiles, then D
    cases = [("torch_two_frog_128x64.npy", True, "auto", 8,
              ["emit", "bounce_step"]),
             ("torch_two_frog_128x64.npy", True, "0", None, ["render"]),
             ("torch_two_frog_terminal_128x64.npy", False, "auto", None,
              ["render"])]
    for name, diffuse, wf, cap, need in cases:
        ref = np.load(os.path.join(goldens, name))
        os.environ["RT_WAVEFRONT"] = wf
        scene = two_frog(128, 64, 512, dev, diffuse=diffuse)
        img, _ = counted(f"golden {name} RT_WAVEFRONT={wf} cap={cap}",
                         lambda: render_scene_frames(scene, ref.shape[0],
                                                     "wang", 0,
                                                     capacity_tiles=cap),
                         need)
        img = img.cpu().numpy()
        for f in range(ref.shape[0]):
            ok, bad, mean = images_close(quantize(img[f], "gpu"),
                                         quantize(ref[f], "gpu"))
            log(f"golden {name} RT_WAVEFRONT={wf} frame {f}: bad_frac "
                f"{bad:.5f} mean {mean:.4f} max_abs "
                f"{np.abs(img[f] - ref[f]).max():.3e}")
            if not ok:
                raise AssertionError(f"card render disagrees with {name}")
    os.environ.pop("RT_WAVEFRONT")
    for name in ("cpuonly_point", "cpuonly_mirror"):
        scene = cpuonly_scene(name, dev)
        img, _ = counted(f"golden {name}.png", lambda: render_scene(scene),
                         [])
        ours = quantize(img.cpu().numpy(), "cpuonly").astype(int)
        gold = read_png(os.path.join(goldens, f"{name}.png")).astype(int)
        diff = np.abs(ours - gold)
        log(f"golden {name}.png (C++ oracle) 160x100: max channel diff "
            f"{diff.max()}, channels off {(diff > 0).mean():.5f}")
        if ours.shape != gold.shape or diff.max() > 1:
            raise AssertionError(f"{name} disagrees with the C++ oracle")
    check_staged_goldens(dev, goldens)


def check_staged_goldens(dev, goldens):
    """Phase 4, staged integrator: renders that only E and F may serve,
    against the C++ oracle's PNGs."""
    from raytracinginonesemester_tpu_torch.io.image import quantize, read_png
    from raytracinginonesemester_tpu_torch.render.renderer import render_scene
    from raytracinginonesemester_tpu_torch.scene.build import load_scene

    for name in ("gpu_spheres", "gpu_diffuse", "gpu_frog", "gpu_cornell"):
        scene = load_scene(os.path.join(SCENES, f"{name}.json"), device=dev)
        w, h = scene.camera.width, scene.camera.height
        img, _ = counted(f"golden {name}.png, reference_cpu (staged)",
                         lambda: render_scene(scene, "reference_cpu"),
                         ["closest"], never=FUSED + ["occluded"])
        ours = quantize(img.cpu().numpy(), "gpu")
        ok, bad, mean = images_close(
            ours, read_png(os.path.join(goldens, f"{name}.png")))
        log(f"golden {name}.png (C++ oracle) {w}x{h}, spp {scene.spp}, "
            f"depth {scene.max_bounces}, through the staged integrator: "
            f"bad_frac {bad:.5f} mean {mean:.4f}")
        if not ok:
            raise AssertionError(f"staged {name} disagrees with the C++ oracle")
    scene = cpuonly_scene("cpuonly_point", dev, radius=0.0, shadow_samples=17)
    img, _ = counted("golden cpuonly_point.png, 17 shadow samples (staged)",
                     lambda: render_scene(scene), ["closest", "occluded"],
                     never=FUSED)
    ours = quantize(img.cpu().numpy(), "cpuonly").astype(int)
    gold = read_png(os.path.join(goldens, "cpuonly_point.png")).astype(int)
    diff = abs(ours - gold)
    log(f"golden cpuonly_point.png (C++ oracle) 160x100, 17 shadow samples, "
        f"through the staged integrator: max channel diff {diff.max()}, "
        f"channels off {(diff > 0).mean():.5f}")
    if ours.shape != gold.shape or diff.max() > 1:
        raise AssertionError("staged cpuonly_point disagrees with the C++ "
                             "oracle")


def timed_frames(label, scene, frames, smi, need, iters=3, jitter="auto",
                 never=()):
    """Warm-up call, then ``iters`` timed calls counted as one run."""
    import torch

    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene_frames)
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    render_scene_frames(scene, frames, jitter, 0)
    torch.cuda.synchronize()

    def run():
        t = cuda_time_ms(lambda: render_scene_frames(scene, frames, jitter, 0),
                         warmup=0, iters=iters)
        return t, render_scene_frames(scene, frames, jitter, 0)

    (t, img), counts = counted(f"{label} ({iters + 1} calls of {frames} "
                               "frames)", run, need, never)
    ms = t["median_ms"] / frames
    w, h = scene.camera.width, scene.camera.height
    log(f"{label}: {frames} frames {w}x{h}: {ms:.3f} ms/frame, "
        f"{w * h / (ms / 1e3):.4e} rays/s (median of {iters} CUDA-event "
        f"timings, samples {[round(s, 2) for s in t['samples_ms']]} ms) "
        f"on {smi}")
    if tuple(img.shape) != (frames, h, w, 3) or \
            not bool(torch.isfinite(img).all()) or bool(img.amax() <= 0.0):
        raise AssertionError(f"{label}: output not finite, black or of the "
                             "wrong shape")
    return ms, img, counts


def timed_overflow(label, scene, smi, jitter, ref, iters=3):
    """One frame at a capacity of 8 tiles, which overflows into the
    resume kernel: a warm-up call, then ``iters`` timed calls counted as
    one run; the frame must pass ``images_close`` against ``ref``, frame
    0 of the calibrated run on the same arguments."""
    import torch

    from raytracinginonesemester_tpu_torch.io.image import quantize
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene_frames)
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    def render():
        return render_scene_frames(scene, 1, jitter, 0, capacity_tiles=8)

    render()
    torch.cuda.synchronize()

    def run():
        return cuda_time_ms(render, warmup=0, iters=iters), render()

    (t, img), counts = counted(f"{label} ({iters + 1} calls of 1 frame at "
                               "cap=8)", run, ["resume"])
    if not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: not finite")
    ours, want = img[0].cpu().numpy(), ref.cpu().numpy()
    ok, bad, mean = images_close(quantize(ours, scene.dialect),
                                 quantize(want, scene.dialect))
    ms = t["median_ms"]
    log(f"{label}: 1 frame at cap=8: {ms:.3f} ms/frame (median of {iters} "
        f"CUDA-event timings, samples "
        f"{[round(x, 2) for x in t['samples_ms']]} ms) on {smi}; vs frame 0 "
        f"of the calibrated run: bad_frac {bad:.5f} mean {mean:.4f} max abs "
        f"diff {float(abs(ours - want).max()):.3e}")
    if not ok:
        raise AssertionError(f"{label}: the overflow frame is not close to "
                             "the calibrated run's")
    return ms, counts


def time_kernels(smi, errs, jobs):
    """Phase 8: each job's kernel against its plain version on the same
    inputs, both timed; the bound from the ray-triangle pairs the kernel
    tests on these inputs (the plain version counts them) and the bytes
    the function moves."""
    import torch

    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    records = {}
    for key, job in jobs.items():
        name, shape, kern, plain, check, nbytes = job[:6]
        library = job[6] if len(job) > 6 else None
        parts = job[7] if len(job) > 7 else {}  # {record key: call}
        got = kern()
        stats = {}
        want = plain(stats)
        torch.cuda.synchronize()
        if callable(nbytes):  # bytes that depend on the walk (stats)
            nbytes = nbytes(stats)
        # FP32 operations: Moller-Trumbore pairs, or the count the plain
        # version states itself (kernel J: one add per ray and feature)
        pairs = stats.get("pairs", 0)
        ops = stats.get("ops", pairs * OPS_PER_PAIR)
        bf16_ops = stats.get("bf16_ops", 0)  # on the tensor cores
        check(errs, name, f"{key} at {shape}", got, want)
        del got, want
        # G's, I's and H's own walk, where it tests other amounts than the
        # JAX kernel's walk that the bound counts (the blocks it tests; a
        # CTA that stops has also copied up to two it does not test)
        walk = {k: stats[k] for k in ("walk_pairs", "walk_tested_blocks")
                if k in stats}
        k = cuda_time_ms(kern, warmup=1, iters=3)
        p = cuda_time_ms(plain, warmup=0, iters=1)
        lib = (cuda_time_ms(library, warmup=1, iters=3)["median_ms"]
               if library else None)
        part_ms = {k: cuda_time_ms(f, warmup=1, iters=3)["median_ms"]
                   for k, f in parts.items()}
        t_ops = max(ops / PEAK_FLOPS, bf16_ops / PEAK_BF16) * 1e3
        t_bytes = nbytes / PEAK_BYTES * 1e3
        bound = max(t_ops, t_bytes)
        by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"time {key} at {shape}: kernel {k['median_ms']:.3f} ms (median "
            f"of 3), plain {p['median_ms']:.1f} ms (1 run)"
            + (f", library {lib:.3f} ms" if library else "")
            + "".join(f", {k} {v:.4f}" for k, v in part_ms.items())
            + f"; bound {bound:.4f} ms by {by} ({pairs} ray-primitive pairs, "
            f"{ops} FP32 operations, "
            + (f"{bf16_ops} bf16 tensor operations, " if bf16_ops else "")
            + f"{nbytes} bytes"
            + "".join(f"; the CUDA walk's {k} {v}" for k, v in walk.items())
            + f") on {smi}")
        records[key] = {"name": name, "route": "cuda",
                        "source": SOURCES.get(name, SOURCE),
                        "replaces": REPLACES[name], "shape": shape,
                        "ms": k["median_ms"], "plain_ms": p["median_ms"],
                        "bound_ms": bound, "bound_by": by,
                        "library_ms": lib, "pairs": pairs}
        records[key].update(part_ms)
        records[key].update(walk)
    return records


def check_diff(errs, name, where, got, want):
    """Kernel B with its oracle rows vs its plain version: every row of
    the state, the rng and the (nt*8, 512) oracle rows bit for bit."""
    rows = int((got[2] != want[2]).sum())
    nt = got[2].shape[0] // 8
    dec = want[2].reshape(nt, 8, -1)[:, 5]
    log(f"compare {name} oracle rows {where}: {int((dec > 0).sum())} rays "
        f"found, differing oracle values {rows}")
    check_state(errs, name, where, got[0], got[1], want[0], want[1])
    state = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
    if rows or state:
        raise AssertionError(f"{name} with oracle rows differs from its plain "
                             f"version ({where}): {rows} oracle values, "
                             f"{state} state values")


def center_rays(scene):
    """Pixel-center camera rays and rng seeds of sample 0 in the
    renderer's swizzled pixel order (``jitter_mode="center"``)."""
    import torch

    from raytracinginonesemester_tpu_torch.core.rng import make_rng_seed
    from raytracinginonesemester_tpu_torch.render.renderer import (
        _swizzled_grid)

    cam = scene.camera
    xs, ys, _ = _swizzled_grid(cam.width, cam.height, device=scene.device)
    o, d = cam.get_rays(xs.to(torch.float32) + 0.5, ys.to(torch.float32) + 0.5)
    return o.contiguous(), d.contiguous(), make_rng_seed(xs, ys, 0)


def grad_scene(dev, width=GRAD_W, height=GRAD_H):
    """``bench.py --grad``'s scene (``bench.py:53-66``): gpu_spheres.json,
    its camera, 2 bounces, spp 1, a differentiable block grid."""
    from raytracinginonesemester_tpu_torch.core.camera import Camera
    from raytracinginonesemester_tpu_torch.scene.build import load_scene

    scene = load_scene(os.path.join(SCENES, "gpu_spheres.json"), device=dev)
    cam = Camera.create(position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5),
                        up=(0, 0, 1), focal_length_mm=24.0, width=width,
                        height=height, device=dev)
    return dataclasses.replace(scene, camera=cam, max_bounces=2, spp=1,
                               differentiable=True)


class Training:
    """The grad bench's training loop on one scene: the target (the
    render with the scene's own parameters), the perturbed start
    parameters (``bench.py:70-77``), the scene they give and the binned
    depth-0 context built for it."""

    def __init__(self, scene, keys=GRAD_KEYS, slack=0.05):
        import numpy as np
        import torch

        from raytracinginonesemester_tpu_torch.diff import inverse

        self.scene = scene
        self.inv = inverse
        with torch.no_grad():
            self.target = inverse.render_scene(scene, "center",
                                               spp_override=1)
        rs = np.random.RandomState(0)
        self.p0 = {}
        for k, v in inverse.extract_params(scene, keys).items():
            v = v.detach().cpu().numpy()
            self.p0[k] = v * (1.0 + 0.05 * rs.standard_normal(v.shape)
                              .astype(np.float32))
        self.start = inverse.apply_params(
            scene, inverse.params_from_numpy(self.p0, scene))
        t0 = time.time()
        self.ctx = inverse.camera_candidate_context(self.start, slack=slack)
        _sync()
        self.plan_s = time.time() - t0

    def params(self):
        return self.inv.params_from_numpy(self.p0, self.scene)

    def call(self, steps=GRAD_STEPS, lr=1e-3):
        """One call of ``steps`` Adam steps from the start parameters ->
        (losses (steps,), params)."""
        import torch

        params = self.params()
        step = self.inv.make_train_step(torch.optim.Adam(
            list(params.values()), lr=lr))
        with self.ctx:
            losses = [step(params, self.scene, self.target)
                      for _ in range(steps)]
        return torch.stack(losses), params

    def grads(self):
        """Loss and gradients at the start parameters (one step's)."""
        params = self.params()
        with self.ctx:
            loss = self.inv.render_loss(params, self.scene, self.target,
                                        "center", 1)
            loss.backward()
        return loss.detach(), {k: v.grad for k, v in params.items()}


def check_diff_small(dev, errs):
    """Phase 9: kernel B's oracle rows vs its plain version at 128x64,
    flat and binned, on the two-frog scene's pixel-center camera rays."""
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.ops.diff_oracle import pack_rays

    for bs in (128, 512):
        f = Frame(two_frog(128, 64, bs, dev), chunk=128)
        st, rng = pack_rays(*center_rays(f.scene))
        for binned in (False, True):
            cand = f.cand if binned else None
            got = mk.bounce_step_tiles(f.scene, st, rng, diff_out=True,
                                       cand_plan=cand, rows=f.rows,
                                       **f.no_jitter())
            want = mk.bounce_step_tiles_plain(
                f.rows, st, rng, f.scene.diffuse_bounce, diff_out=True,
                cand_plan=cand, **f.pkw)
            check_diff(errs, "bounce_step", f"128x64 block={bs} "
                       f"{'binned' if binned else 'flat'}", got, want)


def grads_close(label, got, want, rel):
    """Every gradient within ``rel`` of the largest entry of ``want``."""
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        log(f"{label}: grad {k} max |diff| {err:.3e}, max |g| {scale:.3e}")
        if not err <= rel * scale:
            raise AssertionError(f"{label}: grad {k} beyond {rel} of max |g|")


def check_training(dev, smi):
    """Phase 9: the differentiable training path at full width."""
    import numpy as np
    import torch

    from raytracinginonesemester_tpu_torch.diff import inverse
    from raytracinginonesemester_tpu_torch.ops import binned
    from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    t0 = time.time()
    scene = grad_scene(dev)
    tr = Training(scene)
    _sync()
    log(f"grad bench scene: {scene.geometry.num_triangles} triangles, "
        f"{scene.accel.num_blocks} blocks of {scene.accel.block_size}, "
        f"{GRAD_W}x{GRAD_H}; set-up {time.time() - t0:.2f} s; binned plan "
        f"(slack 0.05) {tr.plan_s:.3f} s, "
        f"{binned.candidate_plan_stats(tr.ctx.plan, 512)}")
    t0 = time.time()
    losses, _ = tr.call()
    _sync()
    log(f"training warm call ({GRAD_STEPS} Adam steps): {time.time() - t0:.2f}"
        f" s, losses {[round(float(x), 6) for x in losses]}")
    j_calls = record_calls(dg, ["segment_accum_rows"], tr.grads,
                           keep=16)["segment_accum_rows"]
    n_vert = scene.geometry.vertices.shape[0]
    log(f"segment_accum launches of one step: "
        f"{[(int(c[0][2]), tuple(c[0][1].shape)) for c in j_calls]} "
        "(rows, cotangent shape)")
    t = cuda_time_ms(tr.call, warmup=0, iters=3)
    ms_step = t["median_ms"] / GRAD_STEPS
    rays = GRAD_W * GRAD_H
    log(f"training, grad-bench config: {ms_step:.3f} ms/step, "
        f"{rays / (ms_step / 1e3):.4e} backward rays/s ({GRAD_STEPS} steps "
        f"per call, median of 3 CUDA-event timings, calls "
        f"{[round(x, 2) for x in t['samples_ms']]} ms) on {smi}")
    (losses, params), counts = counted(
        f"training call ({GRAD_STEPS} Adam steps)", tr.call,
        ["bounce_step", "segment_accum"],
        never=["emit", "resume", "render", "closest", "occluded"])
    want = {"bounce_step": 2 * GRAD_STEPS, "bounce_step[diff]": 2 * GRAD_STEPS,
            "bounce_step[binned]": GRAD_STEPS}
    if any(counts[k] != v for k, v in want.items()) or \
            counts["segment_accum"] < GRAD_STEPS:
        raise AssertionError(f"training call launches {counts}, expected "
                             f"{want} and segment_accum >= {GRAD_STEPS}")
    if not bool(torch.isfinite(losses).all()):
        raise AssertionError("training loss not finite")
    if not all(bool(torch.isfinite(p).all()) for p in params.values()):
        raise AssertionError("trained parameters not finite")

    l1, g1 = tr.grads()
    l2, g2 = tr.grads()
    for k, g in g1.items():
        if not bool(torch.isfinite(g).all()) or not bool((g != 0).any()):
            raise AssertionError(f"gradient of {k} not finite or all zero")
    same = all(torch.equal(g1[k], g2[k]) for k in g1) and torch.equal(l1, l2)
    log(f"two identical steps: loss {float(l1):.8f}, gradients "
        f"{'bit-identical' if same else 'DIFFER'} "
        f"({', '.join(f'{k} {tuple(g.shape)}' for k, g in g1.items())})")
    if not same:
        raise AssertionError("two identical steps gave different gradients")

    integrator._DIFF_ORACLE = False
    try:
        (l3, g3), off_counts = counted(
            "one step, RT_DIFF_ORACLE=0 (kernels E and F)", tr.grads,
            ["closest", "occluded", "segment_accum"], never=["bounce_step"])
    finally:
        integrator._DIFF_ORACLE = True
    log(f"RT_DIFF_ORACLE=0: loss {float(l3):.8f} vs oracle {float(l1):.8f}")
    grads_close("oracle vs RT_DIFF_ORACLE=0", g1, g3, 5e-2)

    small = grad_scene(dev, 96, 54)
    with torch.no_grad():
        target = inverse.render_scene(small, "center", spp_override=1)
    true = small.materials.albedo.cpu().numpy()
    rs = np.random.RandomState(1)
    init = np.clip(true + rs.uniform(-0.25, 0.25, true.shape), 0.05,
                   1.0).astype(np.float32)
    t0 = time.time()
    _, rec = inverse.optimize(small, target, keys=("albedo",), steps=60,
                              learning_rate=0.03, spp_override=1,
                              init_params={"albedo": torch.from_numpy(init)
                                           .to(dev)})
    log(f"albedo recovery 96x54, 60 Adam steps at lr 0.03 through the "
        f"oracle: loss {rec[0]:.6e} -> {rec[-1]:.6e} "
        f"({rec[-1] / rec[0]:.4f} of the first) in {time.time() - t0:.1f} s")
    if not rec[-1] < 0.05 * rec[0]:
        raise AssertionError("albedo recovery did not reach 5% of the "
                             "first loss")
    return dict(ms_step=ms_step, counts=counts, off_counts=off_counts,
                tr=tr, j_call=j_calls[0],
                j_vertex_call=next(c for c in j_calls if c[0][2] == n_vert))


def diff_jobs(train):
    """Phase 10 jobs of the training path: kernel B's oracle rows at
    960x540 (depth 0 binned and flat, depth 1 flat) and kernel J on the
    inputs of its first launch in a training step."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.ops.diff_oracle import pack_rays

    tr = train["tr"]
    start = tr.start
    with torch.no_grad():
        rows = mk._scene_rows(start, start.accel)
    plan = tr.ctx.plan
    st0, rng0 = pack_rays(*center_rays(start))
    nt = st0.shape[0] // 16
    st1, rng1, _ = mk.bounce_step_tiles(start, st0, rng0, diff_out=True,
                                        cand_plan=plan, rows=rows)
    scene_b = sum(t.numel() * t.element_size() for t in (
        rows.cam, rows.lights, rows.mats, rows.tri, rows.norm, rows.ids,
        rows.obj, rows.aabb))
    plan_b = (plan.stream.numel() + plan.meta.numel()) * 4
    ray_b = 224  # state and rng in and out, oracle rows out

    def b_job(st, rng, cand, shape):
        return ("bounce_step", shape,
                lambda: mk.bounce_step_tiles(start, st, rng, diff_out=True,
                                             cand_plan=cand, rows=rows),
                lambda x=None: mk.bounce_step_tiles_plain(
                    rows, st, rng, start.diffuse_bounce, diff_out=True,
                    cand_plan=cand, stats=x),
                check_diff,
                nt * 512 * ray_b + scene_b + (plan_b if cand else 0))

    def j_job(call, what):
        (idx, ct, n_rows), _ = call
        r, f = ct.shape

        def j_plain(stats=None):
            if stats is not None:
                stats["ops"] = r * f  # one add per ray and feature
            return dg.segment_accum_rows_plain(idx, ct, n_rows)

        keep = (idx >= 0) & (idx < n_rows)
        i_lib, ct_lib = idx[keep].long(), ct[keep]
        plan = dg.segment_plan(idx, n_rows)

        def library():
            return torch.zeros(n_rows, f, device=ct.device).index_add_(
                0, i_lib, ct_lib)

        return ("segment_accum",
                f"{r} rays x {f} features into {n_rows} rows ({what})",
                lambda: dg.segment_accum_rows(idx, ct, n_rows), j_plain,
                check_accum, r * 4 + r * f * 4 + n_rows * f * 4, library,
                {"glue_ms": lambda: dg.segment_plan(idx, n_rows),
                 "kernel_only_ms": lambda: dg.segment_accum_planned(
                     ct, plan, n_rows)})

    return {
        "bounce_step diff binned": b_job(
            st0, rng0, plan, f"{nt} tiles x 512, grad depth 0, binned"),
        "bounce_step diff flat": b_job(
            st0, rng0, None, f"{nt} tiles x 512, grad depth 0, flat"),
        "bounce_step diff": b_job(
            st1, rng1, None, f"{nt} tiles x 512, grad depth 1, flat"),
        "segment_accum": j_job(train["j_call"], "the first launch of a "
                               "training step"),
        "segment_accum vertices": j_job(train["j_vertex_call"],
                                        "the vertex table"),
    }


def check_accum(errs, name, where, got, want):
    """Kernel J vs its plain version: bit for bit."""
    bad = int((got != want).sum())
    log(f"compare {name} {where}: differing sums {bad}, max_abs "
        f"{float((got - want).abs().max()):.3e}")
    errs[name] = max(errs.get(name, 0.0), float((got - want).abs().max()))
    if bad:
        raise AssertionError(f"{name} kernel disagrees with its plain version "
                             f"({where})")


def check_accum_library(call):
    """Kernel J vs ``index_add_`` (float atomics, any order) and both vs a
    float64 sum.  Each sum within 1e-5 of its bin's sum of |ct|, or, for
    a bin whose run is long enough that float32 rounding reaches that,
    within 2 gamma_(n-1) of it (gamma_k = k u / (1 - k u), u = 2^-24: the
    error bound of any order of recursive summation, so of both sums),
    plus n 2^-126 (a float atomic add flushes a subnormal result to zero;
    the kernel keeps subnormals, within 2^-149 an add); J within
    gamma_(n-1) of the float64 sum plus n 2^-149 (J's fixed tree is one
    such order)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import diff_gather as dg

    (idx, ct, n_rows), _ = call
    got = dg.segment_accum_rows(idx, ct, n_rows)
    keep = (idx >= 0) & (idx < n_rows)
    i = idx[keep].long()
    lib = torch.zeros_like(got).index_add_(0, i, ct[keep])
    exact = torch.zeros(got.shape, dtype=torch.float64, device=got.device
                        ).index_add_(0, i, ct[keep].double())
    scale = torch.zeros_like(exact).index_add_(0, i, ct[keep].abs().double())
    counts = torch.bincount(i, minlength=n_rows)
    k = (counts - 1).clamp(min=0).double()[:, None] * 2.0 ** -24
    gamma = k / (1.0 - k)
    n = counts.double()[:, None]
    err = (got.double() - lib.double()).abs()
    beyond_1e5 = int((err > 1e-5 * scale).sum())
    tiny = int((scale < n * 2.0 ** -126).sum())
    bad = int((err > torch.maximum(1e-5 * scale, 2 * gamma * scale)
               + n * 2.0 ** -126).sum())
    j_err = (got.double() - exact).abs()
    bad += int((j_err > gamma * scale + n * 2.0 ** -149).sum())
    rel = lambda e: float((e / scale.clamp(min=1e-300)).max())
    log(f"compare segment_accum vs index_add_ on {tuple(ct.shape)} into "
        f"{n_rows} rows: max |diff| {float(err.max()):.3e}, "
        f"{beyond_1e5} of {err.numel()} sums beyond 1e-5 of sum |ct| "
        f"({tiny} of them at sum |ct| below n 2^-126), {bad} beyond the "
        f"rounding bound; vs a float64 sum, relative to "
        f"sum |ct|: kernel {rel(j_err):.3e}, index_add_ "
        f"{rel((lib.double() - exact).abs()):.3e}; longest run "
        f"{int(counts.max())} rays (bin {int(counts.argmax())}), empty bins "
        f"{int((counts == 0).sum())}")
    if bad:
        raise AssertionError("segment_accum disagrees with index_add_")


def large_scene(dev):
    """``bench.py --large 1000000``'s scene (``bench.py:153-200``): the
    frog at 1920x1080, spp 1, depth 8, diffuse, its mesh subdivided
    ``LARGE_LEVELS`` times, the block grid rebuilt at 512 lanes -> (scene,
    subdivision s, grid build s), each on the host clock after a
    synchronise."""
    from raytracinginonesemester_tpu_torch.ops.accel import build_block_grid
    from raytracinginonesemester_tpu_torch.render.renderer import frog_scene
    from raytracinginonesemester_tpu_torch.scene.subdivide import (
        subdivide_geometry)

    scene = frog_scene(W, H, device=dev)
    t0 = time.time()
    geom = subdivide_geometry(scene.geometry, LARGE_LEVELS)
    _sync()
    t_sub = time.time() - t0
    t0 = time.time()
    grid = build_block_grid(geom.vertices, geom.num_triangles,
                            block_size=512, normals=geom.normals,
                            obj_ids=geom.obj_id)
    _sync()
    t_grid = time.time() - t0
    return (dataclasses.replace(scene, geometry=geom, accel=grid), t_sub,
            t_grid)


def large_rays(scene):
    """``bench.py:204-207``: the pixel-center camera rays in scanline
    order."""
    import torch

    dev = scene.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    o, d = scene.camera.get_rays(xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5)
    return o.contiguous(), d.contiguous()


def check_large(dev, smi):
    """Phase 10: the large-scene streamed path (module docstring) ->
    (frame times, launch counts, phase 11's jobs)."""
    import torch

    from raytracinginonesemester_tpu_torch.io.image import quantize
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.ops.accel import (
        tile_visit_plan_fast)
    from raytracinginonesemester_tpu_torch.ops.megakernel import (
        RAY_TILE, megakernel_ineligible_reason)
    from raytracinginonesemester_tpu_torch.ops.wavefront import (
        auto_capacity_tiles, render_tiles_wavefront_frames)
    from raytracinginonesemester_tpu_torch.render import renderer as tr
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    scene, t_sub, t_grid = large_scene(dev)
    grid = scene.accel
    reason = megakernel_ineligible_reason(scene, "wang")
    log(f"large scene (bench.py --large 1000000): "
        f"{scene.geometry.num_triangles} triangles ({LARGE_LEVELS} levels), "
        f"{grid.num_blocks} blocks of {grid.block_size} in "
        f"{-(-grid.num_blocks // 8)} superblocks; subdivision {t_sub:.3f} s "
        f"(host numpy), block grid {t_grid:.3f} s; plane bytes "
        f"{bk._grid_bytes(*grid.tri_index.shape)}, fits_vmem "
        f"{bk.fits_vmem(grid)}, num_chunks_for {bk.num_chunks_for(grid)}; "
        f"fused kernels: {reason}")
    if bk.fits_vmem(grid) or reason is None:
        raise AssertionError("the large scene must be over the plane budget")

    o, d = large_rays(scene)
    t0 = time.time()
    rays, rp = bk._prep_rays(o, d, 1e-4, bk.F32_MAX)
    order, _, count = tile_visit_plan_fast(rays[:, 0:3], rays[:, 3:6], grid,
                                           rays[:, 6], rays[:, 7], RAY_TILE)
    _sync()
    t_plan = time.time() - t0
    nt, ls = (int(n) for n in order.shape)
    log(f"camera rays' tile visit plan: {nt} tiles x {ls} superblocks, built "
        f"in {t_plan:.4f} s; superblocks per tile mean "
        f"{float(count.float().mean()):.1f}, max {int(count.max())}, tiles "
        f"with none {int((count == 0).sum())}")

    # kernel against kernel, by check_hits' rule (ids and flags exact)
    pair = {}
    g = bk.block_closest_streamed(o, d, grid, 1e-4)
    e, normal = bk.block_closest(o, d, grid, 1e-4, return_normal=True)
    check_hits(pair, "G vs E", "1080p camera rays", g, e)
    check_hits(pair, "H (closest) vs G", "1080p camera rays",
               bk.block_closest_blockmajor(o, d, grid, 1e-4), g)
    # the shadow rays as shade_direct gives them to I on the main path:
    # every camera ray's, the missed rays' shade points parked at 1e30
    # (direction 0, window [1e-4, inf]) in the same tiles as the hits'
    light = scene.lights.position[0]
    sh = shadow_rays(o, d, g, normal, light)
    parked = ~g.hit
    if bool((sh[1][parked] != 0.0).any()):
        raise AssertionError("a parked shade point's shadow ray moves")
    blocked_all = bk.block_occluded_streamed(sh[0], sh[1], grid, *sh[2:])
    check_hits(pair, "H (occluded) vs I", f"{W * H} shadow rays, parked "
               "ones included", bk.block_occluded_blockmajor(
                   sh[0], sh[1], grid, *sh[2:]), blocked_all)
    if bool(blocked_all[parked].any()):
        raise AssertionError("I: a parked shadow ray came out blocked")
    # F on the hits' shadow rays only: a parked ray passes every slab test
    # of F, as in the JAX package, and would test all 1.27M triangles
    p, sd, smin, dist = (x[g.hit].contiguous() for x in sh)
    blocked = bk.block_occluded_streamed(p, sd, grid, smin, dist)
    check_hits(pair, "I vs F", "the hits' shadow rays to the frog light",
               blocked, bk.block_occluded(p, sd, grid, smin, dist))
    if not torch.equal(blocked, blocked_all[g.hit]):
        raise AssertionError("I: the hits' flags change with the parked "
                             "lanes beside them")
    del e, normal, blocked, blocked_all

    label = "large frog 1080p depth 8"
    others = FUSED + ["closest", "occluded"]
    ms_gi, img_gi, gi_counts = timed_frames(
        f"{label} (G and I)", scene, 1, smi, STREAMED, jitter="wang",
        never=others + BLOCKMAJOR)
    integrator._STREAM_BLOCKMAJOR = True
    try:
        ms_h, img_h, h_counts = timed_frames(
            f"{label}, RT_STREAM_BLOCKMAJOR=1 (H)", scene, 1, smi,
            BLOCKMAJOR, iters=1, jitter="wang", never=others + STREAMED)
    finally:
        integrator._STREAM_BLOCKMAJOR = False
    n_diff = int((img_h != img_gi).any(dim=-1).sum())
    log(f"H frame vs G/I frame: differing pixels {n_diff} of {W * H}")
    if n_diff:
        raise AssertionError("the H frame differs from the G/I frame")

    # off the dispatch, for comparison: the same frame through A and B
    kw = tr._kernel_kwargs(scene, "wang")
    cap = auto_capacity_tiles(scene, **kw) or nt
    xs_s, ys_s, (hp, wp) = tr._swizzled_grid(W, H, device=dev)

    def ab():
        acc = render_tiles_wavefront_frames(scene, xs_s, ys_s, 1, 0,
                                            capacity_tiles=cap, **kw)
        return tr._unswizzle(acc, W, H, hp, wp)

    img_ab = ab()
    t_ab, ab_counts = counted(
        f"{label} through A and B off the dispatch (cap={cap})",
        lambda: cuda_time_ms(ab, warmup=0, iters=3),
        ["emit", "bounce_step"], never=["closest", "occluded"] + STREAMED
        + BLOCKMAJOR)
    ms_ab = t_ab["median_ms"]
    ok, bad, mean = images_close(quantize(img_ab[0].cpu().numpy(), "gpu"),
                                 quantize(img_gi[0].cpu().numpy(), "gpu"))
    log(f"{label} through A and B (flat scan, off the dispatch): {ms_ab:.3f} "
        f"ms/frame (median of 3 CUDA-event timings, samples "
        f"{[round(x, 2) for x in t_ab['samples_ms']]}) vs G/I {ms_gi:.3f} "
        f"and H {ms_h:.3f} ms/frame on {smi}; A/B frame vs G/I frame: "
        f"bad_frac {bad:.5f} mean {mean:.4f}")
    if not ok:
        raise AssertionError("the A/B frame is not close to the G/I frame")

    # phase 11's jobs: the bytes each kernel moves are its ray rows, its
    # plan or gate, its outputs and every block it stages (10 rows of 512
    # floats, once per tile that stages it; the plain version counts them)
    blk = 10 * grid.block_size * 4
    plan_b = nt * ls * 8 + grid.num_blocks * 32
    planes_b = 4 * (grid.tri.numel() + grid.tri_index.numel()
                    + grid.aabb.numel())
    n_sh = int(p.shape[0])
    chunks = -(-rp // (bk.BM_CHUNK_TILES * RAY_TILE))
    gate_b = chunks * (-(-grid.num_blocks // bk.BM_SLAB_BLOCKS)) * 4

    def g_job(name, rays_in, n_out, extra, kern, plain, shape, parts=None):
        tiles = -(-rays_in // (8 * RAY_TILE)) * 8
        if "blockmajor" in name:
            tiles = -(-tiles // bk.BM_CHUNK_TILES) * bk.BM_CHUNK_TILES
        return (name, shape, kern,
                lambda x=None: plain(stats=x), check_hits,
                lambda st: extra + st["staged_blocks"] * blk
                + tiles * RAY_TILE * (32 + n_out), None, parts or {})

    # G, I and H apart: the glue (the rays' rows, the plan or the gate,
    # the tile order; the planes are packed once a grid) and the kernel
    # alone on operands built once
    def streamed_parts(*args):
        return {"glue_ms": lambda: bk._streamed_launch(*args),
                "kernel_only_ms": bk._streamed_launch(*args)}

    def blockmajor_parts(*args):
        args += (bk.BM_CHUNK_TILES, bk.BM_SLAB_BLOCKS)
        return {"glue_ms": lambda: bk._blockmajor_launch(*args),
                "kernel_only_ms": bk._blockmajor_launch(*args)}

    cam = f"{W * H} camera rays (pixel centers), {nt} tiles"
    shadow = (f"{W * H} shadow rays to the frog light, {n_sh} of them the "
              "hits', the rest parked")
    hit_shadow = f"{n_sh} shadow rays of the hits to the frog light"
    so, sdir = sh[0], sh[1]
    jobs = {
        "large closest_streamed": g_job(
            "closest_streamed", W * H, 16, plan_b,
            lambda: bk.block_closest_streamed(o, d, grid, 1e-4),
            lambda stats: bk.block_closest_streamed_plain(
                o, d, grid, 1e-4, stats=stats), cam,
            streamed_parts(o, d, grid, 1e-4, bk.F32_MAX, 1e-8, False)),
        "large occluded_streamed": g_job(
            "occluded_streamed", W * H, 1, plan_b,
            lambda: bk.block_occluded_streamed(so, sdir, grid, *sh[2:]),
            lambda stats: bk.block_occluded_streamed_plain(
                so, sdir, grid, *sh[2:], stats=stats), shadow,
            streamed_parts(so, sdir, grid, *sh[2:], 1e-8, True)),
        "large closest_blockmajor": g_job(
            "closest_blockmajor", W * H, 16, gate_b,
            lambda: bk.block_closest_blockmajor(o, d, grid, 1e-4),
            lambda stats: bk.block_closest_blockmajor_plain(
                o, d, grid, 1e-4, stats=stats), cam,
            blockmajor_parts(o, d, grid, 1e-4, bk.F32_MAX, 1e-8, False)),
        "large occluded_blockmajor": g_job(
            "occluded_blockmajor", W * H, 1, gate_b,
            lambda: bk.block_occluded_blockmajor(so, sdir, grid, *sh[2:]),
            lambda stats: bk.block_occluded_blockmajor_plain(
                so, sdir, grid, *sh[2:], stats=stats), shadow,
            blockmajor_parts(so, sdir, grid, *sh[2:], 1e-8, True)),
        # E and F on the same function's inputs, beside G and I
        "large closest": (
            "closest", cam, lambda: bk.block_closest(o, d, grid, 1e-4),
            lambda x=None: bk.block_closest_plain(o, d, grid, 1e-4, stats=x),
            check_hits, W * H * (24 + 4 + 16) + planes_b),
        "large occluded": (
            "occluded", hit_shadow,
            lambda: bk.block_occluded(p, sd, grid, smin, dist),
            lambda x=None: bk.block_occluded_plain(p, sd, grid, smin, dist,
                                                   stats=x),
            check_hits, n_sh * (24 + 8 + 1) + planes_b),
    }
    return dict(ms_gi=ms_gi, ms_h=ms_h, ms_ab=ms_ab, gi_counts=gi_counts,
                h_counts=h_counts, ab_counts=ab_counts, jobs=jobs,
                host_s=dict(subdivide=t_sub, grid=t_grid, plan=t_plan))


def check_exact(errs, name, where, got, want):
    """A probe kernel vs its plain version: every float's bits equal, or
    both NaN."""
    import torch

    nan = got.isnan() & want.isnan()
    bad = int(((got.view(torch.int32) != want.view(torch.int32)) & ~nan).sum())
    err = float((got - want).abs().nan_to_num(0.0).max())
    log(f"compare {name} {where}: differing values {bad} of {got.numel()} "
        f"({int(nan.sum())} NaN on both sides), max_abs {err:.3e}")
    errs[name] = max(errs.get(name, 0.0), err)
    if bad:
        raise AssertionError(f"{name} kernel disagrees with its plain version "
                             f"({where})")


def probe_jobs(dev):
    """Phase 12 jobs: the TPU probes P1-P3 at their scripts' full widths
    (``probes/``), P1 also on its seeded hazard set.  Bytes: each input
    the function reads (sel7: q's 7 rows it selects from) and each output,
    once."""
    from raytracinginonesemester_tpu_torch.probes import dyn_reads as dr
    from raytracinginonesemester_tpu_torch.probes import mm_select as ms
    from raytracinginonesemester_tpu_torch.probes import toy_mask as tm

    jobs = {}
    for tag, (rays, aabb) in (("", tm.script_inputs(dev)),
                              (" hazards", tm.hazard_inputs(0, dev))):
        for mode in tm.MODES:
            jobs[f"toy_mask {mode}{tag}"] = (
                "toy_mask", f"{mode}, (64, 512) rays x (156, 8) boxes"
                + (", seeded hazards" if tag else ", all ones"),
                lambda m=mode, r=rays, a=aabb: tm.toy_mask(m, r, a),
                lambda x=None, m=mode, r=rays, a=aabb: tm.toy_mask_plain(
                    m, r, a, stats=x),
                check_exact, 4 * (2 * rays.numel() + aabb.numel()))
    win, q, qsel = ms.script_inputs(dev)
    rt, lanes = win.shape[0], q.shape[1]
    jobs["sel7"] = (
        "sel7", f"{ms.VISITS} visits, {rt} rays x {lanes} lanes, q (22, 512)",
        lambda: ms.sel7(win, q), lambda x=None: ms.sel7_plain(win, q, stats=x),
        check_exact, 4 * (2 * rt + ms.SEL_ROWS * lanes))
    jobs["mm22"] = (
        "mm22", f"{ms.VISITS} visits, ({rt}, {lanes}) picks x qsel "
        f"({lanes}, 128) bf16",
        lambda: ms.mm22(win, qsel),
        lambda x=None: ms.mm22_plain(win, qsel, stats=x), check_exact,
        4 * 2 * rt + 2 * qsel.numel())
    tab = dr.script_inputs(dev)
    for name, kern, plain in (("dyn12", dr.dyn12, dr.dyn12_plain),
                              ("blk1", dr.blk1, dr.blk1_plain)):
        jobs[name] = (name, f"{dr.VISITS} visits, q (468, 512)",
                      lambda k=kern: k(tab),
                      lambda x=None, p=plain: p(tab, stats=x), check_exact,
                      4 * (tab.numel() + tab.shape[1]))
    return jobs, (win, qsel)


def run_probes(jobs):
    """Phase 12, the probes' own run: each job's kernel wrapper once, with
    the probes' launch counters set to 0 just before and read just after;
    every probe must launch, every output be float32 of the shape its
    script gives and finite (NaN only where P1 ``grid`` adds a NaN
    distance) -> counts."""
    import torch

    from raytracinginonesemester_tpu_torch import probes

    probes.reset_launch_counts()
    outs = {key: job[2]() for key, job in jobs.items()}
    _sync()
    counts = probes.launch_counts()
    log(f"launch counts, {PROBE_RUN}: {counts}")
    missing = [k for k in PROBES if counts[k] == 0]
    if missing:
        raise AssertionError(f"{PROBE_RUN}: {missing} never launched")
    for key, out in outs.items():
        shape = (64, 512) if key.startswith("toy_mask") else (1, 512)
        ok = (out.isfinite() | out.isnan() if key == "toy_mask grid hazards"
              else out.isfinite())
        if tuple(out.shape) != shape or out.dtype != torch.float32 or \
                not bool(ok.all()):
            raise AssertionError(f"{PROBE_RUN}: {key} gave {out.dtype} "
                                 f"{tuple(out.shape)}, not all finite")
    return counts


def time_mm22_matmul(win, qsel, smi):
    """``torch.matmul`` of mm22's stacked one-hot picks (every visit's,
    bf16) by qsel: the product alone, not the function (no per-visit
    sums) -> ms."""
    import torch

    from raytracinginonesemester_tpu_torch.probes import mm_select as ms
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    lanes = qsel.shape[0]
    w = ms._lanes(win, ms.VISITS, lanes).reshape(-1)
    picks = torch.zeros(w.shape[0], lanes, dtype=torch.bfloat16,
                        device=qsel.device)
    picks[torch.arange(w.shape[0], device=w.device), w] = 1.0
    t = cuda_time_ms(lambda: torch.matmul(picks, qsel), warmup=1, iters=3)
    log(f"time mm22's product as one torch.matmul ({tuple(picks.shape)} x "
        f"{tuple(qsel.shape)} bf16, the per-visit sums not included): "
        f"{t['median_ms']:.3f} ms (median of 3) on {smi}")
    del picks
    return t["median_ms"]


# labels of an entry function's first template argument, by kernel (the
# others: the dialect); of its second (the others: a set one marks the
# diff variant); a third is bounce_step_kernel's rays a warp
FLAG_LABELS = {"streamed_kernel": ("closest", "occluded"),
               "dyn_reads_kernel": ("plane-major", "block-major"),
               "toy_mask_kernel": ("grid", "scalar", "both")}
FLAG2_LABELS = {"streamed_kernel": ("plan (G, I)", "gated slabs (H)")}


def ptxas_summary(text):
    """'kernel[<flags>]: N registers, S spill bytes' per entry function."""
    out, name, spill = [], None, "spills not reported"
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", ln)
        if m:
            n = int(m.group(1))
            name, rest = m.group(2)[:n], m.group(2)[n:]
            args = re.match(r"I((?:L[bi]\d+E)+)E", rest)
            if args:
                flags = [int(a) for a in
                         re.findall(r"L[bi](\d+)E", args.group(1))]
                labels = [FLAG_LABELS.get(name, ("gpu", "cpuonly"))[flags[0]]]
                if name in FLAG2_LABELS and flags[1:]:
                    labels.append(FLAG2_LABELS[name][flags[1]])
                elif flags[1:2] == [1]:
                    labels.append("diff")
                if flags[2:]:  # bounce_step_kernel: rays a warp
                    labels.append(f"{flags[2]} rays a warp")
                name += f"<{', '.join(labels)}>"
            spill = "spills not reported"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = f"spill st/ld {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.append(f"{name}: {m.group(1)} regs, {spill}")
            name = None
    return "; ".join(out)


def main():
    import torch

    # --- 1. the card
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    from raytracinginonesemester_tpu_torch.ops import _native

    nvcc = subprocess.run([_native._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(smi)
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"nvcc {nvcc}")
    dev = torch.device(DEVICE)
    t_start = time.time()

    # --- 2. build: one nvcc per source, all at once
    t0 = time.time()
    _native.build_all()
    for name in _native.SOURCES:
        _native.load(name)
        b = _native.BUILD_LOG[name]
        log(f"build {name}.cu: {b['seconds']:.1f} s ({b['path']}); "
            f"ptxas: {ptxas_summary(b['ptxas'])}")
    log(f"build: {time.time() - t0:.1f} s for {len(_native.SOURCES)} sources")

    # --- 3. kernels vs plain versions at 128x64
    errs = {}
    check_small(dev, errs)
    check_block_small(dev, errs)

    # --- 4. reference images
    check_goldens(dev)

    # --- 5. the main path: frog 1080p, depth 8, binned plan, then flat
    from raytracinginonesemester_tpu_torch import probes
    from raytracinginonesemester_tpu_torch.ops import binned
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, render_scene_frames, resolve_candidate_plan,
        resolve_wavefront)

    probes.reset_launch_counts()  # read after phase 10: no path runs one
    t0 = time.time()
    scene = frog_scene(W, H, device=dev)
    torch.cuda.synchronize()
    log(f"frog 1080p scene: {scene.geometry.num_triangles} triangles, "
        f"{scene.accel.num_blocks} blocks of {scene.accel.block_size}, "
        f"built in {time.time() - t0:.2f} s")
    t0 = time.time()
    cand = resolve_candidate_plan(scene, "wang", 1)
    torch.cuda.synchronize()
    log(f"binned plan: built in {time.time() - t0:.3f} s, "
        f"{binned.candidate_plan_stats(cand, 512)}")
    t0 = time.time()
    _, cap = resolve_wavefront(scene, "wang", 1)
    log(f"capacity calibration: {time.time() - t0:.2f} s, cap={cap} tiles")
    ms_binned, frames_b, main_counts = timed_frames(
        "main path, binned", scene, FRAMES, smi, ["emit", "bounce_step"])
    os.environ["RT_BINNED"] = "0"
    ms_flat, frames_f, flat_counts = timed_frames(
        "main path, RT_BINNED=0", scene, FRAMES, smi, ["emit", "bounce_step"])
    os.environ.pop("RT_BINNED")
    diff = (frames_b - frames_f).abs()
    n_diff = int((diff.amax(dim=-1) > 0).sum())
    log(f"binned vs RT_BINNED=0: {ms_binned:.3f} vs {ms_flat:.3f} ms/frame; "
        f"frames max abs diff {float(diff.max()):.3e}, differing pixels "
        f"{n_diff} of {FRAMES * W * H}")
    if n_diff:
        raise AssertionError("binned frames differ from the RT_BINNED=0 "
                             "frames (the plans must give the same images)")
    ref = frames_b[0].clone()
    del frames_b, frames_f, diff
    ms_over, over_counts = timed_overflow("overflow render", scene, smi,
                                          "wang", ref)
    del ref

    # --- 6. kernel D at full width
    terminal = frog_scene(W, H, max_bounces=4, diffuse_bounce=False,
                          device=dev)
    if not terminal.terminal_only or resolve_wavefront(terminal, "wang", 1)[0]:
        raise AssertionError("the terminal frog must take kernel D")
    ms_term, _, term_counts = timed_frames(
        "frog terminal depth 4 (kernel D)", terminal, FRAMES, smi, ["render"])
    os.environ["RT_WAVEFRONT"] = "0"
    ms_d, _, d_counts = timed_frames("main path, RT_WAVEFRONT=0 (kernel D)",
                                     scene, FRAMES, smi, ["render"], iters=1)
    os.environ.pop("RT_WAVEFRONT")

    # --- 7. cpuonly at full width
    cpu_scene = cpuonly_scene("cpuonly_mirror", dev, W, H)
    wf, cpu_cap = resolve_wavefront(cpu_scene, "auto", 1)
    path = "staged wavefront" if wf else "kernel D"
    ms_cpu, cpu_frames, cpu_counts = timed_frames(
        f"cpuonly_mirror 1080p ({path}, cap={cpu_cap})", cpu_scene, FRAMES,
        smi, ["emit"] if wf else ["render"])
    ref = cpu_frames[0].clone()
    del cpu_frames
    os.environ["RT_WAVEFRONT"] = "0"
    ms_cpu_d, _, cpu_d_counts = timed_frames(
        "cpuonly_mirror 1080p, RT_WAVEFRONT=0 (kernel D)", cpu_scene, FRAMES,
        smi, ["render"], iters=1)
    os.environ.pop("RT_WAVEFRONT")
    ms_cpu_over, cpu_over_counts = timed_overflow(
        "cpuonly_mirror 1080p overflow render", cpu_scene, smi, "auto", ref)
    del ref

    # --- 8. the staged integrator at full width
    ms_ref, _, ref_counts = timed_frames(
        "frog 1080p depth 8, reference_cpu (staged integrator)", scene,
        STAGED_FRAMES, smi, ["closest"], iters=1, jitter="reference_cpu",
        never=FUSED + ["occluded"])
    soft = cpuonly_scene("cpuonly_mirror", dev, W, H, radius=0.15,
                         shadow_samples=32, diffuse_bounce=True)
    ms_soft, _, soft_counts = timed_frames(
        "cpuonly_mirror 1080p, area light r=0.15 x32, diffuse (staged "
        "integrator)", soft, STAGED_FRAMES, smi, ["closest", "occluded"],
        iters=1, never=FUSED)

    # --- 9. the differentiable training path (bench.py --grad)
    check_diff_small(dev, errs)
    train = check_training(dev, smi)
    check_accum_library(train["j_call"])
    check_accum_library(train["j_vertex_call"])

    # --- 10. the large-scene streamed path (bench.py --large 1000000)
    large = check_large(dev, smi)
    _sync()
    path_probes = probes.launch_counts()
    log(f"probe launches in phases 5-10 (the render, training and "
        f"large-scene paths): {path_probes}")
    if any(path_probes.values()):
        raise AssertionError("a render or training path launched a probe")

    # --- 11. kernel times at full width beside the plain versions
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.render.renderer import render_scene

    # E and F on the inputs of their first launches (depth 0) and E's
    # second (depth 1) in single-frame staged renders
    e_calls = record_calls(integrator, ["block_closest"], lambda: render_scene(
        scene, "reference_cpu"))["block_closest"]
    soft_calls = record_calls(integrator, ["block_closest", "block_occluded"],
                              lambda: render_scene(soft))
    _sync()

    def e_job(call, shape):
        (o, d, grid, tmin), kw = call
        n_out = 16 + (12 + 4 * (0 if kw["shadow_lights"] is None else
                                int(kw["shadow_lights"].shape[0]))
                      if kw["return_normal"] else 0)
        planes = grid.tri.numel() + grid.tri_index.numel() + grid.aabb.numel()
        if kw["return_normal"]:
            planes += grid.norm.numel()
        return ("closest", shape, lambda: bk.block_closest(o, d, grid, tmin,
                                                           **kw),
                lambda x=None: bk.block_closest_plain(o, d, grid, tmin,
                                                      stats=x, **kw),
                check_hits, o.shape[0] * (24 + 4 + n_out) + 4 * planes)

    (fo, fd, fgrid, ftmin, ftmax), fkw = soft_calls["block_occluded"][0]
    f_bytes = fo.shape[0] * (24 + 8 + 1) + 4 * (
        fgrid.tri.numel() + fgrid.tri_index.numel() + fgrid.aabb.numel())
    n_rays = fo.shape[0]
    main = Frame(scene)
    check_binned_equiv("frog 1080p", main.emit(False), main.emit(True))
    st, rng = main.emit(False)
    st_s, rng_s, _ = main.sorted_state(st, rng)
    del st, rng
    # the ladder's first bounce sees the alive prefix of the sorted
    # subsets: cap tiles per frame, FRAMES frames
    width = min(main.nt, (cap or main.nt) * FRAMES)
    st_b, rng_b = st_s[:width * 16], rng_s[:width * 8]
    term = Frame(terminal)
    cpu = Frame(cpu_scene, jitter="center")
    c_st, c_rng = cpu.emit(True)
    c_st_s, c_rng_s, _ = cpu.sorted_state(c_st, c_rng)
    del c_st, c_rng
    ray_b = 8 + 96  # xs, ys in; state and rng out
    # A's shadow walk timed apart: F on the headline emit's facing rays
    so, sd, s_tmin, s_tmax = emit_shadow_rays(main, True)[0]
    def states(e, n, w, a, b):
        check_state(e, n, w, *a, *b)

    # key: (kernel, shape, kernel call, plain call taking the stats dict,
    # comparison, bytes moved)
    jobs = {
        "emit binned": (
            "emit", f"{main.nt} tiles x 512", lambda: main.emit(True),
            lambda x=None: main.emit_plain(True, stats=x), states,
            main.np_rays * ray_b + main.scene_bytes(True)),
        "emit flat": (
            "emit", f"{main.nt} tiles x 512", lambda: main.emit(False),
            lambda x=None: main.emit_plain(False, stats=x), states,
            main.np_rays * ray_b + main.scene_bytes(False)),
        "bounce_step": (
            "bounce_step", f"{width} sorted tiles x 512",
            lambda: main.bounce(st_b, rng_b),
            lambda x=None: main.bounce_plain(st_b, rng_b, x), states,
            width * 512 * 192 + main.scene_bytes(False)),
        "resume": (
            "resume", f"{main.nt} sorted tiles x 512, depths 1..7",
            lambda: main.resume(st_s, rng_s),
            lambda x=None: main.resume_plain(st_s, rng_s, x), check_sums,
            main.np_rays * (96 + 12) + main.scene_bytes(False)),
        "render V2 binned": (
            "render", f"{main.nt} tiles x 512, spp 1, depth 8",
            lambda: main.render(True),
            lambda x=None: main.render_plain(True, stats=x), check_sums,
            main.np_rays * 20 + main.scene_bytes(True)),
        "render terminal binned": (
            "render", f"{term.nt} tiles x 512, spp 1",
            lambda: term.render(True),
            lambda x=None: term.render_plain(True, stats=x), check_sums,
            term.np_rays * 20 + term.scene_bytes(True)),
        "cpuonly emit binned": (
            "emit", f"{cpu.nt} tiles x 512", lambda: cpu.emit(True),
            lambda x=None: cpu.emit_plain(True, stats=x), states,
            cpu.np_rays * ray_b + cpu.scene_bytes(True)),
        "cpuonly bounce_step": (
            "bounce_step", f"{cpu.nt} sorted tiles x 512",
            lambda: cpu.bounce(c_st_s, c_rng_s),
            lambda x=None: cpu.bounce_plain(c_st_s, c_rng_s, x), states,
            cpu.np_rays * 192 + cpu.scene_bytes(False)),
        "cpuonly resume": (
            "resume", f"{cpu.nt} sorted tiles x 512, depths 1..3",
            lambda: cpu.resume(c_st_s, c_rng_s),
            lambda x=None: cpu.resume_plain(c_st_s, c_rng_s, x),
            check_sums, cpu.np_rays * (96 + 12) + cpu.scene_bytes(False)),
        "cpuonly render binned": (
            "render", f"{cpu.nt} tiles x 512, spp 1", lambda: cpu.render(True),
            lambda x=None: cpu.render_plain(True, stats=x), check_sums,
            cpu.np_rays * 20 + cpu.scene_bytes(True)),
        "closest": e_job(e_calls[0], f"{n_rays} camera rays, normals, 1 "
                         "light's shadows (frog depth 0)"),
        "closest bounce": e_job(e_calls[1], f"{n_rays} rays, normals, 1 "
                                "light's shadows (frog depth 1)"),
        "cpuonly closest": e_job(soft_calls["block_closest"][0],
                                 f"{n_rays} camera rays, no normals "
                                 "(cpuonly_mirror depth 0)"),
        "occluded": (
            "occluded", f"{n_rays} shadow rays (cpuonly_mirror depth 0, "
            "first disk sample)",
            lambda: bk.block_occluded(fo, fd, fgrid, ftmin, ftmax, **fkw),
            lambda x=None: bk.block_occluded_plain(fo, fd, fgrid, ftmin,
                                                   ftmax, stats=x, **fkw),
            check_hits, f_bytes),
        "emit binned shadow walk": (
            "occluded", f"{so.shape[0]} facing shadow rays of emit binned "
            "(headline depth 0), F on them",
            lambda: bk.block_occluded(so, sd, scene.accel, s_tmin, s_tmax),
            lambda x=None: bk.block_occluded_plain(so, sd, scene.accel,
                                                   s_tmin, s_tmax, stats=x),
            check_hits, so.shape[0] * (24 + 4 + 1) + 4 * (
                scene.accel.tri.numel() + scene.accel.tri_index.numel()
                + scene.accel.aabb.numel())),
        **diff_jobs(train),
        **large["jobs"],
    }
    records = time_kernels(smi, errs, jobs)

    # --- 12. the TPU probes P1-P3, on no render or training path
    p_jobs, (p_win, p_qsel) = probe_jobs(dev)
    probe_counts = run_probes(p_jobs)
    probe_records = time_kernels(smi, errs, p_jobs)
    probe_records["mm22"]["matmul_product_ms"] = time_mm22_matmul(
        p_win, p_qsel, smi)

    # which run's launches each record reports: (run, counts, counter)
    tc = train["counts"]
    training = f"training call, grad-bench config ({GRAD_STEPS} steps)"
    runs = {"emit binned": ("main path, binned", main_counts, "emit"),
            "emit flat": ("main path, RT_BINNED=0", flat_counts, "emit"),
            "bounce_step": ("main path, binned", main_counts, "bounce_step"),
            "emit binned shadow walk": ("not on a path: A's shadow walk "
                                        "timed apart", {"none": 0}, "none"),
            "resume": ("overflow render at cap=8 (4 calls of 1 frame)",
                       over_counts, "resume"),
            "render V2 binned": ("main path, RT_WAVEFRONT=0", d_counts,
                                 "render"),
            "render terminal binned": ("frog terminal depth 4", term_counts,
                                       "render"),
            "cpuonly emit binned": ("cpuonly_mirror 1080p", cpu_counts,
                                    "emit"),
            "cpuonly bounce_step": ("cpuonly_mirror 1080p", cpu_counts,
                                    "bounce_step"),
            "cpuonly resume": ("cpuonly_mirror 1080p overflow render at "
                               "cap=8 (4 calls of 1 frame)", cpu_over_counts,
                               "resume"),
            "cpuonly render binned": ("cpuonly_mirror 1080p, RT_WAVEFRONT=0",
                                      cpu_d_counts, "render"),
            "closest": ("frog 1080p reference_cpu (staged)", ref_counts,
                        "closest"),
            "closest bounce": ("frog 1080p reference_cpu (staged)",
                               ref_counts, "closest"),
            "cpuonly closest": ("cpuonly_mirror 1080p area light x32 "
                                "(staged)", soft_counts, "closest"),
            "occluded": ("cpuonly_mirror 1080p area light x32 (staged)",
                         soft_counts, "occluded"),
            "bounce_step diff binned": (training, tc, "bounce_step[binned]"),
            "bounce_step diff": (training, {"flat": tc["bounce_step[diff]"]
                                            - tc["bounce_step[binned]"]},
                                 "flat"),
            "bounce_step diff flat": ("not on the training path (depth 0 "
                                      "walks the binned plan)", {"none": 0},
                                      "none"),
            "segment_accum": (training, tc, "segment_accum"),
            "segment_accum vertices": (training, tc, "segment_accum"),
            "large closest_streamed": ("large frog 1080p depth 8 (G and I)",
                                       large["gi_counts"],
                                       "closest_streamed"),
            "large occluded_streamed": ("large frog 1080p depth 8 (G and I)",
                                        large["gi_counts"],
                                        "occluded_streamed"),
            "large closest_blockmajor": ("large frog 1080p depth 8, "
                                         "RT_STREAM_BLOCKMAJOR=1 (H)",
                                         large["h_counts"],
                                         "closest_blockmajor"),
            "large occluded_blockmajor": ("large frog 1080p depth 8, "
                                          "RT_STREAM_BLOCKMAJOR=1 (H)",
                                          large["h_counts"],
                                          "occluded_blockmajor"),
            "large closest": ("large frog 1080p depth 8 (G and I), which "
                              "does not bind E", large["gi_counts"],
                              "closest"),
            "large occluded": ("large frog 1080p depth 8 (G and I), which "
                               "does not bind F", large["gi_counts"],
                               "occluded")}
    for key, rec in probe_records.items():
        runs[key] = (PROBE_RUN, probe_counts, rec["name"])
    records.update(probe_records)
    for key, rec in records.items():
        label, counts, counter = runs[key]
        rec.update(variant=key, launches=counts[counter],
                   launches_in=label, max_abs_err=errs[rec["name"]])
    main_keys = ("emit binned", "bounce_step", "resume", "render V2 binned",
                 "closest", "occluded", "segment_accum",
                 "large closest_streamed", "large occluded_streamed",
                 "large closest_blockmajor", "large occluded_blockmajor",
                 "toy_mask both", "sel7", "mm22", "dyn12", "blk1")
    log(f"ms/frame on {smi}: main path binned {ms_binned:.3f}, "
        f"RT_BINNED=0 {ms_flat:.3f}, RT_WAVEFRONT=0 {ms_d:.3f}, terminal "
        f"{ms_term:.3f}, cpuonly_mirror {ms_cpu:.3f}, cpuonly_mirror "
        f"RT_WAVEFRONT=0 {ms_cpu_d:.3f}; overflow at cap=8: frog "
        f"{ms_over:.3f}, cpuonly_mirror {ms_cpu_over:.3f}; staged "
        f"integrator: frog "
        f"reference_cpu {ms_ref:.3f}, cpuonly_mirror area light x32 "
        f"{ms_soft:.3f}; training, grad-bench config {train['ms_step']:.3f} "
        f"ms/step; large frog (1,270,912 triangles) G/I "
        f"{large['ms_gi']:.3f}, H {large['ms_h']:.3f}, A/B off the dispatch "
        f"{large['ms_ab']:.3f}; large scene host seconds "
        f"{ {k: round(v, 4) for k, v in large['host_s'].items()} }; "
        f"whole run {time.time() - t_start:.0f} s")
    log(json.dumps({"variants": [r for k, r in records.items()
                                 if k not in main_keys]}))
    log(json.dumps({"kernels": [records[k] for k in main_keys]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
