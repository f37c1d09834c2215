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
   block sizes 128 and 512; E with normals and no lights (the
   model-sharded route) on camera and bounce rays; and on a grid padded
   by ``shard_scene_blocks`` whose padding blocks hold a box of
   triangles around the scene behind their empty AABBs
   (``tests/_torch_parity.py`` ``poisoned_padding``), E, F, A (flat
   emit) and B (bounce_step) must give the unpadded grid's results on
   those ray sets: no kernel enters a padding block;
4. reference images: the two-frog 128x64 render on the staged wavefront
   and through kernel D off the dispatch against the JAX package's
   ``tests/goldens/torch_two_frog_128x64.npy``, the terminal two-frog
   render (D) against ``torch_two_frog_terminal_128x64.npy`` (both made
   by ``scripts/make_torch_golden.py``), and ``cpuonly_point.json`` and
   ``cpuonly_mirror.json`` at 160x100 against the C++ oracle's PNGs
   (at most one step per channel); then through the staged integrator
   (E and F): ``gpu_spheres``, ``gpu_diffuse``, ``gpu_frog`` and
   ``gpu_cornell`` with ``jitter_mode="reference_cpu"`` at their JSON
   sizes against the C++ oracle's ``tests/goldens/gpu_*.png``
   (``assert_images_close``'s rule), and ``cpuonly_point.json`` with 17
   shadow samples (F 17 times per light and bounce; the staged integrator
   called directly, since the fused kernels take more than 16 samples)
   within one step of its PNG;
5. the main path: frog 1920x1080, depth 8, diffuse bounces,
   ``render_scene_frames`` with 16 frames at the calibrated capacity,
   with the binned camera plan (its build time and size logged) and
   then off the dispatch with the flat depth-0 walk (the wavefront
   called with ``cand_plan=None``); frames compared.  Counted and timed apart
   (ms/frame, median of 3): one frame at a capacity of 8 tiles, which
   overflows into the resume kernel, ``images_close`` to frame 0 of the
   calibrated binned run (its max abs difference logged);
6. kernel D at full width: frog 1080p terminal (diffuse off, depth 4),
   16 frames, and the headline through D off the dispatch
   (``megakernel.render_tiles`` on the pixel stream), one 16-frame
   call;
7. the cpuonly dialect at full width: ``cpuonly_mirror.json`` at
   1920x1080 through whatever the dispatch picks, then through kernel
   D off the dispatch, and one frame at a capacity of 8
   tiles (resume), timed and compared with frame 0 of the first run as
   phase 5's is;
8. the staged integrator at full width, 4 frames per call through
   ``render_scene_frames``: the frog 1920x1080 (depth 8, diffuse) with
   ``jitter_mode="reference_cpu"`` (E every depth; F never, the gpu
   dialect fuses its shadows into E), and ``cpuonly_mirror.json`` at
   1920x1080 with its light at radius 0.15, 32 shadow samples and
   diffuse bounces with ``reference_cpu`` jitter (E, and F once a disk
   sample; A-D must not launch); then that soft scene at ``auto``
   jitter, 16 frames a call, on the fused kernels (A and B must launch,
   E and F must not);
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
10. the large scene, ``bench.py --large 1000000``'s workload: the frog
   at 1920x1080 (spp 1, depth 8, diffuse, ``wang``) with its mesh
   subdivided 3 levels (1,270,912 triangles), the block grid at 512
   lanes (2,483 blocks, over the plane budget, which the fused kernels
   do not keep: they take it).  On the pixel-center camera rays
   (``bench.py:204-207``) G's winners against E's and H's against G's;
   on their shadow rays to the frog's light as the integrator spawns
   them (the missed rays' shade points parked at 1e30 with a zero
   direction, in the same tiles as the hits'), H's flags against I's
   and no parked ray blocked; on the hits' shadow rays alone, I's flags
   against F's and against I's full-width flags, exactly; one frame
   through ``render_scene_frames`` (kernels A and B with the binned
   plan must launch, E-I must not; ms/frame median of 3 calls), the same
   frame through the staged integrator called on its route directly (G
   and I must launch, E, F, H and A-D must not; the frame
   ``images_close`` to the A/B frame), and with ``RT_STREAM_BLOCKMAJOR``
   on (H; the frame must be the G/I frame bit for bit); the host seconds
   of the subdivision, the grid build and the camera rays' plan;
11. each kernel against its plain version at its full-width shapes, both
   timed, with the least time the card could take (bound); E and F on
   the inputs of their first launches in single-frame renders of phase
   8's scenes, A's shadow walk apart (F on the facing shadow rays of the
   headline's binned emit, as its plain version walks them), A, B and C
   on phase 8's 32-sample soft scene (A's binned emit, then B and C on
   its state sorted as the wavefront sorts it), J on those
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
   (the product alone); ``mm22`` also at the edges of its copies of
   ``MM_COPY`` visits and its staging ring of ``MM_SLOTS`` (0, 1,
   ``MM_COPY`` - 1, ``MM_COPY``, ``MM_COPY`` + 1, 33, 257, ``MM_SLOTS`` -
   1, ``MM_SLOTS``, ``MM_SLOTS`` + 1, 2 ``MM_SLOTS`` + 1) on the script's
   win and on one whose visits wrap past lane 511 (and 48 rays, a
   partial tile), ``dyn12`` and ``blk1`` at the edges of their period of
   39 visits (0, 1, 38, 39, 40, 79, 4096), ``sel7`` at the edges of its
   stretch of 32 visits and of the lanes (0, 1, ray 0's first wrap, 31,
   32, 33, B, B + 1, 4096) on 512 and 500 lanes and six wins (the
   script's, near lane 511, negative, all equal, 32 lanes apart, within
   24 visits of 2^31 - 1), and ``toy_mask`` in its three modes on seeded
   sets of 1, 2, 3, 156 and 160 boxes at 100 rays a block (0, 1, 2, 3
   and more boxes set in a block), each bit for bit; each probe's device
   time (``torch.profiler``) beside the launch floor, an empty kernel on
   the same grid through the same launch path (P1 and P2a); and whether
   the built ``probes`` library's SASS for ``mm22_kernel`` holds
   ``HGMMA`` (``wgmma``) and no ``HMMA`` (``mma.sync``), and whether
   ``sel7_kernel``'s visit loops hold no integer division, from
   ``cuobjdump -sass``;
13. the LBVH and the treelet block layout at full width: ``build_lbvh``
   on the frog (19,968 triangles with its padding) and on the large frog
   (1,270,912), each timed on the card and checked (every triangle a
   leaf once, every child's box inside its parent's; the frog's tree
   equal to the same build on the CPU exactly); ``bvh_closest`` (plain
   PyTorch) on each one's 1080p pixel-centre camera rays against kernel
   E's winners (hit flags equal, t within 4 ulp, ids equal except on
   ties of t), its rounds, overflowed rays and milliseconds logged; the
   headline of phase 5 with ``RT_BLOCK_LAYOUT=treelet`` (A and B must
   launch; ms/frame median of 3 beside phase 5's runs layout; block
   count and lane fill logged), its frames equal to phase 5's binned
   frames bit for bit; the terminal frog through D with both layouts,
   bit for bit;
14. the front ends and the soft path: ``render_hw1`` of the sphere and
   the frog at 320x180 against ``tests/goldens/hw1_{sphere,frog}.png``
   (``assert_images_close``'s rule); ``render_progressive`` on
   ``gpu_spheres.json`` (chunk 1 equal to the one-shot render bit for
   bit, and a run resumed from its state directory after one sample);
   the CLI in subprocesses on the card (``gpu_spheres.json --jitter
   reference_cpu`` against ``tests/goldens/gpu_spheres.png``, E must
   launch and A-D must not, with ``--export-bvh`` writing one box per
   grid block; ``--progressive 1``'s PNG equal to the one-shot render's);
   ``soft_render_loss`` on ``gpu_spheres.json`` at 160x90 (image and the
   gradients of vertices, albedo, camera center and light intensity, on
   the card against the CPU: the image within 1e-3, the gradients within
   1e-3 of each one's largest entry, finite and nonzero; float32 itself
   is that far from float64 there, ROADMAP.md section 3); 5 Adam steps (ms/step), and a run resumed from a checkpoint
   after step 2 equal to the straight run bit for bit; and
   ``examples/inverse_render_torch.py --steps 20`` in a temporary
   directory;
15. sharding (``raytracinginonesemester_tpu_torch/parallel``): first NCCL
   at world size 1 in this process (the dp1 fast path against
   ``render_scene`` bit for bit; the frog 1080p ``reference_cpu`` frame
   through the model-sharded route on one rank, "tp1": E without fused
   shadows, F, the merges, ``images_close`` to phase 8's frame, whose
   shadows E fuses from shadow rays of its own, so a grazing one may
   flip, with at most 200 pixels beyond 2e-5 of it); then 4 gloo ranks sharing card 0, spawned, each render with
   the counters set to 0 before it and read after it on every rank:
   the dp4 fast path on the headline frog (``sample_offset`` 0-3, equal
   to phase 5's frames bit for bit, A and B on every rank, E and F on
   none; ms/frame median of 3), the dp2 x tp2 staged frog
   (``reference_cpu``; compacted, plain (not compacted) and compacted at
   capacity 8, the overflow branch: each within 2e-5 of tp1, the
   capacity-8 run equal to the compacted one, E and F on every rank,
   A-D on none), and the dp4 training step on phase 9's workload (B's
   oracle rows and J on every rank, loss and gradients finite, the
   gradients within 1e-5 of each one's largest entry of phase 9's;
   ms/step median of 3); last ``dryrun_multichip(4, "gloo", "cuda")``.
   Every time of this phase is of 4 ranks sharing one card through
   gloo, not a multi-chip time.

Every render of phases 4-8, 10 and 13-15 runs with the launch counters
set to 0 just before it and read just after (the CLI's and the example's
in their subprocesses); a kernel of that render that did not run fails
the script, and so does a kernel that must not run there; phase 9's
training call likewise.  The line before the last is the JSON
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
    plans (the binned one ordered front to back, as the renderer walks
    it) and the keyword arguments of its kernels and plain versions."""

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
        self.cand = binned.order_front_to_back(
            binned.build_camera_candidate_plan(
                scene.camera, self.xs, self.ys, scene.accel, mk.RAY_TILE,
                chunk=chunk), scene.camera)
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


def soft_jobs(soft):
    """Phase 11's jobs of the 32-sample soft scene at full width, on
    the inputs its fused route gives them: A on the binned depth-0 plan,
    then B and C on A's state sorted as the wavefront sorts it, each
    against its plain version (time_kernels' key: job).  A's soft groups:
    the groups and walks its tallies count in one emit, and the share of
    the groups' sample slots that walk; B's and C's: the groups and walks
    that ``bounce_group_counts`` counts in the first call of each, which
    must equal the plain version's count."""
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    f = Frame(soft, jitter="center")
    (st, rng), _ = launches(lambda: f.emit(True))
    (walks,), (groups,) = (mk.shadow_walk_counts().values(),
                           mk.shadow_group_counts().values())
    samples = f.pkw["shadow_samples"]
    log(f"soft emit at {f.nt} tiles x 512: {groups} groups of {samples} "
        f"disk samples list {walks} walks, {walks / (groups * samples):.5f}"
        " of the groups' sample slots")
    st_s, rng_s, _ = f.sorted_state(st, rng)
    del st, rng

    def states(e, n, w, a, b):
        check_state(e, n, w, *a, *b)

    counted, plain_stats = {}, {}

    def kernel(key, fn):
        """fn, whose first call's soft groups are kept in counted[key]."""
        def run():
            if key in counted:
                return fn()
            before = next(iter(mk.bounce_group_counts().values()), (0, 0))
            out = fn()
            after = next(iter(mk.bounce_group_counts().values()))
            counted[key] = (after[0] - before[0], after[1] - before[1])
            return out
        return run

    def plain(key, fn):
        def run(x=None):
            if x is not None:
                plain_stats[key] = x
            return fn(x)
        return run

    def grouped(key, check):
        """check, then the kernel's groups against the plain count."""
        def run(e, n, w, got, want):
            check(e, n, w, got, want)
            (groups, walks), p = counted[key], plain_stats[key]
            log(f"{key}: {groups} groups of {samples} disk samples walk "
                f"{walks} samples, {walks / max(groups * samples, 1):.5f} "
                f"of the groups' sample slots; plain {p['groups']} groups, "
                f"{p['group_walks']} walks")
            if (groups, walks) != (p["groups"], p["group_walks"]):
                raise AssertionError(f"{key}: bounce_group_counts "
                                     f"{(groups, walks)} against the plain "
                                     f"count ({p['groups']}, "
                                     f"{p['group_walks']})")
        return run

    where = "32 disk samples a hit, depth 8, diffuse"
    return {
        "cpuonly soft emit binned": (
            "emit", f"{f.nt} tiles x 512, {where}", lambda: f.emit(True),
            lambda x=None: f.emit_plain(True, stats=x), states,
            f.np_rays * (8 + 96) + f.scene_bytes(True)),
        "cpuonly soft bounce_step": (
            "bounce_step", f"{f.nt} sorted tiles x 512, {where}",
            kernel("B", lambda: f.bounce(st_s, rng_s)),
            plain("B", lambda x=None: f.bounce_plain(st_s, rng_s, x)),
            grouped("B", states), f.np_rays * 192 + f.scene_bytes(False)),
        "cpuonly soft resume": (
            "resume", f"{f.nt} sorted tiles x 512, depths 1..7, {where}",
            kernel("C", lambda: f.resume(st_s, rng_s)),
            plain("C", lambda x=None: f.resume_plain(st_s, rng_s, x)),
            grouped("C", check_sums),
            f.np_rays * (96 + 12) + f.scene_bytes(False)),
    }


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
        for key in ("camera", "bounce"):
            # the model-sharded staged path's E: normals, no fused shadows
            o, d = rays[key]
            check_hits(errs, "closest", f"{where} {key} rays, normals, no "
                       "lights (model-sharded)",
                       bk.block_closest(o, d, grid, 1e-4, return_normal=True),
                       bk.block_closest_plain(o, d, grid, 1e-4,
                                              return_normal=True))
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
        check_padding(scene, rays, sets)


def check_padding(scene, rays, sets):
    """Phase 3: the padding blocks of a grid split over a model axis are
    never entered: E (with and without normals) and F on the hazard ray
    sets of ``check_block_small``, and A (flat emit) and B (bounce_step)
    on the frame, each equal to the unpadded grid's results with the
    padding blocks poisoned (``poisoned_padding``)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from _torch_parity import poisoned_padding

    bad = []
    padded = poisoned_padding(scene)
    grid, pgrid = scene.accel, padded.accel
    for key in ("camera", "bounce"):
        o, d = rays[key]
        for kw in (dict(), dict(return_normal=True)):
            want = bk.block_closest(o, d, grid, 1e-4, **kw)
            got = bk.block_closest(o, d, pgrid, 1e-4, **kw)
            if not all(torch.equal(a, b) for a, b in zip(_fields(got),
                                                          _fields(want))):
                bad.append(f"E {key} {kw}")
    for key, (o, d, tmin, tmax) in sets.items():
        if not torch.equal(bk.block_occluded(o, d, pgrid, tmin, tmax),
                           bk.block_occluded(o, d, grid, tmin, tmax)):
            bad.append(f"F {key}")
    f, fp = Frame(scene), Frame(padded)
    st, rng = f.emit(False)
    st_p, rng_p = fp.emit(False)
    if not (torch.equal(st, st_p) and torch.equal(rng, rng_p)):
        bad.append("A (flat emit)")
    st_s, rng_s, _ = f.sorted_state(st, rng)
    b, b_p = f.bounce(st_s, rng_s), fp.bounce(st_s, rng_s)
    if not all(torch.equal(x, y) for x, y in zip(b, b_p)):
        bad.append("B (bounce_step)")
    # the poison is live: with the padding blocks' AABBs around the box,
    # E finds it
    pgrid_open = dataclasses.replace(pgrid, aabb=pgrid.aabb.clone())
    n0 = grid.num_blocks
    pgrid_open.aabb[:, n0:] = torch.cat([grid.aabb[:3].amin(dim=1) - 1.0,
                                         grid.aabb[3:].amax(dim=1) + 1.0]
                                        )[:, None]
    o, d = rays["bounce"]
    live = int((bk.block_closest(o, d, pgrid_open, 1e-4).tri_idx
                >= 10 ** 6).sum())
    log(f"padding blocks ({pgrid.num_blocks - n0} of {pgrid.num_blocks}, "
        f"block {grid.block_size}): entered by {bad or 'no kernel'}; with "
        f"their AABBs opened E takes the poison box on {live} bounce rays")
    if bad or not live:
        raise AssertionError(f"padding blocks entered: {bad} (poison live on "
                             f"{live} rays)")


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


def launches(fn):
    """Run ``fn`` with the launch counters set to 0 just before it and
    read just after -> (its result, the counts)."""
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    mk.reset_launch_counts()
    bk.reset_launch_counts()
    dg.reset_launch_counts()
    out = fn()
    _sync()
    return out, {**mk.launch_counts(), **mk.variant_launch_counts(),
                 **bk.launch_counts(), **dg.launch_counts()}


def check_counts(label, counts, need, never=()):
    """Every kernel in ``need`` launched, and none in ``never``."""
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched ({counts})")
    extra = [k for k in never if counts[k]]
    if extra:
        raise AssertionError(f"{label}: {extra} launched, but this render "
                             f"must not take them ({counts})")


def counted(label, fn, need, never=()):
    """``launches`` of ``fn``, logged and checked by ``check_counts``."""
    out, counts = launches(fn)
    log(f"launch counts, {label}: {counts}")
    check_counts(label, counts, need, never)
    return out, counts


def check_goldens(dev):
    """Phase 4: the card's renders against the reference images."""
    import numpy as np

    from raytracinginonesemester_tpu_torch.io.image import quantize, read_png
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene, render_scene_frames)

    goldens = os.path.join(REPO, "tests", "goldens")
    def forced(cap):
        def frames(scene, n, jitter, offset):
            return render_scene_frames(scene, n, jitter, offset,
                                       capacity_tiles=cap)
        return frames

    # (file, diffuse, route, renderer, kernels that must run): the staged
    # wavefront at the golden's own capacity of 8 tiles, then D
    cases = [("torch_two_frog_128x64.npy", True, "cap=8", forced(8),
              ["emit", "bounce_step"]),
             ("torch_two_frog_128x64.npy", True, "kernel D", kernel_d_frames,
              ["render"]),
             ("torch_two_frog_terminal_128x64.npy", False, "dispatch",
              forced(None), ["render"])]
    for name, diffuse, route, frames_fn, need in cases:
        ref = np.load(os.path.join(goldens, name))
        scene = two_frog(128, 64, 512, dev, diffuse=diffuse)
        img, _ = counted(f"golden {name} {route}",
                         lambda: frames_fn(scene, ref.shape[0], "wang", 0),
                         need)
        img = img.cpu().numpy()
        for f in range(ref.shape[0]):
            ok, bad, mean = images_close(quantize(img[f], "gpu"),
                                         quantize(ref[f], "gpu"))
            log(f"golden {name} {route} frame {f}: bad_frac "
                f"{bad:.5f} mean {mean:.4f} max_abs "
                f"{np.abs(img[f] - ref[f]).max():.3e}")
            if not ok:
                raise AssertionError(f"card render disagrees with {name}")
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
    img, _ = counted("golden cpuonly_point.png, 17 shadow samples (staged "
                     "integrator, called directly)",
                     lambda: staged_frame(scene, "center"),
                     ["closest", "occluded"], never=FUSED)
    ours = quantize(img.cpu().numpy(), "cpuonly").astype(int)
    gold = read_png(os.path.join(goldens, "cpuonly_point.png")).astype(int)
    diff = abs(ours - gold)
    log(f"golden cpuonly_point.png (C++ oracle) 160x100, 17 shadow samples, "
        f"through the staged integrator: max channel diff {diff.max()}, "
        f"channels off {(diff > 0).mean():.5f}")
    if ours.shape != gold.shape or diff.max() > 1:
        raise AssertionError("staged cpuonly_point disagrees with the C++ "
                             "oracle")


def staged_frame(scene, jitter):
    """One frame of ``scene`` through the staged integrator (E and F),
    called directly: the route of the scenes the fused kernels refuse."""
    from raytracinginonesemester_tpu_torch.render import renderer

    w, h = scene.camera.width, scene.camera.height
    xs, ys, (hp, wp) = renderer._swizzled_grid(w, h, device=scene.device)
    acc = renderer.accumulate_samples(scene, xs, ys, 1, jitter)
    return renderer.unswizzle(acc, w, h, hp, wp)


def _off_dispatch(scene, frames, jitter, offset, kernel):
    """``frames`` spp-1 frames of ``scene`` through ``kernel`` on the
    renderer's pixel stream, off the dispatch (whose route for a
    bouncing scene is the staged wavefront): "render", kernel D with the
    binned plan; "flat", the staged wavefront at the dispatch's capacity
    with the flat depth-0 walk (``cand_plan=None``)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops.megakernel import render_tiles
    from raytracinginonesemester_tpu_torch.ops.wavefront import (
        render_tiles_wavefront_frames)
    from raytracinginonesemester_tpu_torch.render import renderer

    w, h = scene.camera.width, scene.camera.height
    stream = renderer.pixel_stream(w, h, scene.device)
    route = renderer.resolve_route(scene, stream, jitter, 1)
    xs, ys, _, (hp, wp) = stream
    if kernel == "flat":
        acc = render_tiles_wavefront_frames(
            scene, xs, ys, frames, offset, capacity_tiles=route.capacity,
            **route.kwargs)
    else:
        acc = torch.stack([render_tiles(scene, xs, ys, 1, offset + f,
                                        cand_plan=route.cand_plan,
                                        **route.kwargs)
                           for f in range(frames)])
    return renderer.unswizzle(acc, w, h, hp, wp)


def kernel_d_frames(scene, frames, jitter="auto", offset=0):
    return _off_dispatch(scene, frames, jitter, offset, "render")


def flat_frames(scene, frames, jitter="auto", offset=0):
    return _off_dispatch(scene, frames, jitter, offset, "flat")


def timed_frames(label, scene, frames, smi, need, iters=3, jitter="auto",
                 never=(), render=None):
    """Warm-up call, then ``iters`` timed calls counted as one run;
    ``render`` (default ``render_scene_frames``) makes the frames."""
    import torch

    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene_frames)
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    render = render or render_scene_frames
    render(scene, frames, jitter, 0)
    torch.cuda.synchronize()

    def run():
        t = cuda_time_ms(lambda: render(scene, frames, jitter, 0),
                         warmup=0, iters=iters)
        return t, render(scene, frames, jitter, 0)

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
    """Phase 10: the large scene (module docstring) -> (frame times,
    launch counts, phase 11's jobs)."""
    import torch

    from raytracinginonesemester_tpu_torch.io.image import quantize
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.ops.accel import (
        tile_visit_plan_fast)
    from raytracinginonesemester_tpu_torch.ops.megakernel import (
        RAY_TILE, megakernel_ineligible_reason)
    from raytracinginonesemester_tpu_torch.render import renderer as tr

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
    if bk.fits_vmem(grid) or reason is not None:
        raise AssertionError("the large scene must be over the plane budget, "
                             "and the fused kernels must take it")

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
    ms_ab, img_ab, ab_counts = timed_frames(
        f"{label} through A and B (the dispatch, binned)", scene, 1, smi,
        ["emit", "bounce_step"], jitter="wang",
        never=["closest", "occluded"] + STREAMED + BLOCKMAJOR)

    def staged(scene, frames, jitter, offset):
        # the staged integrator on its route, as reference_cpu takes it
        xs, ys, n, (hp, wp) = tr.pixel_stream(W, H, dev)
        route = tr.Route("staged: called directly", jitter)
        return torch.stack([tr.unswizzle(tr.render_stream(
            scene, route, xs[:n], ys[:n], 1, offset + f), W, H, hp, wp)
            for f in range(frames)])

    others = FUSED + ["closest", "occluded"]
    ms_gi, img_gi, gi_counts = timed_frames(
        f"{label} (G and I)", scene, 1, smi, STREAMED, jitter="wang",
        never=others + BLOCKMAJOR, render=staged)
    integrator._STREAM_BLOCKMAJOR = True
    try:
        ms_h, img_h, h_counts = timed_frames(
            f"{label}, RT_STREAM_BLOCKMAJOR=1 (H)", scene, 1, smi,
            BLOCKMAJOR, iters=1, jitter="wang", never=others + STREAMED,
            render=staged)
    finally:
        integrator._STREAM_BLOCKMAJOR = False
    n_diff = int((img_h != img_gi).any(dim=-1).sum())
    log(f"H frame vs G/I frame: differing pixels {n_diff} of {W * H}")
    if n_diff:
        raise AssertionError("the H frame differs from the G/I frame")

    ok, bad, mean = images_close(quantize(img_ab[0].cpu().numpy(), "gpu"),
                                 quantize(img_gi[0].cpu().numpy(), "gpu"))
    log(f"{label} through A and B: {ms_ab:.3f} ms/frame vs G/I {ms_gi:.3f} "
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


def check_probe_edges(dev, errs):
    """Phase 12: ``mm22`` at the edges of its copies and of its staging
    ring, on the script's win and on one within 12 lanes of 511 (its
    visits wrap), ``dyn12`` and ``blk1`` at the edges of their period,
    ``sel7`` at the edges of its stretch and of the lanes on the wins of
    ``mm_select.hazard_inputs`` at 512, 500, 999 and ``SEL_MAX_LANES``
    lanes, ``toy_mask`` in its three modes on ``toy_mask.count_inputs``
    (1, 2, 3, 156 and 160 boxes, 100 rays a block) and on the seeded
    hazards' first 1 and 7 rays a block (fewer rays than a cluster has
    CTAs), each bit for bit against its plain version (after the probes'
    own run: not counted)."""
    import torch

    from raytracinginonesemester_tpu_torch.probes import dyn_reads as dr
    from raytracinginonesemester_tpu_torch.probes import mm_select as ms
    from raytracinginonesemester_tpu_torch.probes import toy_mask as tm

    win, _, qsel = ms.script_inputs(dev)
    near = (500 + torch.arange(ms.RT, dtype=torch.int32, device=dev)
            % 12).reshape(-1, 1)
    c, k = ms.MM_SLOTS, ms.MM_COPY
    for tag, w in (("script win", win), ("win near lane 511", near)):
        for visits in (0, 1, k - 1, k, k + 1, 33, 257, c - 1, c, c + 1,
                       2 * c + 1):
            check_exact(errs, "mm22", f"{visits} visits, {tag}",
                        ms.mm22(w, qsel, visits),
                        ms.mm22_plain(w, qsel, visits))
    check_exact(errs, "mm22", f"{c + 1} visits, 48 rays (a partial tile)",
                ms.mm22(win[:48], qsel, c + 1),
                ms.mm22_plain(win[:48], qsel, c + 1))
    tab = dr.script_inputs(dev)
    for visits in (0, 1, 38, 39, 40, 79, 4096):
        check_exact(errs, "dyn12", f"{visits} visits", dr.dyn12(tab, visits),
                    dr.dyn12_plain(tab, visits))
        check_exact(errs, "blk1", f"{visits} visits", dr.blk1(tab, visits),
                    dr.blk1_plain(tab, visits))
    # sel7 at the edges of a stretch and of the lanes (ray 0's first wrap)
    for lanes in (ms.B, 500, 999, ms.SEL_MAX_LANES):
        wins, q = ms.hazard_inputs(lanes, dev)
        for tag, w in wins.items():
            edge = lanes - int(w[0]) % lanes
            for visits in (0, 1, edge, 31, 32, 33, lanes, lanes + 1,
                           ms.VISITS):
                check_exact(errs, "sel7", f"{visits} visits, {lanes} lanes, "
                            f"win {tag}", ms.sel7(w, q, visits),
                            ms.sel7_plain(w, q, visits))
    # P1 on sets of 0, 1, 2, 3 and more set boxes, 100 rays a block
    for n_boxes in (1, 2, 3, 156, tm.LP):
        rays, aabb = tm.count_inputs(n_boxes, 100, 0, dev)
        for mode in tm.MODES:
            check_exact(errs, "toy_mask", f"{mode}, {n_boxes} boxes, (64, "
                        "100) rays", tm.toy_mask(mode, rays, aabb),
                        tm.toy_mask_plain(mode, rays, aabb))
    # P1 with fewer rays a block than a cluster has CTAs
    rays, aabb = tm.hazard_inputs(0, dev)
    for rt in (1, 7):
        narrow = rays[:, :rt].contiguous()
        for mode in tm.MODES:
            check_exact(errs, "toy_mask", f"{mode}, seeded hazards, (64, "
                        f"{rt}) rays", tm.toy_mask(mode, narrow, aabb),
                        tm.toy_mask_plain(mode, narrow, aabb))


def device_times(fns, calls=5):
    """{name: {kernel: ms a call}} for each call of ``fns`` ({name: fn}):
    the device time of each CUDA kernel it launches, from one
    ``torch.profiler`` session over ``calls`` calls of each after a warm
    one.  Each call's group opens with a marker kernel (``spin_kernel`` of
    ``torch.cuda._sleep``); on the one stream, the device's events in
    device-time order split at the markers into the groups, in order.
    (The profiler's host-side links were not reliable for kernels
    launched through ctypes, and in one process it drops kernels after
    some tens of sessions: one session for all.)"""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    _sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for fn in fns.values():
            torch.cuda._sleep(1)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if str(e.device_type).endswith("CUDA")),
                    key=lambda e: e.time_range.start)
    groups = []
    for e in events:
        if "spin_kernel" in e.name:
            groups.append({})
        elif groups:
            key = e.name.split("(")[0]
            groups[-1][key] = groups[-1].get(key, 0.0) + (
                e.time_range.end - e.time_range.start) / calls / 1e3
    if len(groups) != len(fns) or not all(groups):
        names = sorted({e.name.split("(")[0] for e in events})[:12]
        raise AssertionError(f"the profiler saw {len(groups)} markers for "
                             f"{len(fns)} calls, or a call without kernels "
                             f"(device events: {names})")
    return dict(zip(fns, groups))


def time_probe_devices(jobs, records, smi):
    """Phase 12: each probe's device time a call (its kernels alone, no
    host enqueue) beside the launch floor, an empty kernel launched
    through the probes' launch path on the same grid (P1: 64 CTAs of 512
    threads in clusters of 8; P2a: 16 CTAs of 32)."""
    from raytracinginonesemester_tpu_torch.probes._common import launch_floor

    floors = {"toy_mask": lambda: launch_floor(64, 512, 8),
              "sel7": lambda: launch_floor(16, 32, 1)}
    ms = {k: sum(rows.values()) for k, rows in device_times(
        {**{key: job[2] for key, job in jobs.items()},
         **{f"floor {k}": fn for k, fn in floors.items()}}).items()}
    for key, job in jobs.items():
        rec, floor = records[key], ms.get(f"floor {job[0]}")
        rec["device_ms"] = ms[key]
        if floor is not None:
            rec["launch_floor_ms"] = floor
        log(f"device time {key}: {ms[key]:.4f} ms a call (torch.profiler, "
            f"5 calls)" + (f", launch floor on its grid {floor:.4f} ms "
                           f"({ms[key] / floor:.2f}x)" if floor else "")
            + f" on {smi}")


def sass_of(prefix):
    """The SASS of the built ``probes`` library's function whose mangled
    name starts with ``prefix`` (``cuobjdump -sass``)."""
    from raytracinginonesemester_tpu_torch.ops import _native

    tool = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", _native.BUILD_LOG["probes"]["path"]],
                          capture_output=True, text=True, check=True).stdout
    return "".join(sec for sec in re.split(r"\n\s*Function : ", text)
                   if sec.startswith(prefix))


def resource_usage(lib):
    """{mangled name: its resource line (REG, STACK, SHARED, LOCAL,
    CONSTANT, ...)} of every function of the built library ``lib``
    (``cuobjdump --dump-resource-usage``)."""
    from raytracinginonesemester_tpu_torch.ops import _native

    tool = os.path.join(os.path.dirname(_native._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "--dump-resource-usage", lib],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function "):
            name = line[len("Function "):].rstrip(":")
        elif name and line.startswith("REG:"):
            out[name] = line
            name = None
    return out


# the mangled-name prefixes of kernels B and C
BC_KERNELS = ("_Z18bounce_step_kernel", "_Z13resume_kernel")


# the integer division sequence nvcc emits for a runtime divisor (a
# reciprocal in floating point, refined), or a call to its slow path
DIVISION = ("MUFU.RCP", "I2F.U32.RP", "I2F.RP", "CALL")


def sass_loops(body):
    """Each loop of a function's SASS (a branch back to an address at or
    before its own) -> [(first address, branch address, {opcode: count})],
    innermost loops (holding no other) only."""
    rows = [(int(a, 16), ins.strip()) for a, ins in
            re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*);", body)]
    spans = []
    for addr, ins in rows:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    loops = []
    for lo, hi in spans:
        if any(lo <= a and b <= hi and (a, b) != (lo, hi) for a, b in spans):
            continue
        ops = {}
        for addr, ins in rows:
            if lo <= addr <= hi:
                op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
                ops[op] = ops.get(op, 0) + 1
        loops.append((lo, hi, ops))
    return loops


def check_sel7_sass():
    """Phase 12: ``sel7_kernel``'s visit loops (the innermost loops of its
    SASS that add: the stretch, 7 x 32 adds, and the tail) must hold no
    integer division sequence (``DIVISION``)."""
    loops = [lp for lp in sass_loops(sass_of("_Z11sel7_kernel"))
             if lp[2].get("FADD", 0) >= 7]
    for lo, hi, ops in loops:
        div = {k: v for k, v in ops.items() if k.startswith(DIVISION)}
        log(f"sel7_kernel SASS loop {lo:#x}-{hi:#x}: {sum(ops.values())} "
            f"instructions, {ops.get('FADD', 0)} FADD, {ops.get('LDS', 0)} "
            f"LDS, division {div or 'none'}")
    stretch = [lp for lp in loops if lp[2].get("FADD", 0) >= 7 * 32]
    if not stretch or any(k.startswith(DIVISION) for lp in loops
                          for k in lp[2]):
        raise AssertionError("sel7_kernel's visit loops must exist and hold "
                             "no integer division")


def check_mm22_sass():
    """Phase 12: the built ``probes`` library's SASS for ``mm22_kernel``
    (``cuobjdump -sass``) must hold HGMMA (``wgmma``) and no HMMA
    (``mma.sync``)."""
    body = sass_of("_Z11mm22_kernel")
    hgmma = len(re.findall(r"\bHGMMA\b", body))
    hmma = len(re.findall(r"\bHMMA\b", body))
    log(f"mm22_kernel SASS (cuobjdump -sass): {hgmma} HGMMA, {hmma} HMMA "
        f"instructions: {'holds HGMMA and no HMMA' if hgmma and not hmma else 'FAILS'}")
    if not body or not hgmma or hmma:
        raise AssertionError("mm22_kernel's SASS must hold HGMMA and no HMMA")


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


def check_tree(label, bvh, n):
    """An LBVH's invariants on its device: every triangle a leaf once,
    internal nodes without an object, each child's box inside its
    parent's."""
    import torch

    from raytracinginonesemester_tpu_torch.ops.lbvh import INVALID

    p = bvh.num_leaves
    leaves = torch.sort(bvh.object_idx[p - 1:]).values
    ok_leaves = p == n and bool((leaves == torch.arange(
        n, device=leaves.device)).all())
    ok_internal = bool((bvh.object_idx[:p - 1] == INVALID).all())
    inside = True
    for child in (bvh.left[:p - 1], bvh.right[:p - 1]):
        inside &= bool((bvh.aabb_min[child] >= bvh.aabb_min[:p - 1]).all())
        inside &= bool((bvh.aabb_max[child] <= bvh.aabb_max[:p - 1]).all())
    log(f"{label}: {p} leaves ({2 * p - 1} nodes); every triangle a leaf "
        f"once {ok_leaves}, internal nodes without objects {ok_internal}, "
        f"children's boxes inside their parents' {inside}")
    if not (ok_leaves and ok_internal and inside):
        raise AssertionError(f"{label}: the tree is malformed")


def timed_build(label, vertices):
    """``build_lbvh`` on the card, timed on the host clock (its refit
    loop reads the card once a round) after a warm-up build."""
    import torch

    from raytracinginonesemester_tpu_torch.ops.lbvh import build_lbvh

    build_lbvh(vertices)
    times = []
    for _ in range(3):
        _sync()
        t0 = time.time()
        bvh = build_lbvh(vertices)
        _sync()
        times.append((time.time() - t0) * 1e3)
    log(f"{label}: build_lbvh of {int(vertices.shape[0])} triangles on the "
        f"card: {sorted(times)[1]:.3f} ms (median of 3; samples "
        f"{[round(t, 3) for t in times]}); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return bvh, sorted(times)[1]


def check_bvh_walk(label, scene, bvh, smi):
    """``bvh_closest`` on the pixel-centre camera rays against kernel E's
    winners: hit flags equal, t within 4 ulp or 1e-5, ids equal where t
    is unique (a ray whose ids differ must hit both triangles at t
    within 4 ulp: the walk keeps the last leaf of equal t, E the lowest
    id) -> the walk's ms, rounds, overflowed rays."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops.intersect import mt_single
    from raytracinginonesemester_tpu_torch.ops.traversal import bvh_closest

    o, d = large_rays(scene)
    verts = scene.geometry.vertices
    hits_e, _ = counted(f"{label}: kernel E on {o.shape[0]} camera rays",
                        lambda: bk.block_closest(o, d, scene.accel, 1e-4),
                        ["closest"])
    stats = {}
    _sync()
    t0 = time.time()
    hits_b, _ = counted(f"{label}: bvh_closest (plain PyTorch, no kernel)",
                        lambda: bvh_closest(o, d, bvh, verts, 1e-4,
                                            stats=stats), [])
    ms = (time.time() - t0) * 1e3
    flags = int((hits_b.hit != hits_e.hit).sum())
    hit = hits_e.hit
    n_t, t_max = ulp_bad(hits_b.t[hit], hits_e.t[hit])
    differ = hit & (hits_b.tri_idx != hits_e.tri_idx)
    n_id = int(differ.sum())
    not_tie = 0
    if n_id:
        od, dd = o[differ], d[differ]
        t_e = mt_single(od, dd, verts[hits_e.tri_idx[differ].long()], 1e-8)[0]
        t_b = mt_single(od, dd, verts[hits_b.tri_idx[differ].long()], 1e-8)[0]
        not_tie = ulp_bad(t_b, t_e)[0]
    log(f"{label}: bvh_closest vs kernel E on {o.shape[0]} pixel-centre "
        f"camera rays ({int(hit.sum())} hit): hit flags differ {flags}, t "
        f"beyond 4 ulp {n_t} (max abs {t_max:.3e}), ids differ {n_id} "
        f"(all ties of t within 4 ulp: {not_tie == 0}); walk "
        f"{stats['rounds']} rounds, {stats['overflowed']} overflowed rays, "
        f"{ms:.1f} ms (host clock, one call) on {smi}")
    if flags or n_t or not_tie:
        raise AssertionError(f"{label}: bvh_closest disagrees with kernel E")
    del hits_e, hits_b
    torch.cuda.empty_cache()
    return ms, stats


def check_treelet(dev, smi, runs_frames, ms_runs_binned, terminal):
    """Phase 13: the LBVH builds and walks on the frog and the large frog,
    the treelet headline and the treelet terminal frog (module
    docstring)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops.lbvh import build_lbvh
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, render_scene_frames)

    out = {}
    os.environ["RT_BLOCK_LAYOUT"] = "treelet"
    t0 = time.time()
    tree = frog_scene(W, H, device=dev)
    tree_term = frog_scene(W, H, max_bounces=4, diffuse_bounce=False,
                           device=dev)
    _sync()
    os.environ.pop("RT_BLOCK_LAYOUT")
    g = tree.accel
    fill = float((g.tri_index >= 0).float().mean())
    log(f"treelet frog 1080p: {g.num_blocks} blocks of {g.block_size} at "
        f"{fill:.4f} lane fill, two scenes built in {time.time() - t0:.2f} s")

    # the LBVH of the frog on the card, and the same build on the CPU
    verts = tree.geometry.vertices
    torch.cuda.reset_peak_memory_stats()
    bvh, out["build_ms"] = timed_build("frog LBVH", verts)
    check_tree("frog LBVH", bvh, int(verts.shape[0]))
    cpu = build_lbvh(verts.cpu())
    same = all(bool((getattr(bvh, f).cpu() == getattr(cpu, f)).all())
               for f in ("parent", "left", "right", "object_idx", "aabb_min",
                         "aabb_max"))
    log(f"frog LBVH: the card's tree equals the CPU's exactly: {same}")
    if not same:
        raise AssertionError("the card's LBVH differs from the CPU's")
    out["walk_ms"], out["walk"] = check_bvh_walk("frog", tree, bvh, smi)
    del bvh, cpu

    large, _, _ = large_scene(dev)
    lverts = large.geometry.vertices
    torch.cuda.reset_peak_memory_stats()
    lbvh, out["large_build_ms"] = timed_build("large frog LBVH", lverts)
    check_tree("large frog LBVH", lbvh, int(lverts.shape[0]))
    out["large_walk_ms"], out["large_walk"] = check_bvh_walk(
        "large frog", large, lbvh, smi)
    del lbvh, large
    torch.cuda.empty_cache()

    # the headline with the treelet grid: A and B, frames bit for bit
    ms_tree, frames_t, out["counts"] = timed_frames(
        "main path, RT_BLOCK_LAYOUT=treelet", tree, FRAMES, smi,
        ["emit", "bounce_step"])
    n_diff = int((frames_t.cpu() != runs_frames).any(dim=-1).sum())
    log(f"treelet vs runs (phase 5) headline frames: differing pixels "
        f"{n_diff} of {FRAMES * W * H}; {ms_tree:.3f} vs {ms_runs_binned:.3f} "
        f"ms/frame on {smi}")
    if n_diff:
        raise AssertionError("treelet frames differ from the runs frames")
    del frames_t
    out["ms_tree"] = ms_tree

    # the terminal frog through D with both grids
    imgs = {}
    for name, s in (("runs", terminal), ("treelet", tree_term)):
        imgs[name], _ = counted(
            f"frog terminal depth 4, {name} grid (kernel D)",
            lambda: render_scene_frames(s, 2, "wang", 0), ["render"])
    n_diff = int((imgs["runs"] != imgs["treelet"]).any(dim=-1).sum())
    log(f"treelet vs runs terminal frog (kernel D), 2 frames: differing "
        f"pixels {n_diff}")
    if n_diff:
        raise AssertionError("treelet terminal frames differ from runs")
    out["blocks"], out["fill"] = g.num_blocks, fill
    return out


# a subprocess of the front ends: the launch counters set to 0, the module
# or script run as __main__ with ``argv``, the counts printed last
_SUB = """
import json, runpy, sys
sys.path.insert(0, {repo!r})
import torch
from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
from raytracinginonesemester_tpu_torch.ops import megakernel as mk
for m in (mk, bk, dg):
    m.reset_launch_counts()
sys.argv = {argv!r}
try:
    if {module!r}:
        runpy.run_module({module!r}, run_name="__main__", alter_sys=True)
    else:
        runpy.run_path(sys.argv[0], run_name="__main__")
except SystemExit as e:
    if e.code not in (0, None):
        raise
torch.cuda.synchronize()
print(json.dumps({{**mk.launch_counts(), **bk.launch_counts(),
                  **dg.launch_counts()}}))
"""


def run_sub(label, cwd, argv, need, never=(), module=None):
    """``argv`` in a subprocess on the card (``_SUB``) in ``cwd``; every
    kernel in ``need`` must have launched there, none in ``never``."""
    t0 = time.time()
    res = subprocess.run(
        [sys.executable, "-c", _SUB.format(repo=REPO, argv=argv,
                                           module=module or "")],
        cwd=cwd, capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise AssertionError(f"{label}: exit {res.returncode}\n"
                             f"{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
    lines = res.stdout.strip().splitlines()
    counts = json.loads(lines[-1])
    log(f"{label}: {time.time() - t0:.1f} s; stdout {lines[:-1][-3:]}; "
        f"launch counts {counts}")
    missing = [k for k in need if not counts[k]]
    extra = [k for k in never if counts[k]]
    if missing or extra:
        raise AssertionError(f"{label}: {missing} never launched, {extra} "
                             f"launched but must not ({counts})")
    return counts


# the soft path's parameters, and the bounds of its card-against-CPU
# image and gradients (relative to each one's largest entry): the
# triangles nearly edge-on to the camera make both ill-conditioned in
# float32 (ROADMAP.md section 3; scripts/soft_grad_precision.py)
SOFT_KEYS = ("vertices", "albedo", "camera_center", "light_intensity")
SOFT_GRAD_TOL = 1e-3
SOFT_IMAGE_TOL = 1e-3  # absolute, on the linear image


def soft_problem(device, dtype=None):
    """Phase 14's soft problem on ``device``: ``gpu_spheres.json`` without
    a grid, at 160x90 through ``bench.py --grad``'s camera; the target is
    the soft render (sigma 0.02) from the camera moved by 2 cm, made on
    the CPU; ``SOFT_KEYS`` as leaves -> (scene, target, params).
    ``dtype=torch.float64`` converts every float tensor of the scene."""
    import torch

    from raytracinginonesemester_tpu_torch.core.camera import Camera
    from raytracinginonesemester_tpu_torch.diff.inverse import extract_params
    from raytracinginonesemester_tpu_torch.diff.soft import render_soft
    from raytracinginonesemester_tpu_torch.scene.build import load_scene

    def scene_on(dev):
        s = load_scene(os.path.join(SCENES, "gpu_spheres.json"), accel="none",
                       device=dev)
        cam = Camera.create(position=(0.0, -2.5, 1.2),
                            look_at=(0.0, 0.0, 0.5), up=(0, 0, 1),
                            focal_length_mm=24.0, width=160, height=90,
                            device=dev)
        return dataclasses.replace(s, camera=cam)

    def cast(obj):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                kw[f.name] = v.to(dtype)
            elif dataclasses.is_dataclass(v):
                kw[f.name] = cast(v)
        return dataclasses.replace(obj, **kw)

    cpu = scene_on(torch.device("cpu"))
    with torch.no_grad():
        target = render_soft(dataclasses.replace(cpu, camera=dataclasses.replace(
            cpu.camera, center=cpu.camera.center + 0.02,
            pixel00_loc=cpu.camera.pixel00_loc + 0.02)), sigma=0.02)
    s = scene_on(device)
    if dtype is not None:
        s, target = cast(s), target.to(dtype)
    return s, target.to(device), extract_params(s, keys=SOFT_KEYS)


def check_frontends(dev, smi):
    """Phase 14: HW1, progressive, the CLI, the soft path and the
    inverse-render example on the card (module docstring)."""
    import tempfile

    import numpy as np
    import torch

    from raytracinginonesemester_tpu_torch.core.camera import Camera
    from raytracinginonesemester_tpu_torch.diff.checkpoint import (
        load_checkpoint, save_checkpoint, to_tensors)
    from raytracinginonesemester_tpu_torch.diff.inverse import extract_params
    from raytracinginonesemester_tpu_torch.diff.soft import (render_soft,
                                                              soft_render_loss)
    from raytracinginonesemester_tpu_torch.io.image import quantize, read_png
    from raytracinginonesemester_tpu_torch.io.obj import (load_obj,
                                                          mesh_to_triangles)
    from raytracinginonesemester_tpu_torch.render.progressive import (
        render_progressive)
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_hw1, render_scene)
    from raytracinginonesemester_tpu_torch.scene.build import (
        geometry_from_mesh, load_scene)

    goldens = os.path.join(REPO, "tests", "goldens")
    out = {}
    # HW1 against the C++ oracle's PNGs
    for name in ("sphere", "frog"):
        mesh, _ = load_obj(os.path.join(REPO, "tests", "assets", "meshes",
                                        f"{name}.obj"))
        geom = geometry_from_mesh(*mesh_to_triangles(mesh), device=dev)
        cam = Camera.create(position=(0.0, -1.0, 1.0),
                            look_at=(0.0, 0.15, 0.0), up=(0.0, 0.0, 1.0),
                            focal_length_mm=255.0, sensor_height_mm=24.0,
                            width=320, height=180, device=dev)
        _sync()
        t0 = time.time()
        img, _ = counted(f"render_hw1 {name} 320x180 (plain PyTorch)",
                         lambda: render_hw1(geom.vertices, geom.normals, cam,
                                            [-3.0, 0.0, 1.0],
                                            [1.0, 0.0, 1.0], 320, 180), [])
        ms = (time.time() - t0) * 1e3
        ok, bad, mean = images_close(
            quantize(img.cpu().numpy(), "hw1"),
            read_png(os.path.join(goldens, f"hw1_{name}.png")))
        log(f"render_hw1 {name} 320x180 vs hw1_{name}.png (C++ oracle): "
            f"bad_frac {bad:.5f} mean {mean:.4f}; {ms:.1f} ms (host clock, "
            f"first call) on {smi}")
        if not ok:
            raise AssertionError(f"render_hw1 {name} disagrees with the "
                                 "C++ oracle")

    # progressive rendering on gpu_spheres.json (spp 2)
    spheres = os.path.join(SCENES, "gpu_spheres.json")
    scene = load_scene(spheres, device=dev)
    one, _ = counted("gpu_spheres one-shot (render_scene)",
                     lambda: render_scene(scene).cpu().numpy(), [])
    prog, counts = counted("gpu_spheres render_progressive chunk 1",
                           lambda: render_progressive(scene, chunk=1), [])
    if not any(counts[k] for k in FUSED):
        raise AssertionError("render_progressive took no fused kernel")
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state")

        class Stop(Exception):
            pass

        def stop_after_one(done, _preview):
            if done == 1:
                raise Stop

        try:
            render_progressive(scene, chunk=1, state_dir=state,
                               on_chunk=stop_after_one)
        except Stop:
            pass
        resumed = render_progressive(scene, chunk=1, state_dir=state)
    same = [bool(np.array_equal(one, prog)), bool(np.array_equal(one,
                                                                 resumed))]
    log(f"gpu_spheres progressive chunk 1 equals the one-shot render bit for "
        f"bit: {same[0]}; resumed after 1 of 2 samples: {same[1]}")
    if not all(same):
        raise AssertionError("progressive render differs from one-shot")

    # the CLI in subprocesses on the card
    cli = "raytracinginonesemester_tpu_torch.render.cli"
    with tempfile.TemporaryDirectory() as tmp:
        png, boxes = os.path.join(tmp, "ref.png"), os.path.join(tmp, "b.obj")
        run_sub("CLI gpu_spheres --jitter reference_cpu --export-bvh", tmp,
                [cli, spheres, "--jitter", "reference_cpu", "-o", png,
                 "--export-bvh", boxes], ["closest"], FUSED, module=cli)
        ok, bad, mean = images_close(
            read_png(png), read_png(os.path.join(goldens, "gpu_spheres.png")))
        n_boxes = sum(1 for line in open(boxes) if line.startswith("v ")) // 8
        log(f"CLI gpu_spheres reference_cpu vs gpu_spheres.png (C++ "
            f"oracle): bad_frac {bad:.5f} mean {mean:.4f}; --export-bvh "
            f"{n_boxes} boxes, grid {scene.accel.num_blocks} blocks")
        if not ok or n_boxes != scene.accel.num_blocks:
            raise AssertionError("CLI render or export is wrong")
        prog_png = os.path.join(tmp, "prog.png")
        counts = run_sub("CLI gpu_spheres --progressive 1", tmp,
                         [cli, spheres, "--progressive", "1", "-o",
                          prog_png], [], module=cli)
        if not any(counts[k] for k in FUSED):
            raise AssertionError("CLI --progressive took no fused kernel")
        want = quantize(one, "gpu")
        got = read_png(prog_png)
        log(f"CLI --progressive 1 PNG equals the one-shot render's: "
            f"{bool(np.array_equal(got, want))}")
        if not np.array_equal(got, want):
            raise AssertionError("CLI --progressive differs from one-shot")

    # the soft path at 160x90 on gpu_spheres: the card against the CPU
    res = []
    for device in (dev, torch.device("cpu")):
        s, target, p = soft_problem(device)

        def soft_eval():
            with torch.no_grad():
                img = render_soft(s, sigma=0.02)
            loss = soft_render_loss(p, s, target, sigma=0.02)
            return img, loss, torch.autograd.grad(loss, list(p.values()))

        (img, loss, grads), _ = counted(
            f"render_soft and soft_render_loss's gradients, gpu_spheres "
            f"160x90 on {device.type} (plain PyTorch)", soft_eval, [])
        res.append((img.cpu(), loss.detach().cpu(), [g.cpu() for g in grads],
                    s, target))
    (img_c, loss_c, g_c, s, target), (img_h, loss_h, g_h, _, _) = res
    n_img, img_err = ulp_bad(img_c, img_h)
    worst = []
    for key, a, b in zip(SOFT_KEYS, g_c, g_h):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst.append((key, err / max(scale, 1e-30)))
        if not (bool(torch.isfinite(a).all()) and scale > 0.0
                and err <= SOFT_GRAD_TOL * scale):
            raise AssertionError(f"soft gradient {key}: card vs CPU {err} "
                                 f"of {scale}")
    log(f"soft_render_loss gpu_spheres 160x90, card vs CPU: image channels "
        f"beyond 4 ulp or 1e-5 {n_img} of {img_c.numel()} (max abs "
        f"{img_err:.3e}, bound {SOFT_IMAGE_TOL}), loss "
        f"{float(loss_c):.6e} vs {float(loss_h):.6e}, gradients' max abs "
        f"difference over their largest entry "
        f"{[(k, f'{r:.2e}') for k, r in worst]}")
    if not img_err <= SOFT_IMAGE_TOL:
        raise AssertionError("soft image differs between card and CPU")

    def train(steps, params=None, state=None):
        if params is None:
            params = extract_params(s, keys=("vertices", "albedo"))
        opt = torch.optim.Adam(list(params.values()), lr=1e-3)
        if state is not None:
            opt.load_state_dict(state)
        losses = []
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            loss = soft_render_loss(params, s, target, sigma=0.02)
            loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
        return params, opt, losses

    _sync()
    t0 = time.time()
    (straight, _, l_straight), _ = counted(
        "soft training, 5 Adam steps", lambda: train(5), [])
    _sync()
    out["soft_ms_step"] = (time.time() - t0) * 1e3 / 5
    p2, opt2, l_first = train(2)
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, 2, p2, opt2.state_dict(), l_first)
        _, saved, opt_state, losses = load_checkpoint(tmp)
    params = {k: torch.from_numpy(v).to(dev).requires_grad_(True)
              for k, v in saved.items()}
    params, _, l_rest = train(3, params, to_tensors(opt_state, dev))
    exact = (losses + l_rest == l_straight and all(
        bool(torch.equal(params[k], straight[k])) for k in straight))
    log(f"soft training gpu_spheres 160x90: {out['soft_ms_step']:.1f} ms/step "
        f"(host clock, 5 Adam steps) on {smi}; losses {l_straight}; resumed "
        f"from a checkpoint after step 2 equals the straight run bit for "
        f"bit: {exact}")
    if not exact:
        raise AssertionError("the resumed soft training differs")

    # the inverse-render example in a temporary directory
    with tempfile.TemporaryDirectory() as tmp:
        example = os.path.join(REPO, "examples", "inverse_render_torch.py")
        run_sub("examples/inverse_render_torch.py --steps 20", tmp,
                [example, "--steps", "20"], [])
        made = sorted(os.listdir(tmp))
        log(f"inverse_render_torch.py wrote {made}")
        if not {"inverse_target.png", "inverse_result.png"} <= set(made):
            raise AssertionError("the example wrote no images")
    return out

# phase 15: 4 gloo ranks sharing card 0 (NCCL refuses two ranks on one
# device), the headline frames of phase 5 they render, the tp images'
# bound against the same route on one rank (the JAX bound,
# tests/test_parallel.py:57); against phase 8's frame, whose shadows E
# fuses from its own shadow rays, so a grazing one may flip: images_close
# and at most TP1_FAR_PIXELS pixels beyond TP_ATOL (44 of 2,073,600
# measured on an H100 80GB HBM3 at 700 W, PERF.md section 6)
# and the dp training gradients' bound against phase 9's (of each one's
# largest entry: the ranks sum their pixels' shares in another order;
# 1.1e-7 measured at 48x32 on the CPU, tests/test_torch_parallel.py)
SHARD_RANKS, SHARD_FRAMES = 4, 4
TP_ATOL, GRAD_REL, TP1_FAR_PIXELS = 2e-5, 1e-5, 200
SHARED = "4 ranks sharing one card through gloo"


def _timed(fn):
    """(fn(), host milliseconds from a synchronised start to a
    synchronised end)."""
    _sync()
    t0 = time.perf_counter()
    out = fn()
    _sync()
    return out, (time.perf_counter() - t0) * 1e3


def sharding_runs(tmp):
    """Phase 15 on one rank: the dp4 fast path, the dp2 x tp2 staged path
    (compacted, plain, compacted at capacity 8) and the dp4 training step,
    each with the launch counters set to 0 before it and read after it
    -> the rank's record (counts, differences, host milliseconds)."""
    import torch

    from raytracinginonesemester_tpu_torch.diff import inverse
    from raytracinginonesemester_tpu_torch.parallel.sharded import (
        _render_sharded_staged, make_mesh, make_train_step_sharded,
        render_scene_sharded)
    from raytracinginonesemester_tpu_torch.render.renderer import frog_scene

    ref = torch.load(os.path.join(tmp, "ref.pt"))
    dev = torch.device(DEVICE)
    mesh_dp = make_mesh((SHARD_RANKS,), ("data",))
    mesh_tp = make_mesh((2, 2), ("data", "model"))
    scene = frog_scene(W, H, device=dev)
    rec = {}

    frames, counts = launches(lambda: [
        render_scene_sharded(scene, mesh_dp, sample_offset=k).cpu()
        for k in range(SHARD_FRAMES)])
    diff = [(f - ref["p5"][k]).abs() for k, f in enumerate(frames)]
    rec["dp4"] = dict(
        counts=counts, max_diff=max(float(x.max()) for x in diff),
        n_diff=sum(int((x.amax(dim=-1) > 0).sum()) for x in diff),
        ms=[_timed(lambda: render_scene_sharded(scene, mesh_dp))[1]
            for _ in range(3)])
    del frames, diff

    def tp(**kw):
        if kw:
            return _render_sharded_staged(scene, mesh_tp, "reference_cpu", 0,
                                          1, "model", **kw)
        return render_scene_sharded(scene, mesh_tp, "reference_cpu",
                                    model_axis="model")

    runs = {}
    for key, kw in (("compacted", {}), ("plain", dict(compacted=False)),
                    ("cap8", dict(compacted=True, capacity=8))):
        (img, ms), counts = launches(lambda: _timed(lambda: tp(**kw)))
        runs[key] = dict(img=img.cpu(), ms=ms, counts=counts)
    rec["tp"] = {k: dict(ms=v["ms"], counts=v["counts"],
                         tp1_diff=float((v["img"] - ref["tp1"]).abs().max()),
                         p8_diff=float((v["img"] - ref["p8"]).abs().max()))
                 for k, v in runs.items()}
    rec["tp_cap8_equal"] = bool(torch.equal(runs["cap8"]["img"],
                                            runs["compacted"]["img"]))
    rec["tp_compacted_vs_plain"] = float(
        (runs["compacted"]["img"] - runs["plain"]["img"]).abs().max())
    del runs

    scene_g = grad_scene(dev)
    params = inverse.params_from_numpy(
        {k: v.numpy() for k, v in ref["p0"].items()}, scene_g)
    step = make_train_step_sharded(
        torch.optim.Adam(list(params.values()), lr=1e-3), mesh_dp, "center",
        spp_override=1)
    target = ref["target"].to(dev)
    (loss, ms), counts = launches(lambda: _timed(
        lambda: step(params, scene_g, target)))
    grads = {k: p.grad.detach().cpu() for k, p in params.items()}
    rec["train"] = dict(
        counts=counts, first_ms=ms, loss=float(loss),
        finite=bool(torch.isfinite(loss)) and all(
            bool(torch.isfinite(g).all()) for g in grads.values()),
        rel={k: float((g - ref["grads"][k]).abs().max()
                      / ref["grads"][k].abs().max()) for k, g in grads.items()},
        ms=[_timed(lambda: step(params, scene_g, target))[1]
            for _ in range(3)])
    return rec


def sharding_rank(rank, tmp, port):
    """One gloo rank of phase 15 on card 0; writes its record to
    ``tmp/rank<r>.json``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=SHARD_RANKS, rank=rank)
    try:
        rec = sharding_runs(tmp)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def judge_sharding(recs, smi, loss1):
    """Phase 15's checks of every rank's record (``sharding_runs``), and
    its log lines -> rank 0's times."""
    fused = ["emit", "bounce_step", "resume", "render"]
    for r, rec in enumerate(recs):
        dp, tp, t = rec["dp4"], rec["tp"], rec["train"]
        log(f"rank {r}: dp4 fast path (frog {W}x{H} depth 8 binned, "
            f"sample_offset 0-{SHARD_FRAMES - 1}) launches {dp['counts']}; "
            f"vs phase 5's frames max abs diff {dp['max_diff']:.3e}, "
            f"{dp['n_diff']} differing pixels")
        check_counts(f"rank {r} dp4 fast path", dp["counts"],
                     ["emit", "bounce_step"], ["closest", "occluded"])
        if dp["n_diff"]:
            raise AssertionError(f"rank {r}: dp4 frames differ from phase 5's")
        for key, run in tp.items():
            log(f"rank {r}: dp2 x tp2 staged, {key} (frog {W}x{H}, "
                f"reference_cpu) launches {run['counts']}; vs tp1 max abs "
                f"diff {run['tp1_diff']:.3e} (bound {TP_ATOL}), vs phase 8's "
                f"frame {run['p8_diff']:.3e}")
            check_counts(f"rank {r} dp2 x tp2 {key}", run["counts"],
                         ["closest", "occluded"], fused)
            if not run["tp1_diff"] <= TP_ATOL:
                raise AssertionError(f"rank {r}: dp2 x tp2 {key} beyond "
                                     f"{TP_ATOL} of the tp1 frame")
        log(f"rank {r}: compacted vs plain max abs diff "
            f"{rec['tp_compacted_vs_plain']:.3e}; capacity 8 (overflow) "
            f"{'equals' if rec['tp_cap8_equal'] else 'DIFFERS FROM'} the "
            "compacted run")
        if not rec["tp_cap8_equal"]:
            raise AssertionError(f"rank {r}: the overflow run differs")
        log(f"rank {r}: dp4 training step (grad bench {GRAD_W}x{GRAD_H}) "
            f"launches {t['counts']}; loss {t['loss']:.8f} vs phase 9's "
            f"{float(loss1):.8f}; gradients vs phase 9's step, max |diff| "
            f"of max |g|: {t['rel']} (bound {GRAD_REL})")
        check_counts(f"rank {r} dp4 training step", t["counts"],
                     ["bounce_step[diff]", "segment_accum"])
        if not t["finite"] or not all(v <= GRAD_REL
                                      for v in t["rel"].values()):
            raise AssertionError(f"rank {r}: dp4 training step not finite "
                                 f"or beyond {GRAD_REL} of phase 9's")
    r0 = recs[0]
    out = dict(
        dp4_ms=_median(r0["dp4"]["ms"]),
        tp_ms={k: v["ms"] for k, v in r0["tp"].items()},
        train_ms=_median(r0["train"]["ms"]))
    log(f"{SHARED} (not a multi-chip time) on {smi}, rank 0's host clock: "
        f"dp4 fast path {out['dp4_ms']:.1f} ms/frame (median of 3, samples "
        f"{[round(x, 1) for x in r0['dp4']['ms']]}); dp2 x tp2 staged, one "
        f"frame each: {({k: round(v, 1) for k, v in out['tp_ms'].items()})} "
        f"ms; dp4 training step {out['train_ms']:.1f} ms/step (median of 3, "
        f"first step {r0['train']['first_ms']:.1f} ms)")
    return out


def check_sharding(smi, scene, p5, p8, train):
    """Phase 15: sharding on the card (module docstring)."""
    import tempfile

    import torch
    import torch.distributed as dist

    from raytracinginonesemester_tpu_torch.io.image import quantize
    from raytracinginonesemester_tpu_torch.parallel.dryrun import (
        dryrun_multichip, free_port)
    from raytracinginonesemester_tpu_torch.parallel.sharded import (
        make_mesh, render_scene_sharded)
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene)

    # NCCL at world size 1: the fast path through a real NCCL group, and
    # the staged frog through the model-sharded route (E without fused
    # shadows, F, the merges) on one rank: the tp images' reference
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        img, _ = counted("NCCL world size 1, dp1 fast path", lambda:
                         render_scene_sharded(scene, mesh),
                         ["emit", "bounce_step"], ["closest", "occluded"])
        tp1, _ = counted("NCCL world size 1, tp1 staged (reference_cpu)",
                         lambda: render_scene_sharded(
                             scene, mesh, "reference_cpu", model_axis="model"),
                         ["closest", "occluded"], FUSED)
    finally:
        dist.destroy_process_group()
    same = bool(torch.equal(img, render_scene(scene)))
    log(f"NCCL world size 1: fast path {'equals' if same else 'DIFFERS FROM'}"
        " render_scene bit for bit")
    if not same:
        raise AssertionError("NCCL world size 1 differs from render_scene")
    tp1 = tp1.cpu()
    ok, bad, mean = images_close(quantize(tp1.numpy(), "gpu"),
                                 quantize(p8.numpy(), "gpu"))
    d = (tp1 - p8).abs()
    far = int((d.amax(dim=-1) > TP_ATOL).sum())
    log(f"tp1 (E + F shadows) vs phase 8's frame (E's fused shadows): max "
        f"abs diff {float(d.max()):.3e}, pixels beyond {TP_ATOL} {far} of "
        f"{W * H} (bound {TP1_FAR_PIXELS}); images_close bad_frac "
        f"{bad:.6f} mean {mean:.4f}")
    if not ok or far > TP1_FAR_PIXELS:
        raise AssertionError("tp1 is not close to phase 8's frame")

    tr = train["tr"]
    loss1, g1 = tr.grads()
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(p5=p5, p8=p8, tp1=tp1, loss=loss1.cpu(),
                        p0={k: torch.from_numpy(v) for k, v in tr.p0.items()},
                        target=tr.target.cpu(),
                        grads={k: v.cpu() for k, v in g1.items()}),
                   os.path.join(tmp, "ref.pt"))
        torch.multiprocessing.start_processes(
            sharding_rank, args=(tmp, free_port()), nprocs=SHARD_RANKS,
            join=True, start_method="spawn")
        recs = []
        for r in range(SHARD_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    log(f"phase 15: {SHARD_RANKS} ranks spawned, ran and joined in "
        f"{time.time() - t0:.1f} s")
    out = judge_sharding(recs, smi, loss1)

    t0 = time.time()
    dryrun_multichip(SHARD_RANKS, "gloo", "cuda")
    out["dryrun_s"] = time.time() - t0
    log(f"dryrun_multichip({SHARD_RANKS}, 'gloo', 'cuda'): "
        f"{out['dryrun_s']:.1f} s ({SHARED})")
    return out


# labels of an entry function's first template argument, by kernel (the
# others: the dialect); of its second (the others: a set one marks the
# diff variant); a third is bounce_step_kernel's rays a warp
FLAG_LABELS = {"streamed_kernel": ("closest", "occluded"),
               "dyn_reads_kernel": ("plane-major", "block-major"),
               "toy_mask_kernel": ("grid", "scalar", "both"),
               "probe_floor_kernel": {1: "no cluster", 8: "clusters of 8"}}
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
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append(f"{name}: {m.group(1)} regs, {spill}"
                       + (f", {smem.group(1)} B smem"
                          if smem and smem.group(1) != "0" else ""))
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
        for ln in b["ptxas"].splitlines():
            if "wgmma" in ln or "arning" in ln:
                log(f"  ptxas: {ln.strip()}")
    log(f"build: {time.time() - t0:.1f} s for {len(_native.SOURCES)} sources")
    # B's and C's resources (scripts/time_soft_walks.py --parent holds the
    # gpu dialect's to a parent tree's)
    for name, line in sorted(resource_usage(
            _native.BUILD_LOG["megakernel"]["path"]).items()):
        if name.startswith(BC_KERNELS):
            log(f"  resources {name}: {line}")

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
    ms_flat, frames_f, flat_counts = timed_frames(
        "main path, flat depth 0", scene, FRAMES, smi, ["emit", "bounce_step"],
        render=flat_frames)
    diff = (frames_b - frames_f).abs()
    n_diff = int((diff.amax(dim=-1) > 0).sum())
    log(f"binned vs flat depth 0: {ms_binned:.3f} vs {ms_flat:.3f} ms/frame; "
        f"frames max abs diff {float(diff.max()):.3e}, differing pixels "
        f"{n_diff} of {FRAMES * W * H}")
    if n_diff:
        raise AssertionError("binned frames differ from the flat depth-0 "
                             "frames (the plans must give the same images)")
    ref = frames_b[0].clone()
    runs_frames = frames_b.cpu()  # phase 13 holds the treelet frames to it
    p5 = runs_frames[:SHARD_FRAMES].clone()  # phase 15 holds dp4's to them
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
    ms_d, _, d_counts = timed_frames("main path, kernel D off the dispatch",
                                     scene, FRAMES, smi, ["render"], iters=1,
                                     render=kernel_d_frames)

    # --- 7. cpuonly at full width
    cpu_scene = cpuonly_scene("cpuonly_mirror", dev, W, H)
    wf, cpu_cap = resolve_wavefront(cpu_scene, "auto", 1)
    path = "staged wavefront" if wf else "kernel D"
    ms_cpu, cpu_frames, cpu_counts = timed_frames(
        f"cpuonly_mirror 1080p ({path}, cap={cpu_cap})", cpu_scene, FRAMES,
        smi, ["emit"] if wf else ["render"])
    ref = cpu_frames[0].clone()
    del cpu_frames
    ms_cpu_d, _, cpu_d_counts = timed_frames(
        "cpuonly_mirror 1080p, kernel D off the dispatch", cpu_scene, FRAMES,
        smi, ["render"], iters=1, render=kernel_d_frames)
    ms_cpu_over, cpu_over_counts = timed_overflow(
        "cpuonly_mirror 1080p overflow render", cpu_scene, smi, "auto", ref)
    del ref

    # --- 8. the staged integrator at full width
    ms_ref, ref_frames, ref_counts = timed_frames(
        "frog 1080p depth 8, reference_cpu (staged integrator)", scene,
        STAGED_FRAMES, smi, ["closest"], iters=1, jitter="reference_cpu",
        never=FUSED + ["occluded"])
    p8 = ref_frames[0].cpu()  # phase 15 holds dp2 x tp2 to it
    del ref_frames
    soft = cpuonly_scene("cpuonly_mirror", dev, W, H, radius=0.15,
                         shadow_samples=32, diffuse_bounce=True)
    ms_soft, _, soft_counts = timed_frames(
        "cpuonly_mirror 1080p, area light r=0.15 x32, diffuse, reference_cpu "
        "(staged integrator, F a disk sample)", soft, STAGED_FRAMES, smi,
        ["closest", "occluded"], iters=1, jitter="reference_cpu", never=FUSED)
    ms_soft_fused, _, soft_fused_counts = timed_frames(
        "cpuonly_mirror 1080p, area light r=0.15 x32, diffuse (fused kernels)",
        soft, FRAMES, smi, ["emit", "bounce_step"],
        never=["closest", "occluded"])

    # --- 9. the differentiable training path (bench.py --grad)
    check_diff_small(dev, errs)
    train = check_training(dev, smi)
    check_accum_library(train["j_call"])
    check_accum_library(train["j_vertex_call"])

    # --- 10. the large scene (bench.py --large 1000000)
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
                              lambda: render_scene(soft, "reference_cpu"))
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
        **soft_jobs(soft),
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
    log(f"mm22 {probe_records['mm22']['ms']:.3f} ms against torch.matmul of "
        f"its product {probe_records['mm22']['matmul_product_ms']:.3f} ms "
        f"in this call ({probe_records['mm22']['ms'] / probe_records['mm22']['matmul_product_ms']:.3f}x)")
    time_probe_devices(p_jobs, probe_records, smi)
    check_probe_edges(dev, errs)
    check_mm22_sass()
    check_sel7_sass()

    # --- 13. the LBVH and the treelet block layout at full width
    tl = check_treelet(dev, smi, runs_frames, ms_binned, terminal)
    del runs_frames

    # --- 14. the front ends and the soft path
    fe = check_frontends(dev, smi)

    # --- 15. sharding: gloo ranks sharing the card, NCCL at world size 1
    sh = check_sharding(smi, scene, p5, p8, train)

    # which run's launches each record reports: (run, counts, counter)
    tc = train["counts"]
    training = f"training call, grad-bench config ({GRAD_STEPS} steps)"
    soft_fused = "cpuonly_mirror 1080p, area light r=0.15 x32, diffuse"
    runs = {"emit binned": ("main path, binned", main_counts, "emit"),
            "emit flat": ("main path, flat depth 0", flat_counts, "emit"),
            "bounce_step": ("main path, binned", main_counts, "bounce_step"),
            "emit binned shadow walk": ("not on a path: A's shadow walk "
                                        "timed apart", {"none": 0}, "none"),
            "resume": ("overflow render at cap=8 (4 calls of 1 frame)",
                       over_counts, "resume"),
            "render V2 binned": ("main path, kernel D", d_counts,
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
            "cpuonly render binned": ("cpuonly_mirror 1080p, kernel D",
                                      cpu_d_counts, "render"),
            "cpuonly soft emit binned": (soft_fused, soft_fused_counts,
                                         "emit"),
            "cpuonly soft bounce_step": (soft_fused, soft_fused_counts,
                                         "bounce_step"),
            "cpuonly soft resume": (soft_fused + ", which did not overflow",
                                    soft_fused_counts, "resume"),
            "closest": ("frog 1080p reference_cpu (staged)", ref_counts,
                        "closest"),
            "closest bounce": ("frog 1080p reference_cpu (staged)",
                               ref_counts, "closest"),
            "cpuonly closest": ("cpuonly_mirror 1080p area light x32, "
                                "reference_cpu (staged)", soft_counts,
                                "closest"),
            "occluded": ("cpuonly_mirror 1080p area light x32, "
                         "reference_cpu (staged)", soft_counts, "occluded"),
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
                 "cpuonly soft emit binned", "cpuonly soft bounce_step",
                 "cpuonly soft resume", "closest", "occluded", "segment_accum",
                 "large closest_streamed", "large occluded_streamed",
                 "large closest_blockmajor", "large occluded_blockmajor",
                 "toy_mask both", "sel7", "mm22", "dyn12", "blk1")
    log(f"ms/frame on {smi}: main path binned {ms_binned:.3f}, "
        f"flat depth 0 {ms_flat:.3f}, kernel D {ms_d:.3f}, terminal "
        f"{ms_term:.3f}, cpuonly_mirror {ms_cpu:.3f}, cpuonly_mirror "
        f"kernel D {ms_cpu_d:.3f}; overflow at cap=8: frog "
        f"{ms_over:.3f}, cpuonly_mirror {ms_cpu_over:.3f}; staged "
        f"integrator: frog "
        f"reference_cpu {ms_ref:.3f}, cpuonly_mirror area light x32 "
        f"reference_cpu {ms_soft:.3f} (fused, auto jitter: "
        f"{ms_soft_fused:.3f}); training, grad-bench config {train['ms_step']:.3f} "
        f"ms/step; large frog (1,270,912 triangles) G/I "
        f"{large['ms_gi']:.3f}, H {large['ms_h']:.3f}, A/B on the dispatch "
        f"{large['ms_ab']:.3f}; large scene host seconds "
        f"{ {k: round(v, 4) for k, v in large['host_s'].items()} }; "
        f"treelet headline {tl['ms_tree']:.3f} ({tl['blocks']} blocks at "
        f"{tl['fill']:.4f} lane fill); build_lbvh frog {tl['build_ms']:.3f} "
        f"ms, large frog {tl['large_build_ms']:.3f} ms; bvh_closest 1080p "
        f"camera rays frog {tl['walk_ms']:.1f} ms ({tl['walk']}), large frog "
        f"{tl['large_walk_ms']:.1f} ms ({tl['large_walk']}); soft training "
        f"gpu_spheres 160x90 {fe['soft_ms_step']:.1f} ms/step; {SHARED} "
        f"(not multi-chip times): dp4 fast path {sh['dp4_ms']:.1f} ms/frame, "
        f"dp2 x tp2 staged {({k: round(v, 1) for k, v in sh['tp_ms'].items()})}"
        f" ms/frame, dp4 training step {sh['train_ms']:.1f} ms/step, "
        f"dryrun {sh['dryrun_s']:.1f} s; whole run "
        f"{time.time() - t_start:.0f} s")
    log(json.dumps({"variants": [r for k, r in records.items()
                                 if k not in main_keys]}))
    log(json.dumps({"kernels": [records[k] for k in main_keys]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
