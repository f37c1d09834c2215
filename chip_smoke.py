"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises (exit != 0):

1. the card: ``nvidia-smi`` name and power limit, CUDA and nvcc versions;
2. build the CUDA kernels from ``raytracinginonesemester_tpu_torch/csrc``;
3. each kernel (emit, bounce_step, resume) against its plain PyTorch
   version on the card, on the two-frog test scene at 128x64, block
   sizes 128 and 512;
4. a 128x64 render on the card against the reference image that the JAX
   package rendered (``tests/goldens/torch_two_frog_128x64.npy``, made by
   ``scripts/make_torch_golden.py``);
5. the main path: frog 1920x1080, depth 8, diffuse bounces,
   ``render_scene_frames`` with 16 frames at the port's own calibrated
   capacity; its launch counters must show that emit and bounce_step
   ran.  Then, counted apart, one frame at a capacity of 8 tiles, which
   overflows and finishes in the resume kernel;
6. each kernel against its plain version at the main path's shapes
   (frog 1080p), and both times.

The line before the last is the JSON record of the main path's kernels
(emit, bounce_step, with the main path's launch counts); the line before
it holds resume's record with the overflow render's count.  The last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device the
script exits non-zero before printing any result.
"""

import json
import os
import subprocess
import sys
import time

# tolerance of the kernel-vs-plain comparisons (both are built without FMA
# contraction and with IEEE div/sqrt; powf and sqrtf may differ from
# torch's by an ulp, which the RR decisions can amplify on a handful of
# rays): float rows within 4 ulp or 1e-5 abs
ULPS, ATOL = 4, 1e-5
FRAMES = 16
REPLACES = {
    "emit": "raytracinginonesemester_tpu/ops/megakernel.py:2108",
    "bounce_step": "raytracinginonesemester_tpu/ops/megakernel.py:2560",
    "resume": "raytracinginonesemester_tpu/ops/megakernel.py:2253",
}
SOURCE = "raytracinginonesemester_tpu_torch/csrc/megakernel.cu"


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


def two_frog(width, height, block_size, device):
    os.environ["RT_BLOCK_SIZE"] = str(block_size)
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(repo, "tests"))
    from _torch_parity import two_frog_config

    cfg = two_frog_config(SceneConfig, SceneNodeConfig, Transform,
                          width=width, height=height, max_bounces=3,
                          diffuse_bounce=True)
    scene = build_scene(cfg, device=device)
    os.environ.pop("RT_BLOCK_SIZE")
    return scene


def compare_kernels(device, results):
    """Phase 3: kernel vs plain version on the same inputs."""
    import torch

    from raytracinginonesemester_tpu_torch.io.image import quantize
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.ops.wavefront import (
        _unsort_radiance, sort_bounce_state)
    from raytracinginonesemester_tpu_torch.render.renderer import (
        _swizzled_grid, _unswizzle)

    for bs in (128, 512):
        scene = two_frog(128, 64, bs, device)
        rows = mk._scene_rows(scene, scene.accel)
        xs, ys, (hp, wp) = _swizzled_grid(128, 64, device=device)
        xs_p, ys_p, n, np_rays = mk._pad_tiles(xs, ys)
        plan = mk.camera_tile_plan(scene.camera, xs_p, ys_p, scene.accel)
        has_work = plan[1][:, 0] < float("inf")
        diffuse = scene.diffuse_bounce

        st_k, rng_k = mk.emit_tiles(scene, xs_p, ys_p, 0, plan=plan, rows=rows)
        st_p, rng_p = mk.emit_tiles_plain(rows, xs_p, ys_p, has_work, 0,
                                          diffuse)
        torch.cuda.synchronize()
        report(results, "emit", f"128x64 block={bs}", st_k, rng_k, st_p, rng_p)

        # B and C are fed the same (kernel) emit state, sorted as the
        # wavefront scheduler sorts it
        grid = scene.accel
        lo = [grid.aabb[c].amin() for c in range(3)]
        span = [torch.clamp(grid.aabb[3 + c].amax() - lo[c], min=1e-20)
                for c in range(3)]
        pix = torch.arange(np_rays, device=device)
        st_s, rng_s, pix_s = sort_bounce_state(st_k, rng_k, pix, lo, span)
        b_k = mk.bounce_step_tiles(scene, st_s, rng_s, rows=rows)
        b_p = mk.bounce_step_tiles_plain(rows, st_s, rng_s, diffuse)
        torch.cuda.synchronize()
        report(results, "bounce_step", f"128x64 block={bs}", *b_k, *b_p)

        r_k = mk.resume_tiles(scene, st_s, rng_s, rows=rows)
        r_p = mk.resume_tiles_plain(rows, st_s, rng_s, scene.max_bounces,
                                    diffuse)
        torch.cuda.synchronize()
        imgs = []
        for rgb in (r_k, r_p):
            flat = torch.stack(_unsort_radiance(pix_s, *rgb), dim=1)
            img = _unswizzle(torch.clamp(flat[:n], 0.0, 1.0), 128, 64, hp, wp)
            imgs.append(quantize(img.cpu().numpy(), "gpu"))
        ok, bad, mean = images_close(imgs[0], imgs[1])
        worst = max(ulp_bad(a, b)[1] for a, b in zip(r_k, r_p))
        nbad = sum(ulp_bad(a, b)[0] for a, b in zip(r_k, r_p))
        log(f"compare resume 128x64 block={bs}: radiance beyond tol {nbad}, "
            f"max_abs {worst:.3e}; image bad_frac {bad:.5f} mean {mean:.4f}")
        results["resume"] = max(results.get("resume", 0.0), worst)
        if not ok or nbad:
            raise AssertionError(f"resume kernel disagrees (block {bs})")


def report(results, name, where, st_k, rng_k, st_p, rng_p):
    nt = st_k.shape[0] // 16
    a = st_k.reshape(nt, 16, -1)
    b = st_p.reshape(nt, 16, -1)
    alive = int((a[:, 12] != b[:, 12]).sum())
    rng = int((rng_k != rng_p).sum())
    # rows the winner drives: bounce origin (hit point) and direction
    winner = sum(ulp_bad(a[:, r], b[:, r])[0] for r in range(6))
    others = sum(ulp_bad(a[:, r], b[:, r])[0] for r in range(6, 16))
    worst = max(ulp_bad(a[:, r], b[:, r])[1] for r in range(16))
    log(f"compare {name} {where}: alive mismatches {alive}, rng "
        f"mismatches {rng}, winner-row (bo, bd) beyond tol {winner}, "
        f"other rows beyond tol {others}, max_abs {worst:.3e}")
    results[name] = max(results.get(name, 0.0), worst)
    if alive or rng or winner or others:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version ({where})")


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
    dev = torch.device("cuda")

    # --- 2. build
    t0 = time.time()
    _native.load()
    regs = [ln.strip() for ln in _native.BUILD_LOG["ptxas"].splitlines()
            if "registers" in ln]
    log(f"build: {time.time() - t0:.1f} s ({_native.BUILD_LOG['path']}); "
        f"ptxas: {' | '.join(regs)}")

    # --- 3. kernels vs plain versions
    errs = {}
    compare_kernels(dev, errs)

    # --- 4. the card's render vs the JAX package's reference image
    import numpy as np

    from raytracinginonesemester_tpu_torch.io.image import quantize
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, render_scene_frames)

    repo = os.path.dirname(os.path.abspath(__file__))
    ref = np.load(os.path.join(repo, "tests", "goldens",
                               "torch_two_frog_128x64.npy"))
    img = render_scene_frames(two_frog(128, 64, 512, dev), ref.shape[0],
                              "wang", 0).cpu().numpy()
    for f in range(ref.shape[0]):
        ok, bad, mean = images_close(quantize(img[f], "gpu"),
                                     quantize(ref[f], "gpu"))
        log(f"golden frame {f}: bad_frac {bad:.5f} mean {mean:.4f} "
            f"max_abs {np.abs(img[f] - ref[f]).max():.3e}")
        if not ok:
            raise AssertionError("card render disagrees with the reference")

    # --- 5. the main path at full size
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.render.renderer import (
        resolve_wavefront)
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    t0 = time.time()
    scene = frog_scene(1920, 1080, device=dev)
    torch.cuda.synchronize()
    log(f"frog 1080p scene: {scene.geometry.num_triangles} triangles, "
        f"{scene.accel.num_blocks} blocks of {scene.accel.block_size}, "
        f"built in {time.time() - t0:.2f} s")
    t0 = time.time()
    _, cap = resolve_wavefront(scene, "wang", 1)
    log(f"capacity calibration: {time.time() - t0:.2f} s, cap={cap} tiles")
    render_scene_frames(scene, FRAMES, "wang", 0)  # warm-up, not counted
    torch.cuda.synchronize()
    # the main path's run: three timed calls and one whose frames are
    # checked, all at the calibrated capacity
    mk.reset_launch_counts()
    timing = cuda_time_ms(lambda: render_scene_frames(scene, FRAMES, "wang", 0),
                          warmup=0, iters=3)
    frames = render_scene_frames(scene, FRAMES, "wang", 3 * FRAMES)
    torch.cuda.synchronize()
    counts = mk.launch_counts()
    ms_frame = timing["median_ms"] / FRAMES
    log(f"main path: {FRAMES} frames 1920x1080 depth 8: {ms_frame:.3f} "
        f"ms/frame, {1920 * 1080 / (ms_frame / 1e3):.4e} rays/s "
        f"(median of 3 CUDA-event timings, samples "
        f"{[round(t, 2) for t in timing['samples_ms']]} ms) on {smi}")
    log(f"launch counts over the main path (4 calls of {FRAMES} frames at "
        f"cap={cap}): {counts}")
    if tuple(frames.shape) != (FRAMES, 1080, 1920, 3) or \
            not bool(torch.isfinite(frames).all()):
        raise AssertionError("main path output not finite / wrong shape")
    if bool((frames.amax() <= 0.0)):
        raise AssertionError("main path rendered a black frame")
    if counts["emit"] == 0 or counts["bounce_step"] == 0:
        raise AssertionError(f"a kernel of the main path never ran: {counts}")

    # the overflow branch of the same path: at a capacity of 8 tiles the
    # alive wavefront does not fit and the frame finishes in resume
    mk.reset_launch_counts()
    overflow = render_scene_frames(scene, 1, "wang", 0, capacity_tiles=8)
    torch.cuda.synchronize()
    overflow_counts = mk.launch_counts()
    log(f"launch counts over the overflow render (1 frame at cap=8): "
        f"{overflow_counts}")
    if not bool(torch.isfinite(overflow).all()):
        raise AssertionError("overflow render not finite")
    if overflow_counts["resume"] == 0:
        raise AssertionError(f"the overflow render never ran resume: "
                             f"{overflow_counts}")

    # --- 6. kernel times at the main path's shapes beside the plain ones
    from raytracinginonesemester_tpu_torch.ops.wavefront import (
        sort_bounce_state)
    from raytracinginonesemester_tpu_torch.render.renderer import (
        _swizzled_grid)

    rows = mk._scene_rows(scene, scene.accel)
    xs, ys, _ = _swizzled_grid(1920, 1080, device=dev)
    xs_p, ys_p, _, np_rays = mk._pad_tiles(xs, ys)
    nt = np_rays // mk.RAY_TILE
    plan = mk.camera_tile_plan(scene.camera, xs_p, ys_p, scene.accel)
    has_work = plan[1][:, 0] < float("inf")
    grid = scene.accel
    lo = [grid.aabb[c].amin() for c in range(3)]
    span = [torch.clamp(grid.aabb[3 + c].amax() - lo[c], min=1e-20)
            for c in range(3)]
    pix = torch.arange(np_rays, device=dev)
    st, rng = mk.emit_tiles(scene, xs_p, ys_p, 0, plan=plan, rows=rows)
    st_s, rng_s, _ = sort_bounce_state(st, rng, pix, lo, span)
    # the ladder's first bounce sees the alive prefix of the sorted
    # subsets: cap tiles per frame, FRAMES frames
    width = min(nt, (cap or nt) * FRAMES)
    st_b, rng_b = st_s[:width * 16], rng_s[:width * 8]
    diffuse = scene.diffuse_bounce
    shapes = {"emit": f"{nt} tiles x {mk.RAY_TILE} rays",
              "bounce_step": f"{width} tiles x {mk.RAY_TILE} rays",
              "resume": f"{nt} tiles x {mk.RAY_TILE} rays"}
    calls = {
        "emit": (lambda: mk.emit_tiles(scene, xs_p, ys_p, 0, plan=plan,
                                       rows=rows),
                 lambda: mk.emit_tiles_plain(rows, xs_p, ys_p, has_work, 0,
                                             diffuse)),
        "bounce_step": (lambda: mk.bounce_step_tiles(scene, st_b, rng_b,
                                                     rows=rows),
                        lambda: mk.bounce_step_tiles_plain(rows, st_b, rng_b,
                                                           diffuse)),
        "resume": (lambda: mk.resume_tiles(scene, st_s, rng_s, rows=rows),
                   lambda: mk.resume_tiles_plain(rows, st_s, rng_s,
                                                 scene.max_bounces, diffuse)),
    }
    records = {}
    for name, (kern, plain) in calls.items():
        # the same inputs through both, at the main path's shapes
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if name == "resume":
            nbad = sum(ulp_bad(a, b)[0] for a, b in zip(got, want))
            worst = max(ulp_bad(a, b)[1] for a, b in zip(got, want))
            log(f"compare resume 1080p: radiance beyond tol {nbad}, "
                f"max_abs {worst:.3e}")
            errs["resume"] = max(errs["resume"], worst)
            if nbad:
                raise AssertionError("resume kernel disagrees at 1080p")
        else:
            report(errs, name, "1080p", *got, *want)
        del got, want
        k = cuda_time_ms(kern, warmup=1, iters=3)
        p = cuda_time_ms(plain, warmup=0, iters=1)
        log(f"time {name} at {shapes[name]}: kernel {k['median_ms']:.3f} ms "
            f"(median of 3), plain {p['median_ms']:.1f} ms (1 run) on {smi}")
        records[name] = {"name": name, "route": "cuda", "source": SOURCE,
                         "replaces": REPLACES[name],
                         "max_abs_err": errs[name], "ms": k["median_ms"],
                         "plain_ms": p["median_ms"]}

    # resume runs only in the overflow branch, so its launches are the
    # overflow render's and it is reported on its own line
    log(json.dumps({"overflow_kernels": [
        dict(records.pop("resume"), launches=overflow_counts["resume"])]}))
    log(json.dumps({"kernels": [dict(r, launches=counts[n])
                                for n, r in records.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
