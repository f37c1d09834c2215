"""The large scene through whatever path a tree's dispatch gives it, on
one CUDA device: one frame and one differentiable training step.

    python scripts/time_large_dispatch.py [--root DIR]

Imports ``raytracinginonesemester_tpu_torch`` from ``DIR`` (default: this
checkout), so that the same measurement runs on another tree of the port,
for example its parent commit unpacked with ``git archive``; a tree
without ``scene/subdivide.py`` gets this checkout's copy.  The scene is
``chip_smoke.large_scene``'s: ``bench.py --large 1000000``'s frog at
1920x1080, spp 1, depth 8, diffuse bounces, its mesh subdivided 3 levels
(1,270,912 triangles), the block grid at 512 lanes.

- **frame**: ``render_scene_frames(scene, 1, "wang")`` as the tree
  dispatches it: a warm-up call, then 3 calls timed with CUDA events
  (median), the kernel launches of one call;
- **training step**: the same scene with ``differentiable=True``, the
  target its own ``center``-jitter render, albedo and light intensity
  perturbed by 5% (``RandomState(0)``), ``make_train_step`` with Adam at
  lr 1e-3 and no binned context: a warm-up step, then 3 steps timed
  with CUDA events (median), the launches of one step.

Prints the card's name and power limit, the package's path, then one
line per measurement and, last, one JSON object with the numbers.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, LEVELS = 1920, 1080, 3
STEPS = 3
PKG = "raytracinginonesemester_tpu_torch"


def _subdivide_module():
    """The tree's ``scene.subdivide``, or this checkout's copy loaded into
    the tree's package (its one import, ``.build``, is the tree's)."""
    try:
        return importlib.import_module(f"{PKG}.scene.subdivide")
    except ModuleNotFoundError:
        name = f"{PKG}.scene.subdivide"
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(REPO, PKG, "scene", "subdivide.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        return mod


def _counter_modules():
    """The tree's modules that keep kernel launch counters."""
    return [importlib.import_module(f"{PKG}.ops.{sub}")
            for sub in ("megakernel", "block_kernels", "diff_gather")]


def _counts():
    """Every launch counter the tree has -> {name: launches}, nonzero."""
    out = {}
    for mod in _counter_modules():
        out.update(mod.launch_counts())
        if hasattr(mod, "variant_launch_counts"):
            out.update(mod.variant_launch_counts())
    return {k: v for k, v in out.items() if v}


def _reset():
    for mod in _counter_modules():
        mod.reset_launch_counts()


def _timed(fn, iters):
    """Median and samples of ``iters`` calls of ``fn``, CUDA events."""
    import torch

    samples = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return sorted(samples)[len(samples) // 2], samples


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    pkg = importlib.import_module(PKG)
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise SystemExit(f"{PKG} came from {pkg.__file__}, not {root}")
    from raytracinginonesemester_tpu_torch.diff import inverse
    from raytracinginonesemester_tpu_torch.ops.accel import build_block_grid
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, render_scene_frames)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    print(f"package: {os.path.dirname(pkg.__file__)}", flush=True)

    scene = frog_scene(W, H, device="cuda")
    geom = _subdivide_module().subdivide_geometry(scene.geometry, LEVELS)
    grid = build_block_grid(geom.vertices, geom.num_triangles, block_size=512,
                            normals=geom.normals, obj_ids=geom.obj_id)
    scene = dataclasses.replace(scene, geometry=geom, accel=grid)
    torch.cuda.synchronize()

    # the frame as the tree dispatches it
    t0 = time.time()
    img = render_scene_frames(scene, 1, "wang", 0)
    torch.cuda.synchronize()
    first_s = time.time() - t0
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("frame not finite")
    _reset()
    render_scene_frames(scene, 1, "wang", 0)
    torch.cuda.synchronize()
    frame_counts = _counts()
    frame_ms, frame_samples = _timed(
        lambda: render_scene_frames(scene, 1, "wang", 0), 3)
    print(f"large frog {W}x{H} depth 8 ({geom.num_triangles} triangles, "
          f"{grid.num_blocks} blocks of 512): {frame_ms:.3f} ms/frame "
          f"(median of 3 CUDA-event timings, samples "
          f"{[round(s, 3) for s in frame_samples]}; first call "
          f"{first_s:.2f} s); launches of one frame {frame_counts}",
          flush=True)

    # one differentiable training step
    diff = dataclasses.replace(scene, differentiable=True)
    with torch.no_grad():
        target = inverse.render_scene(diff, "center", spp_override=1)
    rs = np.random.RandomState(0)
    p0 = {}
    for k, v in inverse.extract_params(
            diff, ("albedo", "light_intensity")).items():
        v = v.detach().cpu().numpy()
        p0[k] = v * (1.0 + 0.05 * rs.standard_normal(v.shape)
                     .astype(np.float32))
    params = inverse.params_from_numpy(p0, diff)
    step = inverse.make_train_step(torch.optim.Adam(list(params.values()),
                                                    lr=1e-3))
    losses = [step(params, diff, target)]
    torch.cuda.synchronize()
    _reset()
    losses.append(step(params, diff, target))
    torch.cuda.synchronize()
    step_counts = _counts()
    step_ms, step_samples = _timed(
        lambda: losses.append(step(params, diff, target)), STEPS)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not all(
            bool(torch.isfinite(p).all()) for p in params.values()):
        raise AssertionError("training step not finite")
    print(f"training step, large frog {W}x{H} depth 8, differentiable, "
          f"albedo and light intensity: {step_ms:.3f} ms/step (median of "
          f"{STEPS} CUDA-event timings, samples "
          f"{[round(s, 3) for s in step_samples]}); losses "
          f"{[round(x, 8) for x in losses]}; launches of one step "
          f"{step_counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(json.dumps({"root": root, "card": smi, "frame_ms": frame_ms,
                      "frame_samples_ms": frame_samples,
                      "frame_launches": frame_counts, "step_ms": step_ms,
                      "step_samples_ms": step_samples,
                      "step_launches": step_counts}), flush=True)


if __name__ == "__main__":
    main()
