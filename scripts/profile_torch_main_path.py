"""Where the time of the port's main path goes, on one CUDA device.

    python scripts/profile_torch_main_path.py [--frames 16] [--width 1920 --height 1080]
        [--jitter wang|reference_cpu]
    python scripts/profile_torch_main_path.py --grad [--frames 8]
    python scripts/profile_torch_main_path.py --large

Renders the frog scene (depth 8, diffuse) with
``render_scene_frames`` once to warm up, then once under
``torch.profiler`` and prints: wall time per call (host clock around a
synchronised call), summed device time by kernel name, the device's busy
and idle share of the wall time, the kernel launches of the profiled
call, its device-to-host copies that wait for the queue
(``aten::_local_scalar_dense``: every ``bool(tensor)`` or ``.item()``),
and the card's name and power limit.  ``--jitter wang`` (default) is the
main path through the fused kernels; ``--jitter reference_cpu`` renders
through the staged integrator (kernel E per depth, the host's "any
alive" check per depth, the shading glue in between).

``--grad`` profiles the differentiable training path instead, the
workload of ``bench.py --grad``: ``gpu_spheres.json`` at 960x540 with
its camera, 2 bounces, a differentiable block grid, albedo, light
intensity and vertices perturbed by 5%, one call of ``--frames`` (8)
Adam steps at lr 1e-3 under the binned depth-0 context (slack 0.05).
Besides the profile it times one call's parts with CUDA events: the
grid rebuild (``apply_params``), the plan refresh, the oracle (kernel B
and its packing), kernel J with its sort glue, the rest of the forward
and backward chains (the glue), and Adam.
``--large`` profiles one frame of the large-scene path, the workload of
``bench.py --large 1000000`` (``chip_smoke.large_scene``: the frog at
1920x1080, depth 8, its mesh subdivided to 1,270,912 triangles, over the
plane budget), through the staged integrator and the streamed kernels G
and I.  Besides the profile it times, with CUDA events over one frame,
G and I (their wrappers, the plan built on the card included) and the
hit frame's gathers (``make_hit_frame``), the rest being the glue.
The full table is also written to ``chiprun_out/profile_main_path.txt``
(``profile_grad.txt`` with ``--grad``, ``profile_large.txt`` with
``--large``).
"""

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--jitter", choices=("wang", "reference_cpu"),
                    default="wang")
    ap.add_argument("--grad", action="store_true")
    ap.add_argument("--large", action="store_true")
    args = ap.parse_args()
    if args.grad:
        return profile_grad(args.frames or 8, args.width or 960,
                            args.height or 540)
    if args.large:
        return profile_large()
    args.frames = args.frames or 16
    args.width, args.height = args.width or 1920, args.height or 1080
    jitter = args.jitter

    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, render_scene_frames, resolve_wavefront)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    scene = frog_scene(args.width, args.height, device="cuda")
    _, cap = resolve_wavefront(scene, jitter, 1)
    render_scene_frames(scene, args.frames, jitter, 0)
    torch.cuda.synchronize()

    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        render_scene_frames(scene, args.frames, jitter, (i + 1) * args.frames)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    mk.reset_launch_counts()
    bk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_scene_frames(scene, args.frames, jitter, 4 * args.frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    if not events:
        raise SystemExit("the profiler saw no device time: time with CUDA "
                         "events instead")
    # one stream, so kernels never overlap and their sum is busy time
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=25)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "profile_main_path.txt"), "w") as f:
        f.write(table)
    launches = {**mk.launch_counts(), **bk.launch_counts()}
    syncs = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    print(f"card: {smi}")
    print(f"frog {args.width}x{args.height} depth 8, {jitter}, "
          f"{args.frames} frames, cap={cap}: wall per call "
          f"{sorted(walls)[1] * 1e3:.2f} ms (median of 3 unprofiled; "
          f"{[round(w * 1e3, 2) for w in walls]}), profiled call "
          f"{wall * 1e3:.2f} ms")
    print(f"device busy {busy_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms "
          f"profiled wall: idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}")
    print(f"profiled call: kernel launches {launches}; device-to-host "
          f"copies {syncs}")
    by_name = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in events), reverse=True)
    for us, count, key in by_name[:15]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def _busy_table(prof, out_name):
    """(device busy us, kernel rows by device time, host syncs) of a
    profile; writes the table to chiprun_out/<out_name>."""
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    if not events:
        raise SystemExit("the profiler saw no device time: time with CUDA "
                         "events instead")
    busy_us = sum(getattr(e, "self_device_time_total", 0) for e in events)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", out_name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    syncs = sum(e.count for e in prof.key_averages()
                if e.key == "aten::_local_scalar_dense")
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in events), reverse=True)
    return busy_us, rows, syncs


def profile_grad(steps, width, height):
    """The training path of ``bench.py --grad`` (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import Training, grad_scene
    from raytracinginonesemester_tpu_torch.diff import inverse
    from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
    from raytracinginonesemester_tpu_torch.ops import diff_oracle as do
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = _card()
    tr = Training(grad_scene("cuda", width, height))
    scene, target, ctx = tr.scene, tr.target, tr.ctx

    def call(parts=None):
        params = tr.params()
        opt = torch.optim.Adam(list(params.values()), lr=1e-3)
        with ctx:
            for _ in range(steps):
                opt.zero_grad(set_to_none=True)
                with _part(parts, "forward"):
                    loss = inverse.render_loss(params, scene, target,
                                               "center", 1)
                with _part(parts, "backward"):
                    loss.backward()
                with _part(parts, "adam"):
                    opt.step()

    call()
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    # one call's parts with CUDA events: each patched function is timed
    # where it runs (the events sit on the stream its kernels use)
    parts = {}
    patched = [(inverse, "apply_params", "grid rebuild (apply_params)"),
               (integrator, "_diff_cand", "plan refresh"),
               (do, "fused_bounce_oracle", "oracle (kernel B + packing)"),
               (dg, "segment_accum_rows", "kernel J + its sort glue")]
    real = {}
    for mod, name, label in patched:
        real[(mod, name)] = getattr(mod, name)

        def timed(*a, _f=real[(mod, name)], _label=label, **k):
            with _part(parts, _label):
                return _f(*a, **k)

        timed.__dict__ = real[(mod, name)].__dict__
        setattr(mod, name, timed)
    try:
        call(parts)
        torch.cuda.synchronize()
    finally:
        for (mod, name), f in real.items():
            setattr(mod, name, f)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) / steps
          for k, v in parts.items()}

    mk.reset_launch_counts()
    dg.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, rows, syncs = _busy_table(prof, "profile_grad.txt")
    launches = {**mk.launch_counts(), **mk.variant_launch_counts(),
                **dg.launch_counts()}
    print(f"card: {smi}")
    print(f"training, grad-bench config {width}x{height}, {steps} Adam steps "
          f"per call: wall per step {sorted(walls)[1] * 1e3 / steps:.2f} ms "
          f"(median of 3 unprofiled calls; "
          f"{[round(w * 1e3, 2) for w in walls]} ms per call), profiled "
          f"call {wall * 1e3:.2f} ms")
    print(f"device busy {busy_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms "
          f"profiled wall: idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f}")
    print(f"profiled call: kernel launches {launches}; device-to-host "
          f"copies {syncs} ({syncs / steps:.1f} per step)")
    inner = {"forward": ("grid rebuild (apply_params)", "plan refresh",
                         "oracle (kernel B + packing)"),
             "backward": ("kernel J + its sort glue",)}
    print("per step, CUDA events (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()))
    for outer, parts_in in inner.items():
        glue = ms.get(outer, 0.0) - sum(ms.get(p, 0.0) for p in parts_in)
        print(f"  {outer} glue (the rest of the {outer} chain): {glue:.3f}")
    for us, count, key in rows[:20]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def profile_large():
    """One frame of the large-scene path (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import large_scene
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene_frames)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = _card()
    scene, t_sub, t_grid = large_scene("cuda")
    render_scene_frames(scene, 1, "wang", 0)
    torch.cuda.synchronize()
    walls = []
    for i in range(3):
        t0 = time.perf_counter()
        render_scene_frames(scene, 1, "wang", i + 1)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    parts = {}
    patched = [(integrator, "block_closest_streamed", "G (with its plan)"),
               (integrator, "block_occluded_streamed", "I (with its plan)"),
               (integrator, "make_hit_frame", "hit frame gathers")]
    real = {}
    for mod, name, label in patched:
        real[(mod, name)] = getattr(mod, name)

        def timed(*a, _f=real[(mod, name)], _label=label, **k):
            with _part(parts, _label):
                return _f(*a, **k)

        timed.__dict__ = real[(mod, name)].__dict__
        setattr(mod, name, timed)
    try:
        t0 = time.perf_counter()
        with _part(parts, "frame"):
            render_scene_frames(scene, 1, "wang", 4)
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
    finally:
        for (mod, name), f in real.items():
            setattr(mod, name, f)
    ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in parts.items()}

    mk.reset_launch_counts()
    bk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_scene_frames(scene, 1, "wang", 5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, rows, syncs = _busy_table(prof, "profile_large.txt")
    launches = {k: v for k, v in {**mk.launch_counts(),
                                  **bk.launch_counts()}.items() if v}
    kernel_us = sum(us for us, _, key in rows
                    if key.startswith(("closest_streamed_kernel",
                                       "occluded_streamed_kernel")))
    print(f"card: {smi}")
    print(f"large frog 1920x1080 depth 8 ({scene.geometry.num_triangles} "
          f"triangles, {scene.accel.num_blocks} blocks; subdivision "
          f"{t_sub:.3f} s, grid {t_grid:.3f} s): wall per frame "
          f"{sorted(walls)[1] * 1e3:.2f} ms (median of 3 unprofiled; "
          f"{[round(w * 1e3, 2) for w in walls]}), profiled frame "
          f"{wall * 1e3:.2f} ms")
    print(f"device busy {busy_us / 1e3:.2f} ms of {wall * 1e3:.2f} ms "
          f"profiled wall: idle share {1 - busy_us / 1e3 / (wall * 1e3):.3f};"
          f" G and I kernels {kernel_us / 1e3:.2f} ms of the busy time, the "
          f"rest (plans, operands, glue) {(busy_us - kernel_us) / 1e3:.2f} ms")
    print(f"profiled frame: kernel launches {launches}; device-to-host "
          f"copies {syncs}")
    print(f"one frame, CUDA events (ms, frame wall {timed_wall * 1e3:.2f}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()))
    glue = ms["frame"] - sum(v for k, v in ms.items() if k != "frame")
    print(f"  the rest of the frame (camera rays, shading glue, host "
          f"syncs): {glue:.3f}")
    for us, count, key in rows[:20]:
        print(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


class _part:
    """Add a (start, stop) CUDA event pair under ``label`` to ``parts``
    (a no-op when ``parts`` is None)."""

    def __init__(self, parts, label):
        self.parts, self.label = parts, label

    def __enter__(self):
        if self.parts is not None:
            import torch

            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        return self

    def __exit__(self, *exc):
        if self.parts is not None:
            self.ev[1].record()
            self.parts.setdefault(self.label, []).append(self.ev)
        return False


if __name__ == "__main__":
    main()
