"""Where the time of the port's main path goes, on one CUDA device.

    python scripts/profile_torch_main_path.py [--frames 16] [--width 1920 --height 1080]
        [--jitter wang|reference_cpu]
    python scripts/profile_torch_main_path.py --grad [--frames 8]
    python scripts/profile_torch_main_path.py --large
    python scripts/profile_torch_main_path.py --kernels

Renders the frog scene (depth 8, diffuse) with
``render_scene_frames`` once to warm up, then once under
``torch.profiler`` and prints: wall time per call (host clock around a
synchronised call), summed device time by kernel name, the device's busy
and idle share of the wall time, the kernel launches of the profiled
call, its device-to-host copies that wait for the queue
(``aten::_local_scalar_dense``: every ``bool(tensor)`` or ``.item()``),
and the card's name and power limit.  ``--jitter wang`` (default) is the
main path through the fused kernels, and one more call's ms/frame is
printed beside its summed CUDA-event time of kernel A (``emit_tiles``)
and kernel B (``bounce_step_tiles``); ``--jitter reference_cpu`` renders
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
``--kernels`` profiles kernels B and J at ``chip_smoke.py`` phase 11's
full-width inputs.  B (gpu dialect) on the headline frog's 4,080 sorted
tiles at depth 1 and B (cpuonly) on ``cpuonly_mirror``'s: each timed,
also without its lights (the closest-hit walk and the shading alone);
kernel E without normals on B's live rays (the one-thread-per-ray
closest-hit walk); a SIMT count of that walk from the plain version's
(ray, block) tests (a warp of 32 rays runs a block's triangle loop when
any of its lanes passes the slab test) against the pairs the
warp-cooperative walk tests, 32 lanes to a pair; and ``clock64()``
cycles of B's walks per warp, with ``%globaltimer`` spans, from an
instrumented copy of ``csrc/megakernel.cu`` (built apart under
``build/walk_clocks/``; its results must equal the kernel's).  J on the
inputs of its launches in one grad-bench step (the material and vertex
tables): the wrapper (kernel + its sort glue), the glue alone, the
kernels alone on the glue's plan, and ``index_add_``.
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
    ap.add_argument("--kernels", action="store_true")
    args = ap.parse_args()
    if args.kernels:
        return profile_kernels()
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
    from raytracinginonesemester_tpu_torch.ops import wavefront
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, render_scene_frames, resolve_wavefront)

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = _card()
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

    # the counted call: kernels A and B timed where they run, with CUDA
    # events around each wrapper call (the wavefront's own references)
    parts = {}
    with _patched(parts, [(wavefront, "emit_tiles", "A (emit_tiles)"),
                          (wavefront, "bounce_step_tiles",
                           "B (bounce_step_tiles)")]):
        mk.reset_launch_counts()
        with _part(parts, "call"):
            render_scene_frames(scene, args.frames, jitter, 4 * args.frames)
        torch.cuda.synchronize()
        counted = mk.launch_counts()
    ab = {k: (sum(a.elapsed_time(b) for a, b in v), len(v))
          for k, v in parts.items()}

    mk.reset_launch_counts()
    bk.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_scene_frames(scene, args.frames, jitter, 5 * args.frames)
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
    call_ms = ab["call"][0]
    print(f"counted call (CUDA events, {args.frames} frames): "
          f"{call_ms / args.frames:.3f} ms/frame, launches {counted}; "
          + "; ".join(f"{k} {ms:.3f} ms over {n} calls "
                      f"({ms / args.frames:.3f} ms/frame, "
                      f"{ms / call_ms:.3f} of the call)"
                      for k, (ms, n) in ab.items() if k != "call"))
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
    with _patched(parts, patched):
        call(parts)
        torch.cuda.synchronize()
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
    with _patched(parts, patched):
        t0 = time.perf_counter()
        with _part(parts, "frame"):
            render_scene_frames(scene, 1, "wang", 4)
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
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


def _tested_blocks(rows, o, d, alive, det_eps, tmin):
    """The flat closest-hit walk of ``megakernel._closest_plain`` on the
    live rays -> (R, L) bool: the blocks whose slab test each ray passes
    against its running best t, i.e. the (ray, block) pairs it tests."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    r, dev, bs = d[0].shape[0], d[0].device, rows.block_size
    inv = tuple(1.0 / c for c in d)
    best = mk._Best(r, dev)
    tmin_t = torch.full((r,), tmin, device=dev)
    tested = torch.zeros(r, rows.num_blocks, dtype=torch.bool, device=dev)
    for b in range(rows.num_blocks):
        boxed = mk._slab(rows.aabb[b], o, inv, tmin_t, best.t) & alive
        tested[:, b] = boxed
        sub = boxed.nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        tri = tuple(rows.tri[k, b][None, :] for k in range(9))
        ids = rows.ids[b].to(torch.int64)[None, :]
        slots = b * bs + torch.arange(bs, device=dev)[None, :]
        for ch in mk._chunks(sub, bs):
            best.visit(ch, o, d, tri, ids, slots, det_eps, tmin)
    return tested


def _profile_b(label, frame, st, rng):
    """Kernel B on one full-width input: its time, its time without the
    scene's lights (no shadow walks), kernel E's closest-hit walk alone
    on the live rays, and the SIMT count of that walk."""
    import dataclasses
    import math

    import torch

    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    kw = frame.no_jitter()
    rows = frame.rows
    dark = dataclasses.replace(rows, lights=rows.lights[:0].contiguous())
    t_b = cuda_time_ms(lambda: frame.bounce(st, rng), warmup=1, iters=5)
    t_dark = cuda_time_ms(lambda: mk.bounce_step_tiles(
        frame.scene, st, rng, rows=dark, **kw), warmup=1, iters=5)
    flat = mk._unpack(st, rng)
    alive = flat["alive"] > 0.0
    live = alive.nonzero().squeeze(1)
    tmin = 1e-4  # _Shade.tmin in both dialects
    det_eps = kw.get("det_eps", 1e-8)
    o = torch.stack(flat["bo"], 1)[live].contiguous()
    d = torch.stack(flat["bd"], 1)[live].contiguous()
    t_e = cuda_time_ms(lambda: bk.block_closest(
        o, d, frame.scene.accel, tmin, det_eps=det_eps), warmup=1, iters=5)
    big = torch.tensor(1e30, device=alive.device)
    bo = tuple(torch.where(alive, c, big) for c in flat["bo"])
    tested = _tested_blocks(rows, bo, tuple(flat["bd"]), alive, det_eps, tmin)
    bs, nb = rows.block_size, rows.num_blocks
    pairs_blocks = int(tested.sum())
    lanes = int(((rows.ids >= 0).sum(1).to(torch.float64)
                 * tested.sum(0).to(torch.float64)).sum())
    union = int(tested.view(-1, 32, nb).any(1).sum())
    warps = tested.shape[0] // 32
    live_warps = int(alive.view(-1, 32).any(1).sum())
    steps_old = union * bs
    steps_new = pairs_blocks * math.ceil(bs / 32)
    print(f"B {label}: {st.shape[0] // 16} tiles x 512, {live.numel()} live "
          f"rays in {live_warps} of {warps} warps; kernel "
          f"{t_b['median_ms']:.3f} ms, without lights (no shadow walks) "
          f"{t_dark['median_ms']:.3f} ms, E's closest-hit walk alone on the "
          f"live rays {t_e['median_ms']:.3f} ms (medians of 5; samples "
          f"{[round(x, 3) for x in t_b['samples_ms']]}, "
          f"{[round(x, 3) for x in t_dark['samples_ms']]}, "
          f"{[round(x, 3) for x in t_e['samples_ms']]})")
    print(f"  closest-hit walk, counted from the plain walk: {pairs_blocks} "
          f"(ray, block) pairs ({pairs_blocks / max(live.numel(), 1):.3f} a "
          f"live ray), {lanes} ray-triangle tests; one thread per ray: "
          f"{union} warp block loops ({union / max(live_warps, 1):.3f} a "
          f"live warp) = {steps_old} warp steps of one triangle, "
          f"{pairs_blocks / max(union, 1):.3f} of 32 lanes active a step "
          f"({pairs_blocks / max(32 * union, 1):.4f}); warp-cooperative: "
          f"{steps_new} warp steps of 32 triangles "
          f"({steps_old / max(steps_new, 1):.2f}x fewer)")


# ``--kernels``: an instrumented copy of csrc/megakernel.cu (built apart
# into build/walk_clocks/, never used by the package) adds clock64()
# counters to kernel B's walks; each (old, new) edit must find its text
_CLOCK_EDITS = [
    ('#include "trace_common.cuh"\n',
     '#include "trace_common.cuh"\n__device__ unsigned long long g_prof[16];\n'
     '__device__ __forceinline__ void prof_add(int k, long long v) {\n'
     '  if ((threadIdx.x & 31) == 0) atomicAdd(&g_prof[k], '
     '(unsigned long long)v);\n}\n'),
    # closest_coop: whole walk, its pair loops, pairs, warps
    ('  int b = active ? next_block(s, sh, o, inv, tmin, h.t, 0) : '
     's.num_blocks;\n',
     '  const long long q0 = clock64();\n  long long qp = 0, np = 0;\n'
     '  int b = active ? next_block(s, sh, o, inv, tmin, h.t, 0) : '
     's.num_blocks;\n'),
    ('    for (unsigned todo = __ballot_sync(kFull, b == bmin); todo;\n'
     '         todo &= todo - 1) {\n'
     '      const int src = __ffs(todo) - 1;\n      float po[3], pd[3];',
     '    const long long q1 = clock64();\n'
     '    np += __popc(__ballot_sync(kFull, b == bmin));\n'
     '    for (unsigned todo = __ballot_sync(kFull, b == bmin); todo;\n'
     '         todo &= todo - 1) {\n'
     '      const int src = __ffs(todo) - 1;\n      float po[3], pd[3];'),
    ('        take(h, t, u, v, id, bmin * s.block_size + j);\n    }\n',
     '        take(h, t, u, v, id, bmin * s.block_size + j);\n    }\n'
     '    qp += clock64() - q1;\n'),
    ('  }\n  return h;\n}\n\n// Any hit of the pair',
     '  }\n  if (np) {\n    prof_add(0, clock64() - q0);\n'
     '    prof_add(1, qp);\n    prof_add(2, np);\n    prof_add(3, 1);\n'
     '  }\n  return h;\n}\n\n'
     '// Any hit of the pair'),
    # occluded_coop
    ('  int b = active ? next_block(s, sh, p, inv, tmin, dist, 0) : '
     's.num_blocks;\n',
     '  const long long q0 = clock64();\n  long long qp = 0, np = 0;\n'
     '  int b = active ? next_block(s, sh, p, inv, tmin, dist, 0) : '
     's.num_blocks;\n'),
    ('    for (unsigned todo = __ballot_sync(kFull, b == bmin); todo;\n'
     '         todo &= todo - 1) {\n'
     '      const int src = __ffs(todo) - 1;\n      float pp[3], pl[3];',
     '    const long long q1 = clock64();\n'
     '    np += __popc(__ballot_sync(kFull, b == bmin));\n'
     '    for (unsigned todo = __ballot_sync(kFull, b == bmin); todo;\n'
     '         todo &= todo - 1) {\n'
     '      const int src = __ffs(todo) - 1;\n      float pp[3], pl[3];'),
    ('        blocked = true;\n    }\n',
     '        blocked = true;\n    }\n    qp += clock64() - q1;\n'),
    ('  }\n  return blocked;\n}\n\n// random_on_hemisphere',
     '  }\n  if (np) {\n    prof_add(4, clock64() - q0);\n'
     '    prof_add(5, qp);\n    prof_add(6, np);\n    prof_add(7, 1);\n'
     '  }\n  return blocked;\n}\n\n'
     '// random_on_hemisphere'),
    # block_closest_warp: the triangle tests before the shuffle tree
    ('  int bid = kIntMax, bj = kIntMax;\n#pragma unroll 4\n',
     '  int bid = kIntMax, bj = kIntMax;\n  const long long q2 = clock64();\n'
     '#pragma unroll 4\n'),
    ('#pragma unroll\n  for (int off = 16; off > 0; off >>= 1) {\n'
     '    const float ot',
     '  prof_add(10, clock64() - q2);\n#pragma unroll\n'
     '  for (int off = 16; off > 0; off >>= 1) {\n    const float ot'),
    # bounce_step_kernel: warps with a live lane
    ('  const bool live = in_range && r.alive > 0.0f;  // dead rays pass\n',
     '  const bool live = in_range && r.alive > 0.0f;  // dead rays pass\n'
     '  const long long q9 = clock64();\n'
     '  unsigned long long g0, g1;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));\n'
     '  const bool wlive = __any_sync(kFull, live);\n'),
    ('  if (!in_range) return;\n  store_ray(r, rt, st_out + so, '
     'rng_out + ro);',
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));\n'
     '  if ((threadIdx.x & 31) == 0) {\n'
     '    atomicMax(&g_prof[11], ~g0);\n    atomicMax(&g_prof[12], g1);\n'
     '    if (wlive) {\n      atomicMax(&g_prof[13], ~g0);\n'
     '      atomicMax(&g_prof[14], g1);\n      atomicMax(&g_prof[15], g0);\n'
     '    }\n  }\n'
     '  if (wlive) {\n    prof_add(8, clock64() - q9);\n    prof_add(9, 1);\n'
     '  }\n  if (!in_range) return;\n  store_ray(r, rt, st_out + so, '
     'rng_out + ro);'),
]
_CLOCK_READ = r"""
extern "C" int rt_walk_clocks(unsigned long long* host, int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  if (reset) {
    unsigned long long z[16] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
"""


def _clock_lib():
    """Build the instrumented copy of megakernel.cu -> its library."""
    import ctypes

    from raytracinginonesemester_tpu_torch.ops import _native

    csrc = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc")
    with open(os.path.join(csrc, "megakernel.cu")) as f:
        text = f.read()
    for old, new in _CLOCK_EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"walk clocks: the source changed near {old!r}")
        text = text.replace(old, new)
    out = os.path.join(REPO, "build", "walk_clocks")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "megakernel_clocks.cu")
    with open(src, "w") as f:
        f.write(text + _CLOCK_READ)
    lib_path = os.path.join(out, "librt_megakernel_clocks.so")
    subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-I", csrc, "-o",
                    lib_path, src], check=True, capture_output=True)
    lib = ctypes.CDLL(lib_path)
    _native._declare("megakernel", lib)
    lib.rt_walk_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rt_walk_clocks.restype = ctypes.c_int
    return lib


def _walk_clocks(label, frame, st, rng, lib):
    """Kernel B's walks through the instrumented library: clock64()
    cycles per warp, summed over the warps that had work."""
    import ctypes

    import torch

    from raytracinginonesemester_tpu_torch.ops import _native

    real = _native._LIBS.get("megakernel")
    want = frame.bounce(st, rng)
    buf = (ctypes.c_ulonglong * 16)()
    _native._LIBS["megakernel"] = lib
    try:
        frame.bounce(st, rng)  # warm
        lib.rt_walk_clocks(buf, 1)
        got = frame.bounce(st, rng)
        if lib.rt_walk_clocks(buf, 0):
            raise SystemExit("walk clocks: reading the counters failed")
    finally:
        _native._LIBS["megakernel"] = real
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    c = list(buf)
    per = lambda a, b: a / max(b, 1)
    print(f"  clock64 counters, {label} (instrumented copy, results "
          f"{'equal to' if same else 'DIFFER from'} the kernel's): {c[9]} "
          f"warps with a live lane, {per(c[8], c[9]):.0f} cycles each; "
          f"closest walk in {c[3]} warps, {per(c[0], c[3]):.0f} cycles and "
          f"{per(c[2], c[3]):.1f} pairs a warp, pair loops "
          f"{per(c[1], c[0]):.3f} of the walk, {per(c[1], c[2]):.0f} cycles "
          f"a pair of which the triangle tests {per(c[10], c[2]):.0f}; "
          f"shadow walks: {c[7]} warp walks, {per(c[4], c[7]):.0f} cycles "
          f"and {per(c[6], c[7]):.1f} pairs each, {per(c[5], c[6]):.0f} "
          "cycles a pair")
    t0 = ~c[11] & (2 ** 64 - 1)  # the first warp's start (globaltimer ns)
    print(f"  globaltimer: the kernel's warps span {(c[12] - t0) / 1e3:.1f} "
          f"us; warps with a live lane start from "
          f"{((~c[13] & (2 ** 64 - 1)) - t0) / 1e3:.1f} to "
          f"{(c[15] - t0) / 1e3:.1f} us and end by {(c[14] - t0) / 1e3:.1f} "
          "us")


def profile_kernels():
    """Kernels B and J at phase 11's full-width inputs (module
    docstring)."""
    import torch

    from chip_smoke import (FRAMES, H, W, Frame, Training, cpuonly_scene,
                            grad_scene, record_calls)
    from raytracinginonesemester_tpu_torch.ops import diff_gather as dg
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, resolve_wavefront)
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {_card()}")
    scene = frog_scene(W, H, device="cuda")
    _, cap = resolve_wavefront(scene, "wang", 1)
    main = Frame(scene)
    st, rng, _ = main.sorted_state(*main.emit(False))
    width = min(main.nt, (cap or main.nt) * FRAMES)
    clocks = _clock_lib()
    st, rng = st[:width * 16], rng[:width * 8]
    _profile_b("gpu, headline frog depth 1", main, st, rng)
    _walk_clocks("gpu", main, st, rng, clocks)
    del st, rng
    cpu = Frame(cpuonly_scene("cpuonly_mirror", "cuda", W, H),
                jitter="center")
    st, rng, _ = cpu.sorted_state(*cpu.emit(True))
    _profile_b("cpuonly, cpuonly_mirror depth 1", cpu, st, rng)
    _walk_clocks("cpuonly", cpu, st, rng, clocks)
    del st, rng

    tr = Training(grad_scene("cuda"))
    calls = record_calls(dg, ["segment_accum_rows"], tr.grads,
                         keep=16)["segment_accum_rows"]
    n_vert = tr.scene.geometry.vertices.shape[0]
    for what, call in (("material table, first launch", calls[0]),
                       ("vertex table", next(c for c in calls
                                             if c[0][2] == n_vert))):
        (idx, ct, n_rows), _ = call
        keep = (idx >= 0) & (idx < n_rows)
        i_lib, ct_lib = idx[keep].long(), ct[keep]
        counts = torch.bincount(i_lib, minlength=n_rows)
        t_j = cuda_time_ms(lambda: dg.segment_accum_rows(idx, ct, n_rows),
                           warmup=1, iters=5)
        t_lib = cuda_time_ms(lambda: torch.zeros(
            n_rows, ct.shape[1], device=ct.device).index_add_(
                0, i_lib, ct_lib), warmup=1, iters=5)
        plan = dg.segment_plan(idx, n_rows)
        t_glue = cuda_time_ms(lambda: dg.segment_plan(idx, n_rows),
                              warmup=1, iters=5)
        t_kern = cuda_time_ms(lambda: dg.segment_accum_planned(
            ct, plan, n_rows), warmup=1, iters=5)
        print(f"J, {what}: {tuple(ct.shape)} into {n_rows} rows, longest "
              f"run {int(counts.max())} rays, {int((counts > 0).sum())} "
              f"bins in use; kernel + glue {t_j['median_ms']:.4f} ms "
              f"(samples {[round(x, 4) for x in t_j['samples_ms']]}), the "
              f"glue alone {t_glue['median_ms']:.4f}, the kernels alone on "
              f"its plan {t_kern['median_ms']:.4f}, index_add_ "
              f"{t_lib['median_ms']:.4f} ms (medians of 5)")


class _patched:
    """Within the block, each ``(module, name, label)`` function is
    wrapped to add a CUDA event pair around every call under ``label``
    in ``parts`` (the events sit on the stream its kernels use)."""

    def __init__(self, parts, patched):
        self.parts, self.patched, self.real = parts, patched, {}

    def __enter__(self):
        for mod, name, label in self.patched:
            f = self.real[(mod, name)] = getattr(mod, name)

            def timed(*a, _f=f, _label=label, **k):
                with _part(self.parts, _label):
                    return _f(*a, **k)

            timed.__dict__ = f.__dict__  # the launch counters live there
            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for (mod, name), f in self.real.items():
            setattr(mod, name, f)
        return False


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
