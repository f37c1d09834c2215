"""Where the time of the port's main path goes, on one CUDA device.

    python scripts/profile_torch_main_path.py [--frames 16] [--width 1920 --height 1080]
        [--jitter wang|reference_cpu]
    python scripts/profile_torch_main_path.py --grad [--frames 8]
    python scripts/profile_torch_main_path.py --large
    python scripts/profile_torch_main_path.py --kernels [--parent DIR]
    python scripts/profile_torch_main_path.py --streamed [--parent DIR]
    python scripts/profile_torch_main_path.py --render [--parent DIR]
    python scripts/profile_torch_main_path.py --staged [--parent DIR]
    python scripts/profile_torch_main_path.py --times [--streamed | --render
        | --staged] [--root DIR]

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
``--kernels`` profiles kernels A, F, B and J at ``chip_smoke.py`` phase
11's full-width inputs.  A (emit) on the headline frog, binned and with
the flat scan, and on ``cpuonly_mirror`` (binned): each timed, also
without its lights, and kernel F on its facing shadow rays (its shadow
walk alone); its plain version, run on the card with its walks recorded,
counts the tiles with work, live rays, hits, facing rays and the pairs
of its closest and shadow walks, and a SIMT count of the one-thread
shadow walk (a warp of 32 consecutive rays steps through a block's slots
as long as its slowest walking lane, up to that lane's first blocker).
F on the first shadow launch of phase 8's 32-sample cpuonly render:
parked rays, rays that pass some block's slab test (live), its time and
the time of each part alone.
B (gpu dialect) on the headline frog's 4,080 sorted
tiles at depth 1 and B (cpuonly) on ``cpuonly_mirror``'s: each timed,
also without its lights (the closest-hit walk and the shading alone);
kernel E without normals on B's live rays (the same closest-hit walk,
its rays listed); a SIMT count of a one-thread-per-ray walk from the
plain version's (ray, block) tests (a warp of 32 rays runs a block's
triangle loop when any of its lanes passes the slab test) against the
pairs the warp-cooperative walk tests, 32 lanes to a pair.  ``clock64()``
cycles per warp of A's walks and of B's, with ``%globaltimer`` spans,
come from an instrumented copy of ``csrc/megakernel.cu`` (built apart
under ``build/walk_clocks/`` by exact text edits, ``_CLOCK_EDITS`` and
``_A_EDITS_LIST``: a change to these walks must keep the edits
matching, or the mode stops and names the edit; its results must equal
the kernel's).
J on the
inputs of its launches in one grad-bench step (the material and vertex
tables): the wrapper (kernel + its sort glue), the glue alone, the
kernels alone on the glue's plan, and ``index_add_``.
``--parent DIR`` (with ``--kernels``) also times A (each variant) and F
as the tree at ``DIR`` computes them (e.g. the parent commit unpacked
with ``git archive`` into ``build/parent``), in a process of its own
that imports ``DIR``'s package (``--times --root DIR``), in turns with
this tree's (parent, this, this, parent; medians of 5), the outputs
compared by digest.
``--streamed`` profiles kernels G and I at ``chip_smoke.py`` phase 10's
full-width inputs (the large frog's 2,073,600 pixel-center camera rays
for G, their shadow rays to the frog's light for I, the missed rays'
shade points parked with a zero direction): each one's wrapper, the plan
alone (the rays' rows and ``tile_visit_plan_fast``), the operand packing
alone (``_stream_grid_operands``) and the kernel alone on operands built
once, medians of 5; its plain walk, run on the card with every visit
logged, counts the tiles with a plan and those that stage a block, the
staged blocks (all, and the heaviest tile's), the lanes that pass a
staged block's slab test, the (ray, block) pairs and the ray-triangle
tests, the CUDA walk's own tests and tested blocks, and the moving,
parked, hit or blocked rays; an instrumented copy of
``csrc/block_stream.cu`` (built apart under ``build/walk_clocks/`` by
exact text edits, ``_STREAM_EDITS``; its results must equal the
kernel's) records
per CTA its ``%globaltimer`` start and end, its ``clock64()`` cycles and
those of its staging, testing and gating, from which it prints the
CTAs resident at once, the shares, and when the last CTA ends against
the mean; G's and I's kernels alone with the tiles launched longest
plan first (the wrapper's order) and in plan order (tile 0, 1, ...), in
turns, outputs compared by digest.  ``--parent DIR`` (with
``--streamed``) times G's and I's
wrappers and kernels alone as the tree at ``DIR`` computes them, in
turns with this tree's (parent, this, this, parent), outputs compared
by digest.  ``--streamed`` also profiles kernel H on the same rays
(closest on the camera rays, occluded on the shadow rays): its wrapper,
its glue alone (the rays padded to whole chunks, the gate, the tile
order) and its kernel alone; its plain sweep, counted on the card (the
gate's slabs and blocks a chunk, staged blocks, passing lanes a staged
block, pairs, the CUDA walk's tests and tested blocks); per-CTA clocks
(``_STREAM_EDITS``, or ``_H_EDITS_SOLO`` for H as first ported); its
tiles most gated blocks first against index order, in turns; and, with
``--parent``, its wrapper and kernel in the parent's turns.
``--render`` profiles kernel D on ``chip_smoke.py`` phase 11's three
rows (the frog 1080p at depth 8 with the binned plan, as
``RT_WAVEFRONT=0`` renders it; the terminal frog at depth 4;
``cpuonly_mirror`` at 1080p): the kernel alone and without its lights;
its plain version on the card bounce by bounce (live paths,
closest-walk and shadow-walk tests by depth; per warp of 32 pixels the
depths its deepest path runs against its lanes' mean); ``clock64()``
cycles per warp of an instrumented copy (built apart under
``build/walk_clocks/`` by ``_D_EDITS_BOUNCE`` and the edit set of the
design in the source, ``_D_EDITS_WARP``) split into
the closest-hit walks, the light loops and the rest of the bounces, the
depths a warp runs, and each CTA's ``%globaltimer`` start and end; the
variants of ``_D_VARIANTS`` (the binned depth 0 from device memory; 32,
16 or 4 paths a warp) in turns with this tree's kernel; and, with
``--parent DIR``, the three rows through ``DIR``'s tree in turns.
``--staged`` profiles kernel E (the staged integrator's closest hit) on
the inputs of each depth of one frog 1080p ``reference_cpu`` frame, on
the first of phase 8's ``cpuonly_mirror`` (area light, 32 samples) and
on the large frog's camera rays (off its path), and kernel C (the
overflow resume) on phase 11's two rows (the headline frog's and
``cpuonly_mirror``'s sorted depth-0 state at 1080p, as the cap-8
overflow renders feed it): E's plain version on the card counts the
rays, parked ones, those whose slab test passes some block, the hits,
the closest-walk and shadow-walk pairs and the (ray, light) entries that
face their light and those of them that pass a slab test; C's, bounce by
bounce, the live rays and both walks' tests by depth and, per warp of
32, 8 or 4 rays, the depths its loop runs against its rays'; each
kernel's time (medians of 5) and the device time of each launch
(``torch.profiler``); ``clock64()`` cycles per warp of an instrumented
copy (built apart under ``build/walk_clocks/`` by the edit set of each
kernel's design in the source, ``_E_EDIT_SETS``, ``_C_EDIT_SETS``, and
``_D_EDITS_BOUNCE``): E's closest walk, shadow walks and the rest, C's
closest walks, light loops and the rest with its depths, and each
launch's CTAs' ``%globaltimer`` start and end; the variants of
``_STAGED_VARIANTS`` in turns with this tree's kernels; and, with
``--parent DIR``, every row, and the frames of C's two scenes at a
capacity of 8 tiles (``chip_smoke.py`` phases 5 and 7, which overflow
into C), through ``DIR``'s tree in turns.
The full table is also written to ``chiprun_out/profile_main_path.txt``
(``profile_grad.txt`` with ``--grad``, ``profile_large.txt`` with
``--large``).
"""

import argparse
import dataclasses
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
    ap.add_argument("--streamed", action="store_true")
    ap.add_argument("--render", action="store_true")
    ap.add_argument("--staged", action="store_true")
    ap.add_argument("--parent", default=None,
                    help="with --kernels, --streamed, --render or "
                         "--staged: a tree of the port (e.g. the parent "
                         "commit unpacked with git archive) whose kernels A "
                         "and F, G, I and H, D, or E and C are timed in "
                         "turns with this tree's")
    ap.add_argument("--times", action="store_true",
                    help="print the --parent timings of A and F (with "
                         "--streamed: G, I and H; with --render: D; with "
                         "--staged: E and C) as JSON")
    ap.add_argument("--root", default=None,
                    help="with --times: import the package from this tree")
    args = ap.parse_args()
    if args.times:
        if args.root:
            sys.path.insert(0, os.path.abspath(args.root))
        import json
        print(json.dumps(streamed_times() if args.streamed
                         else render_times() if args.render
                         else staged_times() if args.staged
                         else kernel_times()))
        return None
    if args.staged:
        return profile_staged(args.parent)
    if args.render:
        return profile_render(args.parent)
    if args.streamed:
        return profile_streamed(args.parent)
    if args.kernels:
        return profile_kernels(args.parent)
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
                    if "streamed_kernel" in key)
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
     '#include "trace_common.cuh"\n__device__ unsigned long long g_prof[32];\n'
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
    ('  }\n  return blocked;\n}\n\n// ---- shadow lists',
     '  }\n  if (np) {\n    prof_add(4, clock64() - q0);\n'
     '    prof_add(5, qp);\n    prof_add(6, np);\n    prof_add(7, 1);\n'
     '  }\n  return blocked;\n}\n\n'
     '// ---- shadow lists'),
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
    unsigned long long z[32] = {0};
    return (int)cudaMemcpyToSymbol(g_prof, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(host, g_prof, sizeof(g_prof));
}
"""
# counters 16-31: kernel A.  prof_sum adds a value over the lanes that
# run it together (one atomic per warp); clock_warp waits for the warp.
_A_HELPERS = (
    '__device__ __forceinline__ void prof_sum(int k, long long v) {\n'
    '  const unsigned m = __activemask();\n'
    '  const unsigned s = __reduce_add_sync(m, (unsigned)v);\n'
    '  if ((threadIdx.x & 31) == __ffs(m) - 1) atomicAdd(&g_prof[k], '
    '(unsigned long long)s);\n}\n'
    '__device__ __forceinline__ long long clock_warp() {\n'
    '  __syncwarp();\n  return clock64();\n}\n'
    '__device__ __forceinline__ void prof_span(unsigned long long g0) {\n'
    '  unsigned long long g1;\n'
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));\n'
    '  if ((threadIdx.x & 31) == 0) {\n'
    '    atomicMax(&g_prof[24], ~g0);\n    atomicMax(&g_prof[25], g1);\n'
    '  }\n}\n')
def _build_apart(text, name, include, source="megakernel"):
    """Compile ``source``.cu text ``text`` into build/walk_clocks/ (never
    used by the package) -> the loaded library, its C interface declared."""
    import ctypes

    from raytracinginonesemester_tpu_torch.ops import _native

    out = os.path.join(REPO, "build", "walk_clocks")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, f"{name}.cu")
    with open(src, "w") as f:
        f.write(text)
    lib_path = os.path.join(out, f"lib{name}.so")
    built = subprocess.run([_native._nvcc(), *_native.NVCC_FLAGS, "-I",
                            include, "-o", lib_path, src], check=True,
                           capture_output=True, text=True)
    from chip_smoke import ptxas_summary

    print(f"  {name} (built apart): {ptxas_summary(built.stderr)}")
    lib = ctypes.CDLL(lib_path)
    _native._declare(source, lib)
    return lib


def _clock_lib():
    """Build the instrumented copy of megakernel.cu -> (its library, the
    name of kernel A's design it instruments)."""
    import ctypes

    csrc = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc")
    with open(os.path.join(csrc, "megakernel.cu")) as f:
        text = f.read()
    a_sets = {"shadow lists": _A_EDITS_LIST}
    found = [k for k, edits in a_sets.items()
             if all(text.count(old) == 1 for old, _ in edits)]
    if not found:
        raise SystemExit("walk clocks: kernel A's source matches no edit set")
    for old, new in _CLOCK_EDITS + a_sets[found[0]]:
        if text.count(old) != 1:
            raise SystemExit(f"walk clocks: the source changed near {old!r}")
        text = text.replace(old, new)
    lib = _build_apart(text + _CLOCK_READ, "megakernel_clocks", csrc)
    lib.rt_walk_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rt_walk_clocks.restype = ctypes.c_int
    return lib, found[0]


class _using:
    """Within the block, the wrappers of ``source``.cu's kernels launch
    through ``lib``."""

    def __init__(self, lib, source="megakernel"):
        self.lib, self.source = lib, source

    def __enter__(self):
        from raytracinginonesemester_tpu_torch.ops import _native

        self.real = _native.load(self.source)
        if self.lib is not None:
            _native._LIBS[self.source] = self.lib
        return self

    def __exit__(self, *exc):
        from raytracinginonesemester_tpu_torch.ops import _native

        _native._LIBS[self.source] = self.real
        return False


def _walk_clocks(label, frame, st, rng, lib):
    """Kernel B's walks through the instrumented library: clock64()
    cycles per warp, summed over the warps that had work."""
    import ctypes

    import torch

    want = frame.bounce(st, rng)
    buf = (ctypes.c_ulonglong * 32)()
    with _using(lib):
        frame.bounce(st, rng)  # warm
        lib.rt_walk_clocks(buf, 1)
        got = frame.bounce(st, rng)
        if lib.rt_walk_clocks(buf, 0):
            raise SystemExit("walk clocks: reading the counters failed")
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

# A as it is now (three launches, the shadow rays listed; kEmitSplit
# threads a ray in the first): per warp of
# emit_kernel with work, the kernel after its sky test (16, 17), the
# closest walk (18), the light loop, which lists the shadow rays (19);
# per group of the list walk, its cycles (20) and the groups (21);
# entries listed (22); globaltimer of emit_kernel's warps (24, 25) and
# of those with work (26, 27), of the list walk's first and last group
# (28, 29).  The group loop (take_groups) is F's and E's too: counters
# 20-22, 28 and 29 count whichever list walk runs.
_A_EDITS_LIST = [
    ('struct Ray {\n', _A_HELPERS + 'struct Ray {\n'),
    ('  } else if (tile >= 0) {\n    if constexpr (W == kList)\n',
     '  }\n  const long long qa = W == kList ? clock_warp() : 0;\n'
     '  if constexpr (W == kCapture || W == kFlags) {\n'
     '  } else if (tile >= 0) {\n    if constexpr (W == kList)\n'),
    ('    if (c->owner) store_hit(c->q, c->gid, h);\n  }\n',
     '    if (c->owner) store_hit(c->q, c->gid, h);\n  }\n'
     '  if (W == kList) prof_add(18, clock_warp() - qa);\n'),
    ('  for (int li = 0; li < s.n_lights; ++li) {\n'
     '    const float* L = sh.lights + 8 * li;\n',
     '  const long long ql = W == kList ? clock_warp() : 0;\n'
     '  for (int li = 0; li < s.n_lights; ++li) {\n'
     '    const float* L = sh.lights + 8 * li;\n'),
    ('  }\n  if constexpr (W == kList || W == kCapture) return;\n',
     '  }\n  if (W == kList) prof_add(19, clock_warp() - ql);\n'
     '  if constexpr (W == kList || W == kCapture) return;\n'),
    ('  while (n > 1 && n * warps > total) n >>= 1;\n  for (;;) {\n',
     '  while (n > 1 && n * warps > total) n >>= 1;\n'
     '  if (threadIdx.x == 0 && blockIdx.x == 0)\n'
     '    atomicAdd(&g_prof[22], (unsigned long long)total);\n'
     '  for (;;) {\n    const long long qg = clock64();\n'
     '    unsigned long long gg;\n'
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gg));\n'),
    ('    if (e0 >= total) return;\n',
     '    if (e0 >= total) return;\n'
     '    if (lane == 0) atomicMax(&g_prof[28], ~gg);\n'),
    ('    walk(active ? q.list[e] : 0, active);\n  }\n}\n',
     '    walk(active ? q.list[e] : 0, active);\n'
     '    prof_add(20, clock64() - qg);\n    prof_add(21, 1);\n'
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gg));\n'
     '    if (lane == 0) atomicMax(&g_prof[29], gg);\n  }\n}\n'),
    ('            int* rng_out, Shadows q) {\n'
     '  const int thread = blockIdx.x * kThreads + threadIdx.x;\n',
     '            int* rng_out, Shadows q) {\n  unsigned long long gk;\n'
     '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gk));\n'
     '  const int thread = blockIdx.x * kThreads + threadIdx.x;\n'),
    ('              rng_out + (size_t)tile * 8 * rt + lane);\n    return;\n'
     '  }\n  const Shared sh = stage_shared(s, s.cand_chunk != 0);\n',
     '              rng_out + (size_t)tile * 8 * rt + lane);\n'
     '    prof_span(gk);\n    return;\n  }\n'
     '  const long long qe = clock_warp();\n'
     '  const Shared sh = stage_shared(s, s.cand_chunk != 0);\n'),
    ('  bounce<CPU, false, kList>(s, sh, cam, r, s.cand_chunk ? tile : -1, '
     'nullptr,\n                            owner, &c);\n',
     '  bounce<CPU, false, kList>(s, sh, cam, r, s.cand_chunk ? tile : -1, '
     'nullptr,\n                            owner, &c);\n'
     '  prof_add(16, clock_warp() - qe);\n  prof_add(17, 1);\n'
     '  prof_span(gk);\n  if ((threadIdx.x & 31) == 0) {\n'
     '    atomicMax(&g_prof[26], ~gk);\n'
     '    unsigned long long g1;\n'
     '    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));\n'
     '    atomicMax(&g_prof[27], g1);\n  }\n'),
]


# F as the direct cooperative walk (a variant, timed beside the kernel):
# lanes 0-7 of a warp own a ray each and walk it with occluded_coop in
# the first launch; nothing is listed, so the list walk has nothing to do
_F_EDITS_DIRECT = [
    ('  const int gid = blockIdx.x * kThreads + threadIdx.x;\n'
     '  bool listed = false;\n  if (gid < n_rays) {\n'
     '    const float o[3] = {orig[3 * gid], orig[3 * gid + 1], '
     'orig[3 * gid + 2]};\n',
     '  const int wl = threadIdx.x & 31;\n'
     '  const int gid =\n'
     '      (blockIdx.x * kThreads + threadIdx.x) / 32 * kRaysPerWarp + wl;\n'
     '  const bool in_range = wl < kRaysPerWarp && gid < n_rays;\n'
     '  float row[9] = {0, 0, 0, 1, 1, 1, 0, 0, 0};\n'
     '  if (in_range) {\n    for (int c = 0; c < 3; ++c) {\n'
     '      row[c] = orig[3 * gid + c];\n      row[3 + c] = dir[3 * gid + c];\n'
     '    }\n    row[6] = tmin[gid];\n    row[7] = row[8] = tmax[gid];\n  }\n'
     '  const bool b = occluded_coop(s, sh, row, row + 3, row[6], row[7], '
     'row[8],\n                               in_range);\n'
     '  if (in_range) q.flags[gid] = b;\n  bool listed = false;\n'
     '  if (false) {\n'
     '    const float o[3] = {orig[3 * gid], orig[3 * gid + 1], '
     'orig[3 * gid + 2]};\n'),
    ('    q.flags[gid] = 0;\n  }\n  list_append(q, listed, gid);\n',
     '  }\n'),
    ('  occluded_kernel<<<blocks_for(n_rays), kThreads, smem, st>>>(',
     '  occluded_kernel<<<coop_blocks_for(n_rays, kRaysPerWarp), kThreads, '
     'smem, st>>>('),
]


def _group_edits(n):
    """This tree's shadow-list walk with groups of up to ``n`` entries a
    warp (a variant) in place of kListRays."""
    return [('  take_groups(q, kListRays, [&](int entry, bool active) {\n',
             f'  take_groups(q, {n}, [&](int entry, bool active) {{\n')]


def _variant_lib(edits, name):
    """This tree's megakernel.cu with ``edits`` applied, built apart ->
    its library (None when an edit does not find its text)."""
    csrc = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc")
    with open(os.path.join(csrc, "megakernel.cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    return _build_apart(text, name, csrc)

def _simt_shadow(rows, p, ld, dist, facing, det_eps, tmin, tmax):
    """The one-thread-per-ray shadow walk of ``megakernel._occluded_plain``
    counted SIMT-wise over warps of 32 consecutive rays -> (warp steps,
    lane steps, the facing rays, the blocks each walks): a lane that
    passes a block's slab test steps through its slots up to its first
    blocker (every slot if none), and its warp steps as long as its
    slowest such lane; a ray walks the blocks whose slab test passes up
    to and including its first with a blocker."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    tmax = dist if tmax is None else tmax
    sel = facing.nonzero().squeeze(1)
    warp = sel // 32
    n_warps = facing.numel() // 32 + 1
    pf = tuple(c[sel] for c in p)
    lf = tuple(c[sel] for c in ld)
    inv = tuple(1.0 / c for c in lf)
    tmin_t = torch.full_like(dist[sel], tmin)
    dist_f, tmax_f = dist[sel], tmax[sel]
    walking = torch.ones(sel.numel(), dtype=torch.bool, device=sel.device)
    bs = rows.block_size
    warp_steps = lane_steps = 0
    blocks = torch.zeros(sel.numel(), dtype=torch.int64, device=sel.device)
    for b in range(rows.num_blocks):
        idx = (mk._slab(rows.aabb[b], pf, inv, tmin_t, dist_f)
               & walking).nonzero().squeeze(1)
        if idx.numel() == 0:
            continue
        blocks[idx] += 1
        tri = tuple(rows.tri[k, b][None, :] for k in range(9))
        live = rows.ids[b][None, :] >= 0
        n = torch.zeros(sel.numel(), dtype=torch.int64, device=sel.device)
        for ch in idx.split(8192):
            t, _, _ = mk._mt(tuple(c[ch, None] for c in pf),
                             tuple(c[ch, None] for c in lf), tri, det_eps,
                             tmin, tmax_f[ch, None])
            hits = live & (t < mk.F32_MAX)
            hit = hits.any(dim=1)
            first = hits.to(torch.int32).argmax(dim=1).to(torch.int64)
            n[ch] = torch.where(hit, first + 1, bs)
            walking[ch] = walking[ch] & ~hit
        lane_steps += int(n.sum())
        per_warp = torch.zeros(n_warps, dtype=torch.int64,
                               device=sel.device).scatter_reduce_(
            0, warp, n, "amax")
        warp_steps += int(per_warp.sum())
    return warp_steps, lane_steps, sel, blocks


def _schedules(walked):
    """The (ray, block) pairs of the cooperative shadow walk (each ray's
    blocks up to its first with a blocker) as three schedules would give
    them to warps: the rays of a CTA of 128 listed and walked by its 4
    warps, 8 rays a group in turn; 8 rays a warp by ray index (B's); and
    one list of every ray, 8 to a group, which the warps of a full card
    take in turn."""
    import torch

    ray = torch.cat([r for r, _ in walked])
    blk = torch.cat([b for _, b in walked])
    on = blk > 0
    ray, blk = ray[on], blk[on]
    if ray.numel() == 0:
        return
    cta_max = 0
    for c in torch.unique(ray // 128).tolist():
        groups = blk[ray // 128 == c].split(8)
        sums = [int(g.sum()) for g in groups]
        cta_max = max(cta_max, max(sum(sums[w::4]) for w in range(4)))
    by8 = torch.zeros(int(ray.max()) // 8 + 1, dtype=torch.int64,
                      device=ray.device).index_add_(0, ray // 8, blk)
    groups = blk.split(8)
    print(f"  cooperative shadow walk: {ray.numel()} rays walk "
          f"{int(blk.sum())} (ray, block) pairs, {float(blk.float().mean()):.2f}"
          f" a ray, at most {int(blk.max())}; the most pairs a warp walks: "
          f"{cta_max} (a CTA's list on its 4 warps), {int(by8.max())} (8 rays "
          f"a warp by index), {max(int(g.sum()) for g in groups)} a group "
          f"of one list (mean {int(blk.sum()) / len(groups):.1f})")


def _emit_call(frame, binned, rows=None):
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    return lambda: mk.emit_tiles(
        frame.scene, frame.xs, frame.ys, 0, plan=frame.plan,
        cand_plan=frame.cand if binned else None,
        rows=frame.rows if rows is None else rows, **frame.kw)


def _profile_a(label, frame, binned, clocks):
    """Kernel A on one full-width input (``chip_smoke.py`` phase 11's):
    its time, its time without the scene's lights, F on its facing shadow
    rays (its shadow walk alone); live tiles, rays, hits, facing rays and
    the pairs of its closest and shadow walks, counted by its plain
    version on the card; the SIMT count of the one-thread shadow walk;
    and the instrumented copy's clock64() counters."""
    import dataclasses

    import torch

    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    rows = frame.rows
    dark = dataclasses.replace(rows, lights=rows.lights[:0].contiguous())
    emit = _emit_call(frame, binned)
    t_a = cuda_time_ms(emit, warmup=1, iters=5)
    t_dark = cuda_time_ms(_emit_call(frame, binned, dark), warmup=1, iters=5)

    # the plain version, its closest and shadow walks recorded
    rec = {"closest": [], "occluded": []}
    c_name = "_closest_binned_plain" if binned else "_closest_plain"
    real = {c_name: getattr(mk, c_name), "_occluded_plain": mk._occluded_plain}

    def recording(name, key):
        def f(*a, **k):
            out = real[name](*a, **k)
            rec[key].append((a, k, out))
            return out
        return f

    setattr(mk, c_name, recording(c_name, "closest"))
    mk._occluded_plain = recording("_occluded_plain", "occluded")
    try:
        stats = {}
        want = frame.emit_plain(binned, stats=stats)
    finally:
        for name, f in real.items():
            setattr(mk, name, f)
    got = emit()
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    (_, _, _, alive, _, _), _, best = rec["closest"][0]
    tiles = alive.view(-1, mk.RAY_TILE).any(dim=1)
    hits = int((best.t < mk.F32_MAX).sum())
    chunks = (int(frame.cand.meta[:, 1][tiles].sum()) if binned else None)
    facing = shadow_pairs = blocked = warp_steps = lane_steps = 0
    walks, walked = [], []
    for a, k, (blk, pairs) in rec["occluded"]:
        _, p, ld, dist, fac, det_eps, tmin = a[:7]
        tmax = a[7] if len(a) > 7 else k.get("tmax")
        facing += int(fac.sum())
        shadow_pairs += int(pairs)
        blocked += int((blk & fac).sum())
        ws, ls, ray, n_blocks = _simt_shadow(rows, p, ld, dist, fac,
                                             det_eps, tmin, tmax)
        warp_steps, lane_steps = warp_steps + ws, lane_steps + ls
        walked.append((ray, n_blocks))
        sel = fac.nonzero().squeeze(1)
        walks.append((torch.stack(p, 1)[sel].contiguous(),
                      torch.stack(ld, 1)[sel].contiguous(), float(tmin),
                      (dist if tmax is None else tmax)[sel].contiguous(),
                      blk[sel]))
    grid = frame.scene.accel
    f_same = all(torch.equal(bk.block_occluded(o, d, grid, t0, t1), b)
                 for o, d, t0, t1, b in walks)
    t_f = cuda_time_ms(lambda: [bk.block_occluded(o, d, grid, t0, t1)
                                for o, d, t0, t1, _ in walks],
                       warmup=1, iters=5)
    closest_pairs = int(best.pairs)
    print(f"A {label}: {frame.nt} tiles x 512, {int(tiles.sum())} with "
          f"work, {int(alive.sum())} live rays, {hits} hits, {facing} "
          f"facing shadow rays ({blocked} blocked)"
          + (f", {chunks} candidate chunks" if binned else "")
          + f"; pairs {int(stats['pairs'])}: closest walk {closest_pairs}, "
          f"shadow walks {shadow_pairs} "
          f"({shadow_pairs / max(facing, 1):.1f} a facing ray); kernel "
          f"{t_a['median_ms']:.3f} ms, without lights "
          f"{t_dark['median_ms']:.3f} ms, F on its facing shadow rays "
          f"{t_f['median_ms']:.3f} ms (medians of 5; samples "
          f"{[round(x, 3) for x in t_a['samples_ms']]}, "
          f"{[round(x, 3) for x in t_dark['samples_ms']]}, "
          f"{[round(x, 3) for x in t_f['samples_ms']]}); kernel "
          f"{'equals' if same else 'DIFFERS from'} its plain version, F's "
          f"flags {'equal' if f_same else 'DIFFER from'} A's walks'")
    print(f"  one-thread shadow walk, counted from the plain walk: "
          f"{warp_steps} warp steps of one triangle, {lane_steps} lane "
          f"steps, {lane_steps / max(warp_steps, 1):.2f} of 32 lanes active "
          f"a step; {warp_steps / max(facing / 32, 1):.0f} steps a warp's "
          "worth of facing rays")
    _schedules(walked)
    _launch_split(f"A {label}", emit)
    _a_clocks(label, emit, clocks)


def _launch_split(label, fn, calls=5):
    """The device time of each CUDA kernel that ``fn`` launches, a call,
    from ``torch.profiler`` over ``calls`` calls after a warm one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / calls / 1e3)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and e.self_device_time_total > 0]
    print(f"  {label}, device time a call by kernel (torch.profiler, "
          f"{calls} calls): " + "; ".join(
              f"{k.split('(')[0]} {ms:.3f} ms" for k, ms in
              sorted(rows, key=lambda r: -r[1])[:6]))


def _a_clocks(label, emit, clocks):
    """Kernel A through the instrumented library: clock64() cycles per
    warp with work, split into the closest walk and the light loop, the
    shadow walks' cycles, and globaltimer spans."""
    import ctypes

    import torch

    lib, design = clocks
    want = emit()
    buf = (ctypes.c_ulonglong * 32)()
    with _using(lib):
        emit()  # warm
        lib.rt_walk_clocks(buf, 1)
        got = emit()
        if lib.rt_walk_clocks(buf, 0):
            raise SystemExit("walk clocks: reading the counters failed")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    c = list(buf)
    per = lambda a, b: a / max(b, 1)
    mask = 2 ** 64 - 1
    t0 = ~c[24] & mask  # the first warp's start (globaltimer ns)
    print(f"  clock64 counters, A {label} ({design}; instrumented copy, "
          f"results {'equal to' if same else 'DIFFER from'} the kernel's): "
          f"{c[17]} warps with work, {per(c[16], c[17]):.0f} cycles each: "
          f"closest walk {per(c[18], c[17]):.0f}, light loop "
          f"{per(c[19], c[17]):.0f}; "
          + f"{c[22]} shadow rays listed, walked in {c[21]} groups (up "
          f"to 4 rays a warp), {per(c[20], c[21]):.0f} cycles a group, from "
          f"{((~c[28] & mask) - t0) / 1e3:.1f} to "
          f"{(c[29] - t0) / 1e3:.1f} us"
          + "; globaltimer: the kernel's "
          f"warps span {(c[25] - t0) / 1e3:.1f} us, the warps with work "
          f"start from {((~c[26] & mask) - t0) / 1e3:.1f} us and end by "
          f"{(c[27] - t0) / 1e3:.1f} us")


def _turns(label, fn, parent, name="parent"):
    """``fn`` through the ``parent`` library (the parent tree's, or a
    variant's) and through this tree's, in turns (parent, this, this,
    parent), medians of 5 each; outputs compared."""
    import torch

    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    def run(lib):
        with _using(lib):
            out = fn()
            return out, cuda_time_ms(fn, warmup=1, iters=5)["median_ms"]

    want, p1 = run(parent)
    got, c1 = run(None)
    _, c2 = run(None)
    _, p2 = run(parent)
    out = got if isinstance(got, (tuple, list)) else (got,)
    ref = want if isinstance(want, (tuple, list)) else (want,)
    same = all(torch.equal(a, b) for a, b in zip(out, ref))
    print(f"  {label}, {name} vs this tree in turns: {name} {p1:.3f}, "
          f"this {c1:.3f}, this {c2:.3f}, {name} {p2:.3f} ms; outputs "
          f"{'equal' if same else 'DIFFER'}")


def _f_call():
    """Kernel F on phase 11's input (``_profile_f``'s) -> a call of it."""
    from chip_smoke import H, W, cpuonly_scene, record_calls
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.render.renderer import render_scene

    soft = cpuonly_scene("cpuonly_mirror", "cuda", W, H, radius=0.15,
                         shadow_samples=32, diffuse_bounce=True)
    (fo, fd, grid, ftmin, ftmax), fkw = record_calls(
        integrator, ["block_occluded"], lambda: render_scene(soft),
        keep=1)["block_occluded"][0]
    return lambda: bk.block_occluded(fo, fd, grid, ftmin, ftmax, **fkw)


def _profile_f():
    """Kernel F on ``chip_smoke.py`` phase 11's input: the first shadow
    launch (depth 0, first disk sample) of the staged cpuonly_mirror
    render with a 32-sample area light; its rays split into parked ones
    (origin off the grid, as the integrator parks missed shade points),
    the ones whose slab test passes some block (live), and the rest."""
    import torch

    from chip_smoke import H, W, cpuonly_scene, record_calls
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.render.renderer import render_scene
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    soft = cpuonly_scene("cpuonly_mirror", "cuda", W, H, radius=0.15,
                         shadow_samples=32, diffuse_bounce=True)
    call = record_calls(integrator, ["block_occluded"],
                        lambda: render_scene(soft), keep=1)["block_occluded"]
    (fo, fd, grid, ftmin, ftmax), fkw = call[0]
    r, dev = fo.shape[0], fo.device
    rows = bk.grid_rows(grid)
    t0, t1 = bk._per_ray(ftmin, r, dev), bk._per_ray(ftmax, r, dev)
    parked = ~(fo.abs() < 1e29).all(dim=1)
    inv = tuple(1.0 / fd[:, k, None] for k in range(3))
    live = mk._slab(rows.aabb.T[:, None, :],
                    tuple(fo[:, k, None] for k in range(3)), inv,
                    t0[:, None], t1[:, None]).any(dim=1)
    stats = {}
    want = bk.block_occluded_plain(fo, fd, grid, ftmin, ftmax, stats=stats,
                                   **fkw)
    fn = lambda: bk.block_occluded(fo, fd, grid, ftmin, ftmax, **fkw)
    same = torch.equal(fn(), want)
    t_f = cuda_time_ms(fn, warmup=1, iters=5)
    parts = {}
    for what, m in (("live", live), ("not live", ~live)):
        i = m.nonzero().squeeze(1)
        parts[what] = cuda_time_ms(
            lambda: bk.block_occluded(fo[i], fd[i], grid, t0[i], t1[i],
                                      **fkw), warmup=1, iters=5)["median_ms"]
    print(f"F, {r} shadow rays (cpuonly_mirror 1080p, area light r=0.15 "
          f"x32, depth 0, first disk sample): {int(parked.sum())} parked, "
          f"{int(live.sum())} live (some block's slab test passes; "
          f"{int((live & parked).sum())} of them parked), "
          f"{int(want.sum())} blocked, {int(stats['pairs'])} pairs; kernel "
          f"{t_f['median_ms']:.3f} ms (samples "
          f"{[round(x, 3) for x in t_f['samples_ms']]}), live rays alone "
          f"{parts['live']:.3f}, the others alone {parts['not live']:.3f} "
          f"ms (medians of 5); kernel {'equals' if same else 'DIFFERS from'}"
          " its plain version")
    _launch_split("F", fn)
    direct = _variant_lib(_F_EDITS_DIRECT, "megakernel_f_direct")
    if direct is not None:
        _turns("F", fn, direct, "the direct walk (8 rays a warp, no list)")


def kernel_times():
    """A (headline binned, flat, cpuonly binned) and F at phase 11's
    inputs, as the imported package computes them -> {variant: [median
    ms of 5, digest of the outputs]}."""
    import hashlib

    import torch

    from chip_smoke import H, W, Frame, cpuonly_scene
    from raytracinginonesemester_tpu_torch.render.renderer import frog_scene
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    def entry(fn):
        out = fn()
        out = out if isinstance(out, (tuple, list)) else (out,)
        digest = hashlib.sha1()
        for t in out:
            digest.update(t.cpu().numpy().tobytes())
        return [cuda_time_ms(fn, warmup=1, iters=5)["median_ms"],
                digest.hexdigest()[:16]]

    main = Frame(frog_scene(W, H, device="cuda"))
    cpu = Frame(cpuonly_scene("cpuonly_mirror", "cuda", W, H),
                jitter="center")
    times = {"A gpu binned": entry(_emit_call(main, True)),
             "A gpu flat": entry(_emit_call(main, False)),
             "A cpuonly binned": entry(_emit_call(cpu, True))}
    times["F"] = entry(_f_call())
    return times


def _parent_turns(parent_dir):
    """A and F as the tree at ``parent_dir`` computes them (a process of
    its own) and as this one does, in turns: parent, this, this,
    parent."""
    import json

    def parent():
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times", "--root",
             os.path.abspath(parent_dir)], capture_output=True, text=True,
            check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    runs = [parent(), kernel_times(), kernel_times(), parent()]
    for key in runs[1]:
        ms = [r[key][0] for r in runs]
        same = len({r[key][1] for r in runs}) == 1
        print(f"{key}, the tree at {parent_dir} vs this tree in turns "
              f"(medians of 5): parent {ms[0]:.3f}, this {ms[1]:.3f}, this "
              f"{ms[2]:.3f}, parent {ms[3]:.3f} ms; outputs "
              f"{'equal' if same else 'DIFFER'}")


def profile_kernels(parent_dir=None):
    """Kernels A, F, B and J at phase 11's full-width inputs (module
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
    clocks = _clock_lib()
    cpu = Frame(cpuonly_scene("cpuonly_mirror", "cuda", W, H),
                jitter="center")
    _profile_a("gpu binned (headline)", main, True, clocks)
    _profile_a("gpu flat (RT_BINNED=0)", main, False, clocks)
    _profile_a("cpuonly binned (cpuonly_mirror)", cpu, True, clocks)
    _profile_f()
    if parent_dir is not None:
        _parent_turns(parent_dir)
    f_call = _f_call()
    for n in (2, 8, 16):
        lib = _variant_lib(_group_edits(n), f"megakernel_groups{n}")
        if lib is not None:
            for label, fn in (("A gpu binned", _emit_call(main, True)),
                              ("A cpuonly binned", _emit_call(cpu, True)),
                              ("F", f_call)):
                _turns(label, fn, lib, f"the list walked {n} rays a warp")
    st, rng, _ = main.sorted_state(*main.emit(False))
    width = min(main.nt, (cap or main.nt) * FRAMES)
    st, rng = st[:width * 16], rng[:width * 8]
    _profile_b("gpu, headline frog depth 1", main, st, rng)
    _walk_clocks("gpu", main, st, rng, clocks[0])
    del st, rng
    st, rng, _ = cpu.sorted_state(*cpu.emit(True))
    _profile_b("cpuonly, cpuonly_mirror depth 1", cpu, st, rng)
    _walk_clocks("cpuonly", cpu, st, rng, clocks[0])
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


# ``--render``: kernel D at phase 11's full-width inputs.  An instrumented
# copy of csrc/megakernel.cu (built apart into build/walk_clocks/, never
# used by the package) records per warp of the render the cycles of its
# closest-hit walks, of its light loops (the shadow walks and the direct
# light) and of the rest of each bounce, the depths its loop runs against
# its lanes' own, and per CTA its globaltimer start and end.  The bounce
# edits are common to both designs of the render kernel; each design has
# its own set for the kernel (whichever set matches is used), and each
# (old, new) edit must find its text exactly once.
_D_SLOTS = 65536  # CTAs recorded (4,080 tiles x 16 CTAs of 32 pixels)
_D_HELPERS = (
    '__device__ unsigned long long g_d[16];\n'
    '__device__ unsigned long long g_dcta[65536 * 3];\n'
    '__device__ __forceinline__ long long dclk() {\n'
    '  __syncwarp(__activemask());\n  return clock64();\n}\n'
    '__device__ __forceinline__ void dadd(int k, long long v) {\n'
    '  const unsigned m = __activemask();\n'
    '  if ((threadIdx.x & 31) == __ffs(m) - 1)\n'
    '    atomicAdd(&g_d[k], (unsigned long long)v);\n}\n'
    '__device__ __forceinline__ unsigned long long dgt() {\n'
    '  unsigned long long t;\n'
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");\n'
    '  return t;\n}\n'
    '__device__ __forceinline__ void dcta(unsigned long long g0, int work) {\n'
    '  if ((threadIdx.x & 31) || blockIdx.x >= 65536) return;\n'
    '  unsigned long long* q = g_dcta + 3 * blockIdx.x;\n'
    '  atomicMax(&q[0], ~g0);\n  atomicMax(&q[1], dgt());\n'
    '  q[2] = work;\n}\n')
# counters: per warp-bounce of the render (DPW), its closest-hit walk (0),
# its light loop (1), the rest (2), the warp-bounces (3); per warp and
# sample, the depths its loop ran (4), the sum of its paths' (5) and its
# paths (8; as first ported not counted: 32); per warp with work, its
# cycles (6) and the warps (7)
_D_EDITS_BOUNCE = [
    ('  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};\n'
     '  if constexpr (W == kCapture || W == kFlags) {\n',
     '  const long long dq0 = DPW ? dclk() : 0;\n'
     '  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};\n'
     '  if constexpr (W == kCapture || W == kFlags) {\n'),
    ('  const bool hit = h.t < kF32Max;\n  float n[3] = {0.0f, 0.0f, 1.0f};\n'
     '  int obj = 0;\n',
     '  if (DPW) dadd(0, dclk() - dq0);\n'
     '  const bool hit = h.t < kF32Max;\n  float n[3] = {0.0f, 0.0f, 1.0f};\n'
     '  int obj = 0;\n'),
    ('  for (int li = 0; li < s.n_lights; ++li) {\n'
     '    const float* L = sh.lights + 8 * li;\n',
     '  const long long dq1 = DPW ? dclk() : 0;\n'
     '  for (int li = 0; li < s.n_lights; ++li) {\n'
     '    const float* L = sh.lights + 8 * li;\n'),
    ('  }\n  if constexpr (W == kList || W == kCapture) return;\n',
     '  }\n  if (DPW) dadd(1, dclk() - dq1);\n'
     '  const long long dq2 = DPW ? dclk() : 0;\n'
     '  if constexpr (W == kList || W == kCapture) return;\n'),
    ('               (r.alive > 0.0f ? 8 : 0);\n  }\n}\n',
     '               (r.alive > 0.0f ? 8 : 0);\n  }\n'
     '  if (DPW) {\n    dadd(2, dclk() - dq2);\n    dadd(3, 1);\n  }\n}\n'),
]
_D_END = (
    '  r_out[gid] = acc[0];\n  g_out[gid] = acc[1];\n  b_out[gid] = acc[2];\n'
    '}\n\n// The staged integrator')
_D_END_NEW = (
    '  const bool dwork = CPU || has_work[tile];\n'
    '  if (dwork) {\n    dadd(6, clock64() - dk0);\n    dadd(7, 1);\n  }\n'
    '  dcta(dg0, dwork);\n' + _D_END)
# D as it is now: the walks of bounce<.., kRender>, the depth loop
# warp-uniform
_D_EDITS_WARP = [
    ('#include "trace_common.cuh"\n',
     '#include "trace_common.cuh"\n' + _D_HELPERS
     + '#define DPW (W == kRender)\n'),
    ('              float* b_out) {\n'
     '  const int thread = blockIdx.x * kThreads + threadIdx.x;\n',
     '              float* b_out) {\n  const unsigned long long dg0 = dgt();\n'
     '  const long long dk0 = clock64();\n'
     '  const int thread = blockIdx.x * kThreads + threadIdx.x;\n'),
    ('      bool live = owner && r.alive > 0.0f;\n      for (int depth = 1;\n',
     '      bool live = owner && r.alive > 0.0f;\n      int dd = 1, dw = 1;\n'
     '      for (int depth = 1;\n'),
    ('        if (live) r = w;\n        live = r.alive > 0.0f;\n      }\n',
     '        if (live) r = w, ++dd;\n        live = r.alive > 0.0f;\n'
     '        ++dw;\n      }\n      dadd(4, dw);\n'
     '      dadd(5, __reduce_add_sync(kFull, owner ? (unsigned)dd : 0u));\n'
     '      dadd(8, __popc(__ballot_sync(kFull, owner)));\n'),
    (_D_END, _D_END_NEW),
]
_D_EDIT_SETS = {"warp-cooperative walks": _D_EDITS_WARP}
_D_READ = r"""
extern "C" int rt_d_clocks(unsigned long long* host, unsigned long long* cta,
                           int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  void *p = nullptr, *q = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, g_d);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&q, g_dcta);
  if (e != cudaSuccess) return (int)e;
  if (reset) {
    e = cudaMemset(p, 0, sizeof(g_d));
    return (int)(e == cudaSuccess ? cudaMemset(q, 0, sizeof(g_dcta)) : e);
  }
  e = cudaMemcpy(host, p, sizeof(g_d), cudaMemcpyDeviceToHost);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpy(cta, q, sizeof(g_dcta), cudaMemcpyDeviceToHost);
}
"""


def _d_clock_lib():
    """Build the instrumented copy of megakernel.cu for kernel D -> (its
    library, the name of the design it instruments)."""
    import ctypes

    csrc = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc")
    with open(os.path.join(csrc, "megakernel.cu")) as f:
        text = f.read()
    found = [k for k, edits in _D_EDIT_SETS.items()
             if all(text.count(old) == 1 for old, _ in edits)]
    if not found:
        raise SystemExit("render clocks: kernel D's source matches no edit "
                         "set")
    for old, new in _D_EDIT_SETS[found[0]] + _D_EDITS_BOUNCE:
        if text.count(old) != 1:
            raise SystemExit(f"render clocks: the source changed near {old!r}")
        text = text.replace(old, new)
    lib = _build_apart(text + _D_READ, "megakernel_render_clocks", csrc)
    lib.rt_d_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int]
    lib.rt_d_clocks.restype = ctypes.c_int
    return lib, found[0]


def _render_frames():
    """D's three rows of phase 11: the headline frog (depth 8, binned),
    the terminal frog (depth 4, diffuse off) and cpuonly_mirror, each at
    1920x1080 with its binned plan."""
    from chip_smoke import H, W, Frame, cpuonly_scene
    from raytracinginonesemester_tpu_torch.render.renderer import frog_scene

    return {
        "frog depth 8 binned (RT_WAVEFRONT=0)": Frame(
            frog_scene(W, H, device="cuda")),
        "frog terminal depth 4": Frame(
            frog_scene(W, H, max_bounces=4, diffuse_bounce=False,
                       device="cuda")),
        "cpuonly_mirror (RT_WAVEFRONT=0)": Frame(
            cpuonly_scene("cpuonly_mirror", "cuda", W, H), jitter="center"),
    }


def _render_call(frame, rows=None):
    """Kernel D on the frame's binned plan, launched as ``render_tiles``
    launches it on operands built once -> a call of the kernel alone."""
    import ctypes

    import torch

    from raytracinginonesemester_tpu_torch.ops import _native
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    rows = frame.rows if rows is None else rows
    p = frame.pkw
    sh = mk._Shade(bool(frame.scene.diffuse_bounce), p["det_eps"], 1e-4,
                   p["shadow_eps"], p["shadow_tmin"], p["dialect"],
                   int(p["shadow_samples"]))
    hw = frame.has_work(True).to(torch.int32).contiguous()
    xs = frame.xs.to(torch.int32).contiguous()
    ys = frame.ys.to(torch.int32).contiguous()
    args = mk._scene_args(rows, sh, frame.cand)

    def call():
        outs = [torch.empty(frame.nt, mk.RAY_TILE, device=hw.device)
                for _ in range(3)]
        lib = _native.load("megakernel")
        err = lib.rt_render(
            ctypes.byref(args), mk._ptr(xs), mk._ptr(ys), mk._ptr(hw),
            frame.np_rays, mk.RAY_TILE, 1, 0,
            int(frame.kw["jitter"] == "center"), int(frame.terminal),
            int(frame.scene.max_bounces), *map(mk._ptr, outs), mk._stream())
        if err:
            raise RuntimeError(f"render kernel: error {err}")
        return tuple(outs)

    return call


def _render_depths(label, frame):
    """D's plain version on the card, bounce by bounce: the live paths
    and the (ray, block) tests of the closest-hit and shadow walks by
    depth, and per warp of 32 pixels the depths its loop runs (its
    deepest path) against its lanes' mean."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    p = frame.pkw
    sh = mk._Shade(bool(frame.scene.diffuse_bounce), p["det_eps"], 1e-4,
                   p["shadow_eps"], p["shadow_tmin"], p["dialect"],
                   int(p["shadow_samples"]))
    st = mk._primary_state(frame.rows, frame.xs, frame.ys, 0,
                           frame.kw["jitter"], frame.has_work(True))
    depths = torch.zeros(frame.np_rays, dtype=torch.int64,
                         device=frame.xs.device)
    shadow, rows_out = [], []
    real = mk._occluded_plain

    def recorded(*a, **k):
        out = real(*a, **k)
        shadow.append(int(out[1]))
        return out

    mk._occluded_plain = recorded
    try:
        for depth in range(1 if frame.terminal
                           else int(frame.scene.max_bounces)):
            alive = st["alive"] > 0.0
            live = int(alive.sum())
            if not live:
                break
            shadow.clear()
            pairs = int(mk._bounce_plain(frame.rows, st, sh,
                                         frame.cand if depth == 0 else None))
            depths += alive.long()
            rows_out.append((depth, live, pairs - sum(shadow), sum(shadow)))
    finally:
        mk._occluded_plain = real
    w = depths.reshape(-1, 32)
    work = w.max(dim=1).values > 0
    w = w[work]
    wmax = w.max(dim=1).values.float()
    wmean = w.float().mean(dim=1)
    print(f"  {label}, D's plain version on the card by depth (live paths, "
          "closest-walk tests, shadow-walk tests): "
          + "; ".join(f"{d}: {n}, {c}, {s}" for d, n, c, s in rows_out))
    print(f"  per warp of 32 pixels ({int(work.sum())} with work): its loop "
          f"runs {float(wmax.mean()):.3f} depths on average (its deepest "
          f"path), its lanes' paths {float(wmean.mean()):.3f}; lanes busy "
          f"in the depth loop "
          f"{float(w.sum()) / max(32 * float(wmax.sum()), 1):.3f};"
          f" warps whose deepest path runs past its lanes' mean by >= 2 "
          f"depths: {int(((wmax - wmean) >= 2).sum())}")


def _render_clocks(label, call, clocks):
    """Kernel D through the instrumented library: clock64() cycles per
    warp split into the closest-hit walks, the light loops and the rest,
    the depths the warps run against their lanes', and when its CTAs
    end."""
    import ctypes

    import numpy as np
    import torch

    lib, design = clocks
    want = call()
    buf = (ctypes.c_ulonglong * 16)()
    cta = (ctypes.c_ulonglong * (_D_SLOTS * 3))()
    with _using(lib):
        call()  # warm
        if lib.rt_d_clocks(buf, cta, 1):
            raise SystemExit("render clocks: resetting the counters failed")
        got = call()
        if lib.rt_d_clocks(buf, cta, 0):
            raise SystemExit("render clocks: reading the counters failed")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    c = list(buf)
    per = lambda a, b: a / max(b, 1)
    paths = c[8] or 32 * c[7]  # counted, or 32 a warp as first ported
    a = np.frombuffer(cta, dtype=np.uint64).reshape(_D_SLOTS, 3)
    a = a[a[:, 1] > 0]
    start = (~a[:, 0]).astype(np.float64)
    end = a[:, 1].astype(np.float64)
    t0 = start.min()
    start, end = (start - t0) / 1e3, (end - t0) / 1e3
    w = a[:, 2] > 0
    print(f"  clock64 counters, D {label} ({design}; instrumented copy, "
          f"results {'equal to' if same else 'DIFFER from'} the kernel's): "
          f"{c[7]} warps with work, {per(c[6], c[7]):.0f} cycles each; of "
          f"their cycles, closest-hit walks {per(c[0], c[6]):.3f}, light "
          f"loops (shadow walks, direct light) {per(c[1], c[6]):.3f}, the "
          f"rest of the bounces {per(c[2], c[6]):.3f}; {c[3]} warp-bounces "
          f"({per(c[3], c[7]):.2f} a warp); depths a warp runs "
          f"{per(c[4], c[7]):.3f}, its paths' mean {per(c[5], paths):.3f}"
          f" (paths busy {per(c[5] * c[7], c[4] * paths):.3f})")
    print(f"  globaltimer: {len(a)} CTAs span {end.max():.1f} us; the "
          f"{int(w.sum())} with work start from {start[w].min():.1f} to "
          f"{start[w].max():.1f} us and end at {end[w].mean():.1f} us on "
          f"average, the last at {end[w].max():.1f} us "
          f"({end[w].max() / max(end[w].mean(), 1e-9):.2f}x the mean); a CTA "
          f"with work lasts {(end - start)[w].mean():.1f} us on average, at "
          f"most {(end - start)[w].max():.1f}")


# D's depth 0 with a binned plan the other way than the source's (a
# variant, timed beside the kernel): each path's first thread walks its
# candidates from device memory, as B's oracle rows do
_D_EDITS_LANE_BINNED = [
    ('    else if constexpr (W == kRender)\n'
     '      h = cta_hit(closest_binned_cta<kRenderSplit>(s, sh, tile, o, d), '
     'live);\n',
     ''),
    ('    const Shared sh = stage_shared(s, s.cand_chunk != 0);\n'
     '    for (int k = 0; k < spp; ++k) {\n',
     '    const Shared sh = stage_shared(s);\n'
     '    for (int k = 0; k < spp; ++k) {\n'),
    ('  const size_t smem = emit_shared_bytes(*s);  '
     '// and the chunk buffers\n',
     '  const size_t smem = shared_bytes(*s);\n'),
]


# D with 32, 16 or 4 paths a warp (variants, timed beside the kernel):
# one, two or eight threads a path split its binned depth 0 (staged by
# the CTA), and its first thread walks it after that
def _d_split_edits(n):
    return [('constexpr int kRenderSplit = 4;\n',
             f'constexpr int kRenderSplit = {n};\n')]


_D_VARIANTS = [
    (_D_EDITS_LANE_BINNED, "megakernel_d_lane_binned",
     "depth 0 walked by each path's first thread from device memory"),
    (_d_split_edits(1), "megakernel_d_split1", "32 paths a warp"),
    (_d_split_edits(2), "megakernel_d_split2", "16 paths a warp"),
    (_d_split_edits(8), "megakernel_d_split8", "4 paths a warp"),
]


def render_times():
    """D's three rows as the imported package computes them -> {row:
    [median ms of 5 of the kernel alone, digest of its outputs]}."""
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    out = {}
    for label, frame in _render_frames().items():
        call = _render_call(frame)
        out[label] = [cuda_time_ms(call, warmup=1, iters=5)["median_ms"],
                      _digest(call())]
    return out


def _render_turns(parent_dir):
    """D as the tree at ``parent_dir`` computes it (a process of its own)
    and as this one does, in turns: parent, this, this, parent."""
    import json

    def parent():
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times",
             "--render", "--root", os.path.abspath(parent_dir)],
            capture_output=True, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    runs = [parent(), render_times(), render_times(), parent()]
    for key in runs[1]:
        ms = [r[key][0] for r in runs]
        same = len({r[key][1] for r in runs}) == 1
        print(f"D {key}, the tree at {parent_dir} vs this tree in turns "
              f"(medians of 5): parent {ms[0]:.3f}, this {ms[1]:.3f}, this "
              f"{ms[2]:.3f}, parent {ms[3]:.3f} ms; outputs "
              f"{'equal' if same else 'DIFFER'}")


def profile_render(parent_dir=None):
    """Kernel D at phase 11's full-width inputs (module docstring)."""
    import dataclasses

    import torch

    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {_card()}")
    frames = _render_frames()
    clocks = _d_clock_lib()
    variants = [(_variant_lib(edits, name), label)
                for edits, name, label in _D_VARIANTS]
    for label, frame in frames.items():
        rows = frame.rows
        call = _render_call(frame)
        dark = _render_call(frame, dataclasses.replace(
            rows, lights=rows.lights[:0].contiguous()))
        stats = {}
        want = frame.render_plain(True, stats=stats)
        same = all(torch.equal(a, b) for a, b in zip(call(), want))
        del want
        t = cuda_time_ms(call, warmup=1, iters=5)
        t_dark = cuda_time_ms(dark, warmup=1, iters=5)
        print(f"D {label}: {frame.nt} tiles x 512, "
              f"{int(frame.has_work(True).sum())} with work; kernel "
              f"{t['median_ms']:.3f} ms, without its lights "
              f"{t_dark['median_ms']:.3f} ms (medians of 5; samples "
              f"{[round(x, 3) for x in t['samples_ms']]}, "
              f"{[round(x, 3) for x in t_dark['samples_ms']]}); "
              f"{int(stats['pairs'])} ray-triangle tests (plain version); "
              f"kernel {'equals' if same else 'DIFFERS from'} its plain "
              "version")
        _render_depths(label, frame)
        _render_clocks(label, call, clocks)
        for lib, what in variants:
            if lib is not None:
                _turns(f"D {label}", call, lib, what)
    if parent_dir is not None:
        _render_turns(parent_dir)


# ``--staged``: kernels E and C at phase 11's full-width inputs.  An
# instrumented copy of csrc/megakernel.cu (built apart into
# build/walk_clocks/, never used by the package; ``--render``'s helpers,
# bounce edits and reading function) records per warp of E the cycles of
# its closest walk, of its shadow walks and in all, per warp of C its
# bounces' closest walks, light loops and the rest and the depths its
# loop runs against its rays' own, and per CTA of either its globaltimer
# start and end (E's launches in slot ranges of their own).  Each design
# of E and of C has its own edit set (whichever matches the source is
# used); each (old, new) edit must find its text exactly once.
_S_HELPERS = (
    '__device__ __forceinline__ void scta(unsigned long long g0, int base,\n'
    '                                     int work) {\n'
    '  const int slot = base + blockIdx.x;\n'
    '  if ((threadIdx.x & 31) || slot >= 65536) return;\n'
    '  unsigned long long* q = g_dcta + 3 * slot;\n'
    '  atomicMax(&q[0], ~g0);\n  atomicMax(&q[1], dgt());\n'
    '  atomicMax(&q[2], (unsigned long long)work);\n}\n'
    # per warp: its depth loop ran `dw` depths, its rays `dd` each (`ray`:
    # the lane holds one)
    '__device__ __forceinline__ void sdepths(int dw, int dd, bool ray) {\n'
    '  const unsigned m = __activemask();\n'
    '  const unsigned live = __ballot_sync(m, ray && dd > 0);\n'
    '  if (!live) return;\n'
    '  dadd(4, dw);\n'
    '  dadd(5, __reduce_add_sync(m, ray ? (unsigned)dd : 0u));\n'
    '  dadd(8, __popc(live));\n  dadd(9, 1);\n}\n')
# E's CTA slots: [0, 40000) its first (or only) launch, [40000, 50000)
# its second, [50000, 65536) its third
_E_SLOTS = ((0, 40000, "the first (or only) launch"),
            (40000, 50000, "the second launch"),
            (50000, 65536, "the third launch"))
# E as first ported: one thread a ray walks alone; per warp its closest
# walk (0), its shadow loop (1), its cycles from the start (6), the
# warps (7)
_E_EDITS_SOLO = [
    ('               float* vis_out) {\n  const Shared sh = stage_shared(s);\n',
     '               float* vis_out) {\n  const unsigned long long dg0 = dgt();\n'
     '  const long long dk0 = clock64();\n'
     '  const Shared sh = stage_shared(s);\n'),
    ('  const Hit h = closest(s, sh, o, d, tmin[gid]);\n',
     '  const long long eq0 = dclk();\n'
     '  const Hit h = closest(s, sh, o, d, tmin[gid]);\n'
     '  dadd(0, dclk() - eq0);\n'),
    ('  if (!with_normal) return;\n  const bool hit',
     '  if (!with_normal) {\n    dadd(6, clock64() - dk0);\n    dadd(7, 1);\n'
     '    scta(dg0, 0, 1);\n    return;\n  }\n  const bool hit'),
    ('  for (int li = 0; li < n_shadow; ++li) {\n'
     '    const float* L = shadow_lights + 3 * li;\n',
     '  const long long eq1 = dclk();\n'
     '  for (int li = 0; li < n_shadow; ++li) {\n'
     '    const float* L = shadow_lights + 3 * li;\n'),
    ('                                                                      '
     ': 0.0f;\n  }\n}\n',
     '                                                                      '
     ': 0.0f;\n  }\n  dadd(1, dclk() - eq1);\n  dadd(6, clock64() - dk0);\n'
     '  dadd(7, 1);\n  scta(dg0, 0, 1);\n}\n'),
]
# E as it is now, three launches (the rays listed, the list walked by
# the card, the shadow list walked): per warp of the walk its closest
# walks (0), per warp of the shadow walk its walk (1), per warp of each
# launch its cycles (6) and the warps (7)
_E_EDITS_LIST = [
    ('closest_kernel(SceneArgs s, ClosestIO io, int n_rays, Shadows q) {\n'
     '  const Shared sh = stage_shared(s);\n',
     'closest_kernel(SceneArgs s, ClosestIO io, int n_rays, Shadows q) {\n'
     '  const unsigned long long dg0 = dgt();\n'
     '  const long long dk0 = clock64();\n'
     '  const Shared sh = stage_shared(s);\n'),
    ("  list_append(q, listed, gid);\n}\n\n// E's second launch",
     '  list_append(q, listed, gid);\n  dadd(6, clock64() - dk0);\n'
     "  dadd(7, 1);\n  scta(dg0, 0, 1);\n}\n\n// E's second launch"),
    ('closest_walk_kernel(SceneArgs s, ClosestIO io, Shadows q, Shadows qs) '
     '{\n  const Shared sh = stage_shared(s);\n',
     'closest_walk_kernel(SceneArgs s, ClosestIO io, Shadows q, Shadows qs) '
     '{\n  const unsigned long long dg0 = dgt();\n'
     '  const long long dk0 = clock64();\n'
     '  const Shared sh = stage_shared(s);\n'),
    ('      warp_append(qs, walks, gid * io.n_shadow + li);\n    }\n  });\n'
     '}\n',
     '      warp_append(qs, walks, gid * io.n_shadow + li);\n    }\n  });\n'
     '  dadd(6, clock64() - dk0);\n  dadd(7, 1);\n  scta(dg0, 40000, 1);\n'
     '}\n'),
    ('    const Hit h = closest_coop(s, sh, o, d, tmin, active);\n',
     '    const long long eq0 = clock64();\n'
     '    const Hit h = closest_coop(s, sh, o, d, tmin, active);\n'
     '    dadd(0, clock64() - eq0);\n'),
    ('closest_shadow_kernel(SceneArgs s, ClosestIO io, Shadows qs) {\n'
     '  const Shared sh = stage_shared(s);\n',
     'closest_shadow_kernel(SceneArgs s, ClosestIO io, Shadows qs) {\n'
     '  const unsigned long long dg0 = dgt();\n'
     '  const long long dk0 = clock64();\n'
     '  const Shared sh = stage_shared(s);\n'
     '  const long long eq1 = clock64();\n'),
    ('  }, [&](int entry) { io.vis[entry] = 0.0f; });\n}\n',
     '  }, [&](int entry) { io.vis[entry] = 0.0f; });\n'
     '  dadd(1, clock64() - eq1);\n  dadd(6, clock64() - dk0);\n'
     '  dadd(7, 1);\n  scta(dg0, 50000, 1);\n}\n'),
]
_E_EDIT_SETS = {"one thread a ray": _E_EDITS_SOLO,
                "the rays listed, walked up to 8 a warp": _E_EDITS_LIST}
# C as first ported: one thread a ray, bounce<CPU> alone (W = kSolo); per
# warp with a live ray its cycles (6) and the warps (7), the depths of
# ``sdepths``; the bounce counters of ``_D_EDITS_BOUNCE``
_C_EDITS_SOLO = [
    ('#include "trace_common.cuh"\n',
     '#include "trace_common.cuh"\n' + _D_HELPERS + _S_HELPERS
     + '#define DPW (W == kSolo)\n'),
    ('              float* b_out) {\n  const Shared sh = stage_shared(s);\n',
     '              float* b_out) {\n  const unsigned long long dg0 = dgt();\n'
     '  const long long dk0 = clock64();\n'
     '  const Shared sh = stage_shared(s);\n'),
    ('  for (int depth = 1; depth < max_depth && r.alive > 0.0f; ++depth)\n'
     '    bounce<CPU>(s, sh, s.cam, r, -1);\n',
     '  int dd = 0;\n'
     '  for (int depth = 1; depth < max_depth && r.alive > 0.0f; ++depth)\n'
     '    bounce<CPU>(s, sh, s.cam, r, -1), ++dd;\n'
     '  __syncwarp();\n'
     '  const int dw = __reduce_max_sync(kFull, (unsigned)dd);\n'
     '  sdepths(dw, dd, true);\n'
     '  if (dw) {\n    dadd(6, clock64() - dk0);\n    dadd(7, 1);\n  }\n'
     '  scta(dg0, 0, dw > 0);\n'),
]
# C as it is now: bounce<.., kWarp>, kResumeRays rays a warp, the depth
# loop warp-uniform
_C_EDITS_WARP = [
    ('#include "trace_common.cuh"\n',
     '#include "trace_common.cuh"\n' + _D_HELPERS + _S_HELPERS
     + '#define DPW (W == kWarp)\n'),
    _C_EDITS_SOLO[1],
    ('  bool live = in_range && r.alive > 0.0f;\n'
     '  for (int depth = 1; depth < max_depth && __any_sync(kFull, live);\n'
     '       ++depth) {\n',
     '  bool live = in_range && r.alive > 0.0f;\n  int dd = 0, dw = 0;\n'
     '  for (int depth = 1; depth < max_depth && __any_sync(kFull, live);\n'
     '       ++depth) {\n    ++dw;\n'),
    ('    if (live) r = w;\n    live = live && r.alive > 0.0f;\n  }\n',
     '    if (live) r = w, ++dd;\n    live = live && r.alive > 0.0f;\n  }\n'
     '  sdepths(dw, dd, in_range);\n'
     '  if (dw) {\n    dadd(6, clock64() - dk0);\n    dadd(7, 1);\n  }\n'
     '  scta(dg0, 0, dw > 0);\n'),
]
_C_EDIT_SETS = {"one thread a ray": _C_EDITS_SOLO,
                "bounce<.., kWarp>": _C_EDITS_WARP}


def _staged_clock_lib():
    """Build the instrumented copy of megakernel.cu for kernels E and C ->
    (its library, the names of the designs it instruments)."""
    import ctypes

    csrc = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc")
    with open(os.path.join(csrc, "megakernel.cu")) as f:
        text = f.read()
    edits, names = [], []
    for kernel, sets in (("C", _C_EDIT_SETS), ("E", _E_EDIT_SETS)):
        found = [k for k, e in sets.items()
                 if all(text.count(old) == 1 for old, _ in e)]
        if not found:
            raise SystemExit(f"staged clocks: kernel {kernel}'s source "
                             "matches no edit set")
        edits += sets[found[0]]
        names.append(f"{kernel}: {found[0]}")
    for old, new in edits + _D_EDITS_BOUNCE:
        if text.count(old) != 1:
            raise SystemExit(f"staged clocks: the source changed near {old!r}")
        text = text.replace(old, new)
    lib = _build_apart(text + _D_READ, "megakernel_staged_clocks", csrc)
    lib.rt_d_clocks.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_int]
    lib.rt_d_clocks.restype = ctypes.c_int
    return lib, "; ".join(names)


def _staged_e_inputs():
    """E's inputs of phase 11 and more -> {label: ((origins, dirs, grid,
    tmin), kwargs)}: each depth of one frog 1080p ``reference_cpu``
    frame, ``cpuonly_mirror``'s depth 0 (phase 8's area light, 32
    samples), and the large frog's camera rays (off its path)."""
    from chip_smoke import (H, W, cpuonly_scene, large_rays, large_scene,
                            record_calls)
    from raytracinginonesemester_tpu_torch.ops import integrator
    from raytracinginonesemester_tpu_torch.render.renderer import (
        frog_scene, render_scene)

    scene = frog_scene(W, H, device="cuda")
    calls = record_calls(integrator, ["block_closest"], lambda: render_scene(
        scene, "reference_cpu"), keep=8)["block_closest"]
    out = {f"frog reference_cpu depth {k}": c for k, c in enumerate(calls)}
    soft = cpuonly_scene("cpuonly_mirror", "cuda", W, H, radius=0.15,
                         shadow_samples=32, diffuse_bounce=True)
    out["cpuonly_mirror depth 0"] = record_calls(
        integrator, ["block_closest"], lambda: render_scene(soft),
        keep=1)["block_closest"][0]
    large, _, _ = large_scene("cuda")
    o, d = large_rays(large)
    out["large frog camera rays (off its path)"] = ((o, d, large.accel,
                                                     1e-4), {})
    return out


def _staged_c_inputs():
    """C's inputs of phase 11, the overflow renders' -> {label: (frame,
    sorted state, rng rows)}: the headline frog's and cpuonly_mirror's
    depth-0 state at 1080p, every tile, sorted."""
    from chip_smoke import H, W, Frame, cpuonly_scene
    from raytracinginonesemester_tpu_torch.render.renderer import frog_scene

    main = Frame(frog_scene(W, H, device="cuda"))
    cpu = Frame(cpuonly_scene("cpuonly_mirror", "cuda", W, H),
                jitter="center")
    out = {}
    for label, frame, binned in (("gpu (frog depth 8)", main, False),
                                 ("cpuonly (cpuonly_mirror)", cpu, True)):
        st, rng, _ = frame.sorted_state(*frame.emit(binned))
        out[label] = (frame, st, rng)
    return out


def _e_call(call):
    """A call of E's wrapper on ``call``'s inputs -> every tensor of its
    result, in order."""
    from chip_smoke import _fields
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk

    (o, d, grid, tmin), kw = call
    return lambda: _fields(bk.block_closest(o, d, grid, tmin, **kw))


def _any_slab(rows, o, d, t0, t1, chunk=8192):
    """(R,) bool: some block's slab test passes for ray (o, d) on [t0,
    t1] (each (R,) or (R, 3)), in chunks of rays."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import megakernel as mk

    out = []
    box = rows.aabb.T[:, None, :]
    for s in range(0, o.shape[0], chunk):
        sl = slice(s, s + chunk)
        out.append(mk._slab(box, tuple(o[sl, k, None] for k in range(3)),
                            tuple(1.0 / d[sl, k, None] for k in range(3)),
                            t0[sl, None], t1[sl, None]).any(dim=1))
    return torch.cat(out)


def _e_counts(label, call):
    """E's plain version on the card: the rays, parked ones (origin off
    the grid), those whose slab test passes some block (the ones that
    walk), the hits, the pairs of the closest walk and of the shadow
    walks, the facing (ray, light) entries and those whose slab test
    passes some block on [shadow_tmin, dist]; the kernel's time and
    whether it equals its plain version."""
    import torch

    from chip_smoke import _fields
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    (o, d, grid, tmin), kw = call
    r, dev = o.shape[0], o.device
    rows = bk.grid_rows(grid)
    tm = bk._per_ray(tmin, r, dev)
    parked = ~(o.abs() < 1e29).all(dim=1)
    walks = _any_slab(rows, o, d, tm, torch.full_like(tm, bk.F32_MAX))
    shadow = []
    real = bk._occluded_plain

    def recorded(rows_, p, ld, dist, facing, det_eps, shadow_tmin,
                 tmax=None):
        out = real(rows_, p, ld, dist, facing, det_eps, shadow_tmin, tmax)
        ps, ls = torch.stack(p, 1), torch.stack(ld, 1)
        listed = facing & _any_slab(rows_, ps, ls,
                                    torch.full_like(dist, shadow_tmin), dist)
        shadow.append((int(out[1]), int(facing.sum()), int(listed.sum())))
        return out

    stats = {}
    bk._occluded_plain = recorded
    try:
        want = bk.block_closest_plain(o, d, grid, tmin, stats=stats, **kw)
    finally:
        bk._occluded_plain = real
    fn = _e_call(call)
    same = all(torch.equal(a, b) for a, b in zip(fn(), _fields(want)))
    t = cuda_time_ms(fn, warmup=1, iters=5)
    hits = int(_fields(want)[4].sum())
    s_pairs = sum(x[0] for x in shadow)
    print(f"E {label}: {r} rays, {int(parked.sum())} parked, "
          f"{int(walks.sum())} pass some block's slab test (they walk), "
          f"{hits} hits; pairs: closest walk "
          f"{int(stats['pairs']) - s_pairs}, shadow walks {s_pairs}; "
          f"{len(shadow)} lights: facing entries "
          f"{[x[1] for x in shadow]}, of them passing some slab test on "
          f"[shadow_tmin, dist] {[x[2] for x in shadow]}; kernel "
          f"{t['median_ms']:.3f} ms (median of 5; samples "
          f"{[round(x, 3) for x in t['samples_ms']]}); kernel "
          f"{'equals' if same else 'DIFFERS from'} its plain version")


def _c_call(frame, st, rng):
    return lambda: frame.resume(st, rng)


def _c_counts(label, frame, st, rng):
    """C's plain version on the card bounce by bounce: live rays and the
    closest-walk and shadow-walk tests by depth; per warp of 32, 8 and 4
    rays the depths its loop runs (its deepest ray) against its rays'
    mean; the kernel's time and whether it equals its plain version."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    p = frame.pkw
    sh = mk._plain_shade(frame.scene.diffuse_bounce, p["det_eps"], 1e-4,
                         p["shadow_eps"], p["shadow_tmin"], p["dialect"],
                         p["shadow_samples"])
    flat = mk._unpack(st, rng)
    depths = torch.zeros_like(flat["alive"], dtype=torch.int64)
    shadow, rows_out = [], []
    real = mk._occluded_plain

    def recorded(*a, **k):
        out = real(*a, **k)
        shadow.append(int(out[1]))
        return out

    mk._occluded_plain = recorded
    try:
        for depth in range(1, int(frame.scene.max_bounces)):
            alive = flat["alive"] > 0.0
            live = int(alive.sum())
            if not live:
                break
            shadow.clear()
            pairs = int(mk._bounce_plain(frame.rows, flat, sh))
            depths += alive.long()
            rows_out.append((depth, live, pairs - sum(shadow), sum(shadow)))
    finally:
        mk._occluded_plain = real
    fn = _c_call(frame, st, rng)
    want = frame.resume_plain(st, rng)
    same = all(torch.equal(a, b) for a, b in zip(fn(), want))
    t = cuda_time_ms(fn, warmup=1, iters=5)
    print(f"C {label}: {st.shape[0] // 16} sorted tiles x 512, depths "
          f"1..{int(frame.scene.max_bounces) - 1}; kernel "
          f"{t['median_ms']:.3f} ms (median of 5; samples "
          f"{[round(x, 3) for x in t['samples_ms']]}); kernel "
          f"{'equals' if same else 'DIFFERS from'} its plain version")
    print(f"  C {label}, the plain version on the card by depth (live "
          "rays, closest-walk tests, shadow-walk tests): "
          + "; ".join(f"{d}: {n}, {c}, {s}" for d, n, c, s in rows_out))
    for g in (32, 8, 4):
        w = depths.reshape(-1, g)
        w = w[w.max(dim=1).values > 0]
        wmax = w.max(dim=1).values.float()
        mean_live = float(w.sum()) / max(int((w > 0).sum()), 1)
        print(f"  per warp of {g} rays ({w.shape[0]} with a live ray): its "
              f"loop runs {float(wmax.mean()):.3f} depths on average, its "
              f"live rays {mean_live:.3f}; lanes busy in the loop "
              f"{float(w.sum()) / max(g * float(wmax.sum()), 1):.3f}")


def _staged_clocks(label, call, clocks, slots):
    """E or C through the instrumented library: clock64() cycles per warp
    by part, the depths C's warps run, and when each launch's CTAs end
    (``slots``: (first, end, name) ranges of the CTA slots)."""
    import ctypes

    import numpy as np
    import torch

    lib, design = clocks
    want = call()
    buf = (ctypes.c_ulonglong * 16)()
    cta = (ctypes.c_ulonglong * (_D_SLOTS * 3))()
    with _using(lib):
        call()  # warm
        if lib.rt_d_clocks(buf, cta, 1):
            raise SystemExit("staged clocks: resetting the counters failed")
        got = call()
        if lib.rt_d_clocks(buf, cta, 0):
            raise SystemExit("staged clocks: reading the counters failed")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    c = list(buf)
    per = lambda a, b: a / max(b, 1)
    msg = (f"  clock64 counters, {label} ({design}; instrumented copy, "
           f"results {'equal to' if same else 'DIFFER from'} the kernel's): "
           f"{c[7]} warps timed, {per(c[6], c[7]):.0f} cycles each; of "
           "their cycles ")
    if c[3]:  # C: the bounces' parts, the depths
        msg += (f"closest-hit walks {per(c[0], c[6]):.3f}, light loops "
                f"{per(c[1], c[6]):.3f}, the rest of the bounces "
                f"{per(c[2], c[6]):.3f}; {c[3]} warp-bounces; {c[9]} warps "
                f"with a live ray run {per(c[4], c[9]):.3f} depths, their "
                f"{c[8]} live rays {per(c[5], c[8]):.3f}")
    else:
        msg += (f"the closest walk {per(c[0], c[6]):.3f}, the shadow walks "
                f"{per(c[1], c[6]):.3f}, the rest "
                f"{1 - per(c[0] + c[1], c[6]):.3f}")
    print(msg)
    a = np.frombuffer(cta, dtype=np.uint64).reshape(_D_SLOTS, 3)
    seen = a[:, 1] > 0
    t0 = (~a[seen, 0]).astype(np.float64).min()
    for first, end, name in slots:
        b = a[first:end]
        b = b[(b[:, 1] > 0) & (b[:, 2] > 0)]
        if not len(b):
            continue
        start = ((~b[:, 0]).astype(np.float64) - t0) / 1e3
        stop = (b[:, 1].astype(np.float64) - t0) / 1e3
        print(f"  globaltimer, {name}: {len(b)} CTAs with work start from "
              f"{start.min():.1f} to {start.max():.1f} us and end at "
              f"{stop.mean():.1f} us on average, the last at "
              f"{stop.max():.1f} us ({stop.max() / max(stop.mean(), 1e-9):.2f}"
              f"x the mean); a CTA lasts {(stop - start).mean():.1f} us on "
              f"average, at most {(stop - start).max():.1f}")


# variants of E and C (timed beside the kernels, in turns): E with every
# ray listed, so that its second launch walks the rays 8 a warp in ray
# order, parked ones included (B's layout); E with its lists walked in
# groups of kRaysPerWarp and kListRays however short; C with 2, 8 or 16
# rays a warp
def _c_rays_edits(n):
    return [("constexpr int kResumeRays = 4;\n",
             f"constexpr int kResumeRays = {n};\n")]


_STAGED_VARIANTS = [
    ([('    listed = next_block(s, sh, o, inv, io.tmin[gid], kF32Max, 0) <\n'
       '             s.num_blocks;\n', '    listed = true;\n')],
     "megakernel_e_every_ray", "E", "every ray walked, 8 a warp in ray order"),
    ([('  while (n > 1 && n * warps > total) n >>= 1;\n', '')],
     "megakernel_e_fixed_groups", "E", "groups of a fixed size"),
    (_c_rays_edits(2), "megakernel_c_rays2", "C", "2 rays a warp"),
    (_c_rays_edits(8), "megakernel_c_rays8", "C", "8 rays a warp"),
    (_c_rays_edits(16), "megakernel_c_rays16", "C", "16 rays a warp"),
]


def staged_times():
    """E's and C's rows as the imported package computes them, and the
    frame of each of C's scenes at a capacity of 8 tiles (``chip_smoke.py``
    phases 5 and 7: it overflows into C) -> {row: [median ms of 5,
    digest of the outputs]}."""
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene_frames)
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    def entry(fn):
        return [cuda_time_ms(fn, warmup=1, iters=5)["median_ms"],
                _digest(fn())]

    out = {}
    for label, call in _staged_e_inputs().items():
        out[f"E {label}"] = entry(_e_call(call))
    for label, (frame, st, rng) in _staged_c_inputs().items():
        out[f"C {label}"] = entry(_c_call(frame, st, rng))
        jitter = "auto" if frame.cpuonly else "wang"  # phases 7 and 5
        out[f"overflow frame at cap=8, {label}"] = entry(
            lambda: (render_scene_frames(frame.scene, 1, jitter, 0,
                                         capacity_tiles=8),))
    return out


def _staged_turns(parent_dir):
    """E and C as the tree at ``parent_dir`` computes them (a process of
    its own) and as this one does, in turns: parent, this, this,
    parent."""
    import json

    def parent():
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times",
             "--staged", "--root", os.path.abspath(parent_dir)],
            capture_output=True, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    runs = [parent(), staged_times(), staged_times(), parent()]
    for key in runs[1]:
        ms = [r[key][0] for r in runs]
        same = len({r[key][1] for r in runs}) == 1
        print(f"{key}, the tree at {parent_dir} vs this tree in turns "
              f"(medians of 5): parent {ms[0]:.3f}, this {ms[1]:.3f}, this "
              f"{ms[2]:.3f}, parent {ms[3]:.3f} ms; outputs "
              f"{'equal' if same else 'DIFFER'}")


def profile_staged(parent_dir=None):
    """Kernels E and C at phase 11's full-width inputs (module
    docstring)."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {_card()}")
    clocks = _staged_clock_lib()
    variants = [(_variant_lib(edits, name), kernel, label)
                for edits, name, kernel, label in _STAGED_VARIANTS]
    for label, call in _staged_e_inputs().items():
        _e_counts(label, call)
        fn = _e_call(call)
        _launch_split(f"E {label}", fn)
        _staged_clocks(f"E {label}", fn, clocks, _E_SLOTS)
        for lib, kernel, what in variants:
            if lib is not None and kernel == "E":
                _turns(f"E {label}", fn, lib, what)
    for label, (frame, st, rng) in _staged_c_inputs().items():
        _c_counts(label, frame, st, rng)
        fn = _c_call(frame, st, rng)
        _staged_clocks(f"C {label}", fn, clocks,
                       ((0, _D_SLOTS, "the kernel"),))
        for lib, kernel, what in variants:
            if lib is not None and kernel == "C":
                _turns(f"C {label}", fn, lib, what)
    if parent_dir is not None:
        _staged_turns(parent_dir)


# ``--streamed``: kernels G and I at phase 10's full-width inputs.  An
# instrumented copy of csrc/block_stream.cu (built apart into
# build/walk_clocks/, never used by the package) records, per CTA, the
# globaltimer at its start and end, its clock64() cycles, the cycles of
# its staging and of its triangle tests and the blocks it staged; each
# (old, new) edit must find its text exactly once
_CTA_SLOTS = 8192  # CTAs recorded (G and I launch one per tile)
# per CTA: globaltimer at start and end, cycles in all, in staging, in
# triangle tests, blocks staged, SM, tile, cycles in the walk's block
# gating (the candidates, the listing), pairs
_CTA_FIELDS = 10
_CTA_HELPERS = (
    '__device__ unsigned long long g_cta[8192 * 10];\n'
    '__device__ __forceinline__ long long pclk() {\n'
    '  long long t;\n'
    '  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory");\n'
    '  return t;\n}\n'
    '__device__ __forceinline__ unsigned long long gtime() {\n'
    '  unsigned long long t;\n'
    '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory");\n'
    '  return t;\n}\n'
    '__device__ __forceinline__ void cta_record(unsigned long long g0,\n'
    '    long long c0, long long st, long long te, long long n, int tile,\n'
    '    long long gate, long long ng) {\n'
    '  if (threadIdx.x != 0 || blockIdx.x >= 8192) return;\n'
    '  unsigned long long* q = g_cta + 10 * blockIdx.x;\n'
    '  unsigned sm;\n  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));\n'
    '  q[0] = g0;\n  q[1] = gtime();\n  q[2] = pclk() - c0;\n'
    '  q[3] = st;\n  q[4] = te;\n  q[5] = n;\n  q[6] = sm;\n  q[7] = tile;\n'
    '  q[8] = gate;\n  q[9] = ng;\n}\n')
_CTA_START = ('  const unsigned long long xg0 = gtime();\n'
              '  const long long xc0 = pclk();\n'
              '  long long xst = 0, xte = 0, xn = 0, xga = 0, xng = 0;\n')
_CTA_READ = r"""
extern "C" int rt_cta_clocks(unsigned long long* host, int reset) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e != cudaSuccess) return (int)e;
  void* p;
  e = cudaGetSymbolAddress(&p, g_cta);
  if (e != cudaSuccess) return (int)e;
  if (reset) return (int)cudaMemset(p, 0, sizeof(g_cta));
  return (int)cudaMemcpy(host, p, sizeof(g_cta), cudaMemcpyDeviceToHost);
}
"""


# G, I and H: candidates first, then the CTA's warps test the
# pairs of each candidate block while the next one is staged.  Staging:
# the wait for the staged block; testing: the pairs; gating: the
# candidates and the listing; the last field counts pairs
_STREAM_EDITS = [
    ('#include "trace_common.cuh"\n',
     '#include "trace_common.cuh"\n' + _CTA_HELPERS),
    # the counters must not cost the kernel its occupancy (two tiles an
    # SM)
    ('template <bool OCC, bool GATE>\n'
     '__global__ void __launch_bounds__(kThreads, kSplit)\nstreamed_kernel(',
     'template <bool OCC, bool GATE>\n'
     '__global__ void __launch_bounds__(kThreads, 2 * kSplit)\n'
     'streamed_kernel('),
    ('  bool blocked = false;\n\n  // 1. the candidates',
     '  bool blocked = false;\n' + _CTA_START
     + '  const long long xqc = pclk();\n\n  // 1. the candidates'),
    ('  __syncthreads();\n\n  // 2. the candidates in order',
     '  __syncthreads();\n  xga += pclk() - xqc;\n\n'
     '  // 2. the candidates in order'),
    ('    const bool pass = active && (OCC ?',
     '    const long long xq0 = pclk();\n'
     '    const bool pass = active && (OCC ?'),
    ('    if (pn >= 0)\n      cp_async_wait<1>();',
     '    const long long xq1 = pclk();\n    xga += xq1 - xq0;\n'
     '    if (pn >= 0)\n      cp_async_wait<1>();'),
    ('    __syncthreads();  // the list and block b in shared memory\n',
     '    __syncthreads();  // the list and block b in shared memory\n'
     '    const long long xq2 = pclk();\n    xst += xq2 - xq1;\n'),
    ('    __syncthreads();  // the pairs\' results; block b\'s buffer is free\n',
     '    __syncthreads();  // the pairs\' results; block b\'s buffer is free\n'
     '    xte += pclk() - xq2;\n    ++xn;\n    xng += total;\n'),
    ('  cp_async_wait<0>();  // a block staged for a walk that stopped\n',
     '  cta_record(xg0, xc0, xst, xte, xn, tile, xga, xng);\n'
     '  cp_async_wait<0>();  // a block staged for a walk that stopped\n'),
]


# H as first ported (one CTA of 512 threads a tile, a thread a ray): per
# CTA, as for G and I, staging (the copy of a block and its barrier),
# testing (the passing threads' walks and the barrier after), gating (the
# slab tests and the vote before each block), the blocks staged and the
# passing lanes (pairs)
_H_EDITS_SOLO = [
    ('  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};\n  bool blocked = false;\n'
     '  for (int j = 0; j < num_slabs; ++j) {\n',
     '  Hit h{kF32Max, 0.0f, 0.0f, -1, 0};\n  bool blocked = false;\n'
     + _CTA_START + '  for (int j = 0; j < num_slabs; ++j) {\n'),
    ('      const bool pass =\n          r.moving &&\n',
     '      const long long xq0 = pclk();\n'
     '      const bool pass =\n          r.moving &&\n'),
    ('      if (!__syncthreads_or(pass)) continue;\n'
     '      stage_block(tri, ids, b, bs, s_tri, s_ids);\n'
     '      __syncthreads();\n',
     '      const int xp = __syncthreads_count(pass);\n'
     '      const long long xq1 = pclk();\n      xga += xq1 - xq0;\n'
     '      if (!xp) continue;\n'
     '      stage_block(tri, ids, b, bs, s_tri, s_ids);\n'
     '      __syncthreads();\n'
     '      const long long xq2 = pclk();\n      xst += xq2 - xq1;\n'
     '      ++xn;\n      xng += xp;\n'),
    ('      }\n      __syncthreads();\n    }\n  }\n  if (OCC) {\n',
     '      }\n      __syncthreads();\n      xte += pclk() - xq2;\n    }\n'
     '  }\n  cta_record(xg0, xc0, xst, xte, xn, tile, xga, xng);\n'
     '  if (OCC) {\n'),
]


def _h_first_ported(bk, grid, o, d, tmin, tmax, occluded):
    """H's glue and kernel through the C interface as first ported ->
    (the glue alone, the kernel alone on operands built once)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import _native
    from raytracinginonesemester_tpu_torch.ops.megakernel import (
        RAY_TILE, _ptr, _stream)

    ct, sb = bk.BM_CHUNK_TILES, bk.BM_SLAB_BLOCKS

    def glue():
        rays, _ = bk._prep_rays(o, d, tmin, tmax)
        rays, rp = bk._pad_rays(rays, ct * RAY_TILE)
        tri, ids, aabb, union_rows, nj = bk._blockmajor_operands(grid, sb)
        gate = bk._chunk_slab_gate(rays, ct * RAY_TILE, union_rows, nj)
        return rays, rp, tri, ids, aabb, nj, gate.contiguous()

    rays, rp, tri, ids, aabb, nj, gate = glue()
    outs = [torch.empty(rp, device=o.device) for _ in range(3)]
    outs += [torch.empty(rp, dtype=torch.int32, device=o.device),
             torch.empty(rp, dtype=torch.bool, device=o.device)]

    def kernel():
        err = _native.load("block_stream").rt_blockmajor(
            _ptr(rays), _ptr(aabb), _ptr(gate), _ptr(tri), _ptr(ids),
            rp // RAY_TILE, grid.num_blocks, nj, sb, ct, grid.block_size,
            1e-8, int(occluded), *(_ptr(x) for x in outs), _stream())
        if err:
            raise RuntimeError(f"blockmajor kernel: error {err}")
        return outs[4:] if occluded else outs[:4]

    return glue, kernel


def _h_jobs(bk, grid, cam, sh):
    """H closest on the camera rays and H occluded on the shadow rays,
    each as a dict of calls: the wrapper; the glue alone (the rays' rows
    padded to whole chunks, the gate and what else the launch needs); the
    kernel alone on operands built once."""
    jobs = {}
    for name, (o, d, tmin, tmax) in (("H closest", (*cam, 1e-4, bk.F32_MAX)),
                                     ("H occluded", sh)):
        occ = name == "H occluded"
        args = (o, d, grid, tmin) + ((tmax,) if occ else ())
        wrapper = (bk.block_occluded_blockmajor if occ
                   else bk.block_closest_blockmajor)
        if hasattr(bk, "_blockmajor_launch"):
            def glue(o=o, d=d, tmin=tmin, tmax=tmax, occ=occ):
                return bk._blockmajor_launch(o, d, grid, tmin, tmax, 1e-8,
                                             occ, bk.BM_CHUNK_TILES,
                                             bk.BM_SLAB_BLOCKS)
            kernel = glue()
        else:
            glue, kernel = _h_first_ported(bk, grid, o, d, tmin, tmax, occ)
        jobs[name] = {"wrapper": lambda w=wrapper, a=args: w(*a),
                      "glue": glue, "kernel": kernel}
    return jobs


def _h_counts(label, bk, grid, o, d, tmin, tmax, closest):
    """H's plain sweep on the card, counted (``_WalkLog``): the gate's
    work and the pairs."""
    import torch

    from raytracinginonesemester_tpu_torch.ops.megakernel import RAY_TILE

    ct, sb = bk.BM_CHUNK_TILES, bk.BM_SLAB_BLOCKS
    rows = bk.grid_rows(grid)
    nb = rows.num_blocks
    rays, _ = bk._prep_rays(o, d, tmin, tmax)
    padded, rp = bk._pad_rays(rays, ct * RAY_TILE)
    _, union_rows, nj = bk._slab_aabbs(grid, sb)
    gate = bk._chunk_slab_gate(padded, ct * RAY_TILE, union_rows, nj)
    in_slab = torch.clamp(nb - torch.arange(nj, device=o.device) * sb,
                          max=sb)
    gated_blocks = (gate.long() * in_slab[None, :]).sum(dim=1)
    nt = rp // RAY_TILE
    log = _WalkLog(nt, rp, o.device)
    stats = {}
    walk = bk._blockmajor_plain(rays, grid, rows, 1e-8, closest, ct, sb,
                                stats, int(o.shape[0]), log=log)
    staged = int(log.staged.sum())
    heavy = int(log.staged.argmax())
    work = log.pairs > 0
    print(f"{label}: {gate.shape[0]} chunks of {ct} tiles, {nj} slabs of "
          f"{sb} blocks; gated slabs a chunk mean "
          f"{float(gate.sum(dim=1).float().mean()):.1f}, max "
          f"{int(gate.sum(dim=1).max())} "
          f"({float(gated_blocks.float().mean()):.0f}"
          f" and {int(gated_blocks.max())} blocks); {nt} tiles, "
          f"{int((log.staged > 0).sum())} staging a block; {staged} staged "
          f"blocks, the heaviest tile ({heavy}) {int(log.staged[heavy])} of "
          f"its chunk's {int(gated_blocks[heavy // ct])} gated; "
          f"{int(log.pairs.sum())} (ray, block) pairs, "
          f"{int(stats['pairs'])} ray-triangle tests; passing lanes a staged "
          f"block mean {int(log.pairs.sum()) / max(staged, 1):.2f}, max "
          f"{int(log.lane_max)}; pairs a tile with any: mean "
          f"{float(log.pairs[work].float().mean()):.0f}, max "
          f"{int(log.pairs.max())}"
          + "".join(f"; the CUDA walk's {k} {stats[k]}" for k in
                    ("walk_pairs", "walk_tested_blocks") if k in stats))
    r = int(o.shape[0])
    line = f"  rays: {r}, {int((d != 0.0).any(dim=1).sum())} moving"
    if closest:
        line += f", {int((walk.best.id[:r] >= 0).sum())} hit"
    else:
        line += f", {int(walk.blocked[:r].sum())} blocked"
    print(line)


def _stream_clock_lib():
    """Build the instrumented copy of block_stream.cu -> its library."""
    import ctypes

    csrc = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc")
    with open(os.path.join(csrc, "block_stream.cu")) as f:
        text = f.read()
    for old, new in _STREAM_EDITS:
        if text.count(old) != 1:
            raise SystemExit(f"stream clocks: no single match for {old!r}")
        text = text.replace(old, new)
    # H as first ported is a kernel of its own
    if all(text.count(old) == 1 for old, _ in _H_EDITS_SOLO):
        for old, new in _H_EDITS_SOLO:
            text = text.replace(old, new)
    lib = _build_apart(text + _CTA_READ, "block_stream_clocks", csrc,
                       "block_stream")
    lib.rt_cta_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.rt_cta_clocks.restype = ctypes.c_int
    return lib


def _large_inputs():
    """Phase 10's inputs on the card -> (grid, camera rays (o, d), their
    shadow rays (p, dir, tmin, dist) at full width: the missed rays'
    shade points parked at 1e30 with a zero direction)."""
    from chip_smoke import large_rays, large_scene, shadow_rays
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk

    scene, _, _ = large_scene("cuda")
    grid = scene.accel
    o, d = large_rays(scene)
    hits, normal = bk.block_closest(o, d, grid, 1e-4, return_normal=True)
    sh = shadow_rays(o, d, hits, normal, scene.lights.position[0])
    return grid, (o, d), sh


def _stream_jobs(bk, grid, cam, sh):
    """G on the camera rays and I on the shadow rays, each as a dict of
    calls: the wrapper; the plan alone (the rays' rows and
    ``tile_visit_plan_fast``); the operand packing alone; the kernel alone
    on operands built once.  The launch follows the imported package's
    C interface."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import _native
    from raytracinginonesemester_tpu_torch.ops.accel import (
        tile_visit_plan_fast)
    from raytracinginonesemester_tpu_torch.ops.megakernel import (
        RAY_TILE, _ptr, _stream)

    jobs = {}
    for name, (o, d, tmin, tmax) in (("G", (*cam, 1e-4, bk.F32_MAX)),
                                     ("I", sh)):
        closest = name == "G"
        wrapper = (bk.block_closest_streamed if closest
                   else bk.block_occluded_streamed)
        args = (o, d, grid, tmin) + (() if closest else (tmax,))

        def plan(o=o, d=d, tmin=tmin, tmax=tmax):
            rays, _ = bk._prep_rays(o, d, tmin, tmax)
            return tile_visit_plan_fast(rays[:, 0:3], rays[:, 3:6], grid,
                                        rays[:, 6], rays[:, 7], RAY_TILE)

        if hasattr(bk, "_streamed_launch"):
            kernel = bk._streamed_launch(o, d, grid, tmin, tmax, 1e-8,
                                         not closest)
        else:  # the interface as first ported
            rays, nt, order, entry, tri, ids, aabb, ls = bk._plan_operands(
                o, d, grid, tmin, tmax)
            rp = nt * RAY_TILE
            outs = [torch.empty(rp, device=o.device) for _ in range(3)]
            outs.append(torch.empty(rp, dtype=torch.int32, device=o.device))
            flags = torch.empty(rp, dtype=torch.bool, device=o.device)

            def kernel(rays=rays, nt=nt, order=order, entry=entry, tri=tri,
                       ids=ids, aabb=aabb, ls=ls, outs=outs, flags=flags,
                       closest=closest):
                lib = _native.load("block_stream")
                head = (_ptr(rays), _ptr(aabb), _ptr(order), _ptr(entry),
                        _ptr(tri), _ptr(ids), nt, grid.num_blocks, ls,
                        grid.block_size, 1e-8)
                if closest:
                    err = lib.rt_closest_streamed(
                        *head, *(_ptr(x) for x in outs), _stream())
                else:
                    err = lib.rt_occluded_streamed(*head, _ptr(flags),
                                                   _stream())
                if err:
                    raise RuntimeError(f"streamed kernel: error {err}")
                return tuple(outs) if closest else flags

        # a copy of the grid, so that the packing kept on the grid is
        # built anew
        packing = lambda: bk._stream_grid_operands(dataclasses.replace(grid))
        jobs[name] = {"wrapper": lambda w=wrapper, a=args: w(*a),
                      "plan": plan, "packing": packing, "kernel": kernel}
    return jobs


def _digest(out):
    import hashlib

    digest = hashlib.sha1()
    for t in out:
        digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def streamed_times():
    """G, I and H as the imported package computes them -> {"G wrapper",
    "G kernel", "I wrapper", "I kernel", "H closest wrapper", ...:
    [median ms of 5, digest]}."""
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    grid, cam, sh = _large_inputs()
    out = {}
    jobs = {**_stream_jobs(bk, grid, cam, sh), **_h_jobs(bk, grid, cam, sh)}
    for name, job in jobs.items():
        for part in ("wrapper", "kernel"):
            fn = job[part]
            # the real rays' outputs (the kernel's are padded to tiles)
            digest = _digest(_rows(fn(), cam[0].shape[0]))
            out[f"{name} {part}"] = [
                cuda_time_ms(fn, warmup=1, iters=5)["median_ms"], digest]
    return out


def _rows(out, r):
    """The first ``r`` rows of each output tensor (copies)."""
    if hasattr(out, "tri_idx"):
        out = (out.t, out.u, out.v, out.tri_idx)
    out = out if isinstance(out, (tuple, list)) else (out,)
    return tuple(x[:r].clone() for x in out)


class _WalkLog:
    """``_TileWalk.log`` of the plain walk: per tile the blocks it stages
    and its (ray, block) pairs; per staged block the lanes that pass its
    slab test; per ray its (ray, block) pairs."""

    def __init__(self, nt, rp, dev):
        import torch

        self.staged = torch.zeros(nt, dtype=torch.int64, device=dev)
        self.pairs = torch.zeros(nt, dtype=torch.int64, device=dev)
        self.rounds = torch.zeros(nt, dtype=torch.int64, device=dev)
        self.ray_pairs = torch.zeros(rp, dtype=torch.int64, device=dev)
        self.edges = torch.tensor([1, 4, 16, 32, 64, 128, 512], device=dev)
        self.hist = torch.zeros(len(self.edges), dtype=torch.int64,
                                device=dev)
        self.lane_max = torch.zeros((), dtype=torch.int64, device=dev)

    def __call__(self, tiles, lanes, boxed):
        import torch

        c = boxed.reshape(-1, 512).sum(dim=1)
        self.staged.index_add_(0, tiles, (c > 0).long())
        self.pairs.index_add_(0, tiles, c)
        # pair rounds of a CTA's 16 warps, a pair a warp a round
        self.rounds.index_add_(0, tiles, (c + 15) // 16)
        self.ray_pairs.index_add_(0, lanes, boxed.long())
        cs = c[c > 0]
        self.hist += torch.bincount(torch.bucketize(cs, self.edges),
                                    minlength=len(self.edges))[:len(self.edges)]
        if cs.numel():
            self.lane_max = torch.maximum(self.lane_max, cs.max())


def _stream_counts(label, bk, grid, o, d, tmin, tmax, closest):
    """The plain walk of G or I on the card, counted (``_WalkLog``)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops.accel import (
        tile_visit_plan_fast)
    from raytracinginonesemester_tpu_torch.ops.megakernel import RAY_TILE

    rows = bk.grid_rows(grid)
    rays, rp = bk._prep_rays(o, d, tmin, tmax)
    nt = rp // RAY_TILE
    _, _, count = tile_visit_plan_fast(rays[:, 0:3], rays[:, 3:6], grid,
                                       rays[:, 6], rays[:, 7], RAY_TILE)
    count = count[:, 0].long()
    log = _WalkLog(nt, rp, o.device)
    stats = {}
    walk = bk._plan_walk_plain(rays, grid, rows, 1e-8, closest, stats,
                               int(o.shape[0]), log=log)
    staged = int(log.staged.sum())
    heavy = int(log.staged.argmax())
    work = count > 0
    bounds = [1] + [int(x) + 1 for x in log.edges[:-1]]
    hist = ", ".join(f"{lo}-{int(hi)}: {int(n)}" for lo, hi, n in
                     zip(bounds, log.edges, log.hist))
    rounds = log.rounds[work].float()
    print(f"{label}: {nt} tiles, {int(work.sum())} with a plan "
          f"(superblocks a tile mean {float(count.float().mean()):.1f}, max "
          f"{int(count.max())}), {int((log.staged > 0).sum())} staging a "
          f"block; {staged} staged blocks, the heaviest tile ({heavy}) "
          f"{int(log.staged[heavy])} (plan {int(count[heavy])} superblocks, "
          f"{int(log.pairs[heavy])} (ray, block) pairs); "
          f"{int(log.pairs.sum())} (ray, block) pairs, "
          f"{int(stats['pairs'])} ray-triangle tests; passing lanes a "
          f"staged block mean {int(log.pairs.sum()) / max(staged, 1):.2f}, "
          f"max {int(log.lane_max)} (blocks by lanes: {hist}); rounds of a "
          f"pair a warp for 16 warps a tile: mean {float(rounds.mean()):.1f}"
          f", max {int(log.rounds.max())}")
    moving = (d != 0.0).any(dim=1)
    tested = (log.ray_pairs[:o.shape[0]] > 0)
    line = (f"  rays: {o.shape[0]}, {int(moving.sum())} with a nonzero "
            f"direction, {int((~moving).sum())} parked (zero direction), "
            f"{int(tested.sum())} test a block")
    if closest:
        line += f", {int((walk.best.id[:o.shape[0]] >= 0).sum())} hit"
    else:
        line += f", {int(walk.blocked[:o.shape[0]].sum())} blocked"
    print(line)
    print(f"  the CUDA walk's tests {stats['walk_pairs']} and tested blocks "
          f"{stats['walk_tested_blocks']} (counted by the plain version; a "
          "CTA that stops has also copied up to two blocks it does not "
          "test)")


def _stream_cta_clocks(label, fn, lib):
    """``fn`` through the instrumented library: per CTA its span and
    cycles, split into staging and testing."""
    import ctypes

    import numpy as np
    import torch

    buf = (ctypes.c_ulonglong * (_CTA_SLOTS * _CTA_FIELDS))()
    n = 1 << 30
    want = _rows(fn(), n)
    with _using(lib, "block_stream"):
        fn()  # warm
        if lib.rt_cta_clocks(buf, 1):
            raise SystemExit("stream clocks: resetting the counters failed")
        got = _rows(fn(), n)
        if lib.rt_cta_clocks(buf, 0):
            raise SystemExit("stream clocks: reading the counters failed")
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    a = np.frombuffer(buf, dtype=np.uint64).reshape(_CTA_SLOTS, _CTA_FIELDS)
    a = a[a[:, 0] > 0].astype(np.float64)
    t0 = a[:, 0].min()
    start, end = (a[:, 0] - t0) / 1e3, (a[:, 1] - t0) / 1e3
    cyc, st, te, n, ga, ng = (a[:, k] for k in (2, 3, 4, 5, 8, 9))
    w = n > 0
    last = int(np.argmax(np.where(w, end, -1.0)))
    heavy = int(np.argmax(cyc))
    ghz = cyc[heavy] / max(a[heavy, 1] - a[heavy, 0], 1.0)
    # the CTAs resident at once: on average over the span, and at most on
    # one SM (from the start and end events of each SM's CTAs)
    most = 0
    for sm in np.unique(a[:, 6]):
        i = a[:, 6] == sm
        ev = sorted([(x, 1) for x in a[i, 0]] + [(x, -1) for x in a[i, 1]],
                    key=lambda e: (e[0], e[1]))
        most = max(most, int(np.max(np.cumsum([e[1] for e in ev]))))
    print(f"  clocks, {label} (instrumented copy, results "
          f"{'equal to' if same else 'DIFFER from'} the kernel's): "
          f"{len(a)} CTAs span {end.max():.1f} us, "
          f"{(end - start).sum() / end.max():.1f} resident on average, at "
          f"most {most} on an SM; {int(w.sum())} staged a block: "
          f"{cyc[w].mean():.0f} cycles each (max {cyc.max():.0f}, tile "
          f"{int(a[heavy, 7])}, {int(n[heavy])} blocks, {ghz:.3f} "
          f"cycles/ns), staging {st[w].sum() / cyc[w].sum():.3f}, testing "
          f"{te[w].sum() / cyc[w].sum():.3f} and gating "
          f"{ga[w].sum() / cyc[w].sum():.3f} of their cycles, "
          f"{st[w].sum() / max(n.sum(), 1):.0f} and "
          f"{te[w].sum() / max(n.sum(), 1):.0f} cycles a staged block, "
          f"{ng[w].sum() / w.sum():.0f} pairs a CTA; they start from "
          f"{start[w].min():.1f} to {start[w].max():.1f} us and end at "
          f"{end[w].mean():.1f} us on average, the last at {end[last]:.1f} "
          f"us (tile {int(a[last, 7])}, {int(n[last])} blocks)")
    top = np.argsort(-cyc)[:5]
    print("  the five longest CTAs (tile: staged blocks, pairs, cycles: "
          "staging, testing, gating; start-end us): "
          + "; ".join(f"{int(a[i, 7])}: {int(n[i])}, {int(ng[i])}, "
                      f"{cyc[i]:.0f}: {st[i]:.0f}, {te[i]:.0f}, {ga[i]:.0f}; "
                      f"{start[i]:.1f}-{end[i]:.1f}" for i in top))


def _tile_order_turns(bk, grid, cam, sh):
    """G's and I's kernels alone on operands built once, the tiles
    launched longest plan first (the wrapper's order) or in plan order,
    in turns: longest first, plan order, plan order, longest first
    (medians of 5 each); H's the same way, most gated blocks first (its
    wrapper's order) or in index order."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import _native
    from raytracinginonesemester_tpu_torch.ops.accel import (
        tile_visit_plan_fast)
    from raytracinginonesemester_tpu_torch.ops.megakernel import (
        RAY_TILE, _ptr, _stream)
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    tri, ids, aabb, ls = bk._stream_grid_operands(grid)
    for name, (o, d, tmin, tmax) in (("G", (*cam, 1e-4, bk.F32_MAX)),
                                     ("I", sh)):
        rays, rp = bk._prep_rays(o, d, tmin, tmax)
        order, entry, count = tile_visit_plan_fast(
            rays[:, 0:3], rays[:, 3:6], grid, rays[:, 6], rays[:, 7],
            RAY_TILE)
        count = count[:, 0].to(torch.int32).contiguous()
        orders = {
            "longest first": torch.sort(count, descending=True,
                                        stable=True)[1].to(torch.int32),
            "plan order": torch.arange(count.numel(), dtype=torch.int32,
                                       device=o.device)}
        outs = [torch.empty(rp, device=o.device) for _ in range(3)]
        outs += [torch.empty(rp, dtype=torch.int32, device=o.device),
                 torch.empty(rp, dtype=torch.bool, device=o.device)]

        def launch(tiles):
            err = _native.load("block_stream").rt_streamed(
                _ptr(rays), _ptr(aabb), _ptr(order), _ptr(entry),
                _ptr(count), _ptr(tiles), _ptr(tri), _ptr(ids),
                rp // RAY_TILE, int(o.shape[0]), grid.num_blocks, ls,
                grid.block_size, 1e-8, int(name == "I"),
                *(_ptr(x) for x in outs), _stream())
            if err:
                raise RuntimeError(f"streamed kernel: error {err}")
            return outs[4:] if name == "I" else outs[:4]

        runs = []
        for key in ("longest first", "plan order", "plan order",
                    "longest first"):
            fn = lambda tiles=orders[key]: launch(tiles)
            digest = _digest(_rows(fn(), o.shape[0]))
            runs.append((key, cuda_time_ms(fn, warmup=1, iters=5)
                         ["median_ms"], digest))
        same = len({r[2] for r in runs}) == 1
        print(f"{name} kernel alone, tile order in turns (medians of 5): "
              + ", ".join(f"{k} {ms:.3f}" for k, ms, _ in runs)
              + f" ms; outputs {'equal' if same else 'DIFFER'}")
    # H: the tiles most gated blocks first (the wrapper's order) or in
    # index order
    ct, sb = bk.BM_CHUNK_TILES, bk.BM_SLAB_BLOCKS
    for name, (o, d, tmin, tmax) in (("H closest", (*cam, 1e-4, bk.F32_MAX)),
                                     ("H occluded", sh)):
        rays, _ = bk._prep_rays(o, d, tmin, tmax)
        rays, rp = bk._pad_rays(rays, ct * RAY_TILE)
        _, union, nj = bk._slab_aabbs(grid, sb)
        gate = bk._chunk_slab_gate(rays, ct * RAY_TILE, union, nj).contiguous()
        in_slab = torch.clamp(grid.num_blocks - sb * torch.arange(
            nj, device=o.device), max=sb)
        gated = (gate * in_slab).sum(dim=1).repeat_interleave(ct)
        orders = {
            "most gated first": torch.sort(gated, descending=True,
                                           stable=True)[1].to(torch.int32),
            "index order": torch.arange(gated.numel(), dtype=torch.int32,
                                        device=o.device)}
        outs = [torch.empty(rp, device=o.device) for _ in range(3)]
        outs += [torch.empty(rp, dtype=torch.int32, device=o.device),
                 torch.empty(rp, dtype=torch.bool, device=o.device)]
        occ = name == "H occluded"

        def launch(tiles):
            err = _native.load("block_stream").rt_blockmajor(
                _ptr(rays), _ptr(aabb), _ptr(gate), _ptr(union), _ptr(tiles),
                _ptr(tri), _ptr(ids), rp // RAY_TILE, int(o.shape[0]),
                grid.num_blocks,
                nj, sb, ct, grid.block_size, 1e-8, int(occ),
                *(_ptr(x) for x in outs), _stream())
            if err:
                raise RuntimeError(f"blockmajor kernel: error {err}")
            return outs[4:] if occ else outs[:4]

        runs = []
        for key in ("most gated first", "index order", "index order",
                    "most gated first"):
            fn = lambda tiles=orders[key]: launch(tiles)
            digest = _digest(_rows(fn(), o.shape[0]))
            runs.append((key, cuda_time_ms(fn, warmup=1, iters=5)
                         ["median_ms"], digest))
        same = len({r[2] for r in runs}) == 1
        print(f"{name} kernel alone, tile order in turns (medians of 5): "
              + ", ".join(f"{k} {ms:.3f}" for k, ms, _ in runs)
              + f" ms; outputs {'equal' if same else 'DIFFER'}")


def _stream_turns(parent_dir):
    """G and I as the tree at ``parent_dir`` computes them (a process of
    its own) and as this one does, in turns: parent, this, this,
    parent."""
    import json

    def parent():
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times",
             "--streamed", "--root", os.path.abspath(parent_dir)],
            capture_output=True, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    runs = [parent(), streamed_times(), streamed_times(), parent()]
    for key in runs[1]:
        ms = [r[key][0] for r in runs]
        same = len({r[key][1] for r in runs}) == 1
        print(f"{key}, the tree at {parent_dir} vs this tree in turns "
              f"(medians of 5): parent {ms[0]:.3f}, this {ms[1]:.3f}, this "
              f"{ms[2]:.3f}, parent {ms[3]:.3f} ms; outputs "
              f"{'equal' if same else 'DIFFER'}")


def profile_streamed(parent_dir=None):
    """Kernels G and I at phase 10's full-width inputs (module
    docstring)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {_card()}")
    grid, cam, sh = _large_inputs()
    clocks = _stream_clock_lib()
    jobs = _stream_jobs(bk, grid, cam, sh)
    inputs = {"G": (*cam, 1e-4, bk.F32_MAX), "I": sh}
    for name, job in jobs.items():
        t = {k: cuda_time_ms(fn, warmup=1, iters=5)
             for k, fn in job.items()}
        print(f"{name}: wrapper {t['wrapper']['median_ms']:.3f} ms, the "
              f"plan alone {t['plan']['median_ms']:.3f}, the operand "
              f"packing alone {t['packing']['median_ms']:.3f}, the kernel "
              f"alone on operands built once {t['kernel']['median_ms']:.3f} "
              "(medians of 5; samples "
              + "; ".join(f"{k} {[round(x, 3) for x in v['samples_ms']]}"
                          for k, v in t.items()) + ")")
        _stream_counts(f"{name}, counted by its plain walk on the card", bk,
                       grid, *inputs[name], closest=name == "G")
        _stream_cta_clocks(name, job["kernel"], clocks)
    for name, job in _h_jobs(bk, grid, cam, sh).items():
        t = {k: cuda_time_ms(fn, warmup=1, iters=5)
             for k, fn in job.items()}
        print(f"{name}: wrapper {t['wrapper']['median_ms']:.3f} ms, the "
              f"glue alone {t['glue']['median_ms']:.3f}, the kernel alone "
              f"on operands built once {t['kernel']['median_ms']:.3f} "
              "(medians of 5; samples "
              + "; ".join(f"{k} {[round(x, 3) for x in v['samples_ms']]}"
                          for k, v in t.items()) + ")")
        _h_counts(f"{name}, counted by its plain sweep on the card", bk,
                  grid, *inputs["G" if name == "H closest" else "I"],
                  closest=name == "H closest")
        _stream_cta_clocks(name, job["kernel"], clocks)
    _tile_order_turns(bk, grid, cam, sh)
    if parent_dir is not None:
        _stream_turns(parent_dir)


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
