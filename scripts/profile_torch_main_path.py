"""Where the time of the port's main path goes, on one CUDA device.

    python scripts/profile_torch_main_path.py [--frames 16] [--width 1920 --height 1080]
        [--jitter wang|reference_cpu]

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
The full table is also written to ``chiprun_out/profile_main_path.txt``.
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
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--jitter", choices=("wang", "reference_cpu"),
                    default="wang")
    args = ap.parse_args()
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


if __name__ == "__main__":
    main()
