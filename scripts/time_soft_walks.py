"""Kernels A, B and C of the cpuonly soft scene at full width, on one CUDA
device, as a tree of the port computes them.

    python scripts/time_soft_walks.py [--root DIR]
    python scripts/time_soft_walks.py --parent DIR

The scene and the inputs are ``chip_smoke.py`` phase 11's
(``soft_jobs``): ``cpuonly_mirror`` at 1920x1080, its light of radius
0.15 with 32 disk samples, diffuse bounces, depth 8; A's binned emit with
pixel centres, then B and C on A's state sorted as the wavefront sorts
it.  The rows:

- ``A``: a whole emit (its three launches);
- ``B``: one bounce step at 32 disk samples;
- ``B1``: the same bounce step with the light's ``shadow_samples`` set to
  1 (one walk a hit: the closest hit and the shading with one shadow
  walk, which ``B`` less ``B1`` splits from the other 31 walks);
- ``C``: the resume (depths 1-7) at 32 disk samples.

Each row is the median of 5 CUDA-event times after a warm-up, with a
digest of its outputs (sha1 of their bytes).  The counters the tree has
are read after one more call of A, B and C each (``shadow_walk_counts``,
``shadow_group_counts``, ``bounce_group_counts``).

``--root DIR`` imports ``raytracinginonesemester_tpu_torch`` from ``DIR``
(default: this checkout), which builds its kernels into ``DIR/build``, and
prints the rows as one JSON object on its last line.  ``--parent DIR``
runs the rows of ``DIR`` and of this checkout in turns, each in a process
of its own (parent, this, this, parent), compares their digests, and
compares the resource usage (``cuobjdump --dump-resource-usage``) of
every ``bounce_step_kernel<false, ...>`` and ``resume_kernel<false, ...>``
of the two trees' ``megakernel`` libraries: it exits 1 if a digest or a
resource line differs.  Prints the card's name and power limit first.
"""

import argparse
import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "raytracinginonesemester_tpu_torch"
ITERS = 5
# the mangled-name prefixes of the gpu dialect's B and C: their resources
# must not change
GPU_BC = ("_Z18bounce_step_kernelILb0", "_Z13resume_kernelILb0")


def _chip_smoke():
    """This checkout's ``chip_smoke.py`` (its imports of the package are
    made inside its functions, so they resolve to the tree on the path)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod
    spec.loader.exec_module(mod)
    return mod


def _digest(out) -> str:
    out = out if isinstance(out, (tuple, list)) else (out,)
    h = hashlib.sha1()
    for t in out:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _counters(mk) -> dict:
    names = ("shadow_walk_counts", "shadow_group_counts",
             "bounce_group_counts")
    return {n: list(getattr(mk, n)().values()) for n in names
            if hasattr(mk, n)}


def times(root: str) -> dict:
    """The rows as the tree at ``root`` computes them (module docstring)."""
    sys.path.insert(0, root)
    import torch

    pkg = importlib.import_module(PKG)
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise SystemExit(f"{PKG} came from {pkg.__file__}, not {root}")
    from raytracinginonesemester_tpu_torch.ops import _native
    from raytracinginonesemester_tpu_torch.ops import megakernel as mk
    from raytracinginonesemester_tpu_torch.utils.timing import cuda_time_ms

    cs = _chip_smoke()
    soft = cs.cpuonly_scene("cpuonly_mirror", "cuda", cs.W, cs.H,
                            radius=0.15, shadow_samples=32,
                            diffuse_bounce=True)
    f = cs.Frame(soft, jitter="center")
    st, rng = f.emit(True)
    st_s, rng_s, _ = f.sorted_state(st, rng)
    one = {**f.no_jitter(), "shadow_samples": 1}
    calls = {
        "A": lambda: f.emit(True),
        "B": lambda: f.bounce(st_s, rng_s),
        "B1": lambda: mk.bounce_step_tiles(soft, st_s, rng_s, rows=f.rows,
                                           **one),
        "C": lambda: f.resume(st_s, rng_s),
    }
    rows = {}
    for key, fn in calls.items():
        digest = _digest(fn())
        t = cuda_time_ms(fn, warmup=1, iters=ITERS)
        rows[key] = {"ms": t["median_ms"], "samples_ms": t["samples_ms"],
                     "digest": digest}
    mk.reset_launch_counts()
    for key in ("A", "B", "C"):
        calls[key]()
    torch.cuda.synchronize()
    return {"root": root, "rows": rows, "counters": _counters(mk),
            "lib": _native.build("megakernel")}


def _run(root: str) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--root", root], capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"{root}: exit {out.returncode}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def turns(parent: str) -> int:
    runs = [_run(parent), _run(REPO), _run(REPO), _run(parent)]
    bad = 0
    for key in runs[1]["rows"]:
        ms = [r["rows"][key]["ms"] for r in runs]
        digests = {r["rows"][key]["digest"] for r in runs}
        bad += len(digests) != 1
        print(f"{key}: parent {ms[0]:.3f}, this {ms[1]:.3f}, this "
              f"{ms[2]:.3f}, parent {ms[3]:.3f} ms (medians of {ITERS}); "
              f"outputs {'equal' if len(digests) == 1 else 'DIFFER'}",
              flush=True)
    for name, r in (("parent", runs[0]), ("this", runs[1])):
        print(f"{name} counters: {r['counters']}", flush=True)
    sys.path.insert(0, REPO)
    cs = _chip_smoke()
    was, now = (cs.resource_usage(runs[0]["lib"]),
                cs.resource_usage(runs[1]["lib"]))
    for name in sorted(n for n in was if n.startswith(cs.BC_KERNELS)):
        same = now.get(name) == was[name]
        bad += name.startswith(GPU_BC) and not same
        print(f"resource usage {name}: {'unchanged' if same else 'CHANGED'}"
              f" ({was[name]}" + ("" if same else f" -> {now.get(name)}")
              + ")", flush=True)
    print(json.dumps({"runs": runs}), flush=True)
    return 1 if bad else 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--parent", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    if args.parent:
        sys.exit(turns(os.path.abspath(args.parent)))
    out = times(os.path.abspath(args.root))
    for key, row in out["rows"].items():
        print(f"{key}: {row['ms']:.3f} ms (median of {ITERS}, samples "
              f"{[round(s, 3) for s in row['samples_ms']]}), outputs "
              f"{row['digest']}", flush=True)
    print(f"counters: {out['counters']}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
