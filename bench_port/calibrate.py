"""The readings that a cell's limits are set from, in one process.

    python3 bench_port/calibrate.py --workload <cell> --seeds 1 2 ... [--control 3]

For each seed: the program's numbers against the float32 reference (the
lower readings; ``--calls`` calls of the window, a render cell's each
keeping ``--pixels`` pixels, so that as many are compared as a run
compares; a training cell's last one checked from the state saved
before it).  For the first ``--control`` seeds: the control, the
reference computed in bfloat16 in the program's place, against the
float32 reference (the upper readings), and the program with each fault
planted that the cell can have (``FAULTS``).  One JSON line a reading,
also appended to ``bench_port/out/calibrate_<cell>.jsonl``.  The
benchmark's runs never run this.
"""

import argparse
import contextlib
import json
import os
import sys
import time
import types

# the faults a cell can have, by entry: a step that returns its state
# unchanged, half of the batch left out, an answer altered where it is
# produced (one chip: no exchange between chips to leave out)
FAULTS = {"render_frames": ("unchanged", "half", "altered"),
          "train_step": ("unchanged", "half_batch")}


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


@contextlib.contextmanager
def planted(fault: str, entry: str = "train_step"):
    """The timed path broken underneath the harness.  Render: ``unchanged``
    returns the first call's frames again, ``half`` leaves the lower half
    of every frame black, ``altered`` renders each frame at the next
    sample index.  Training: ``half_batch`` takes the loss's mean over the
    upper half of the image, ``unchanged`` steps nothing."""
    import torch

    if entry == "render_frames":
        from raytracinginonesemester_tpu_torch.render import renderer

        real = renderer.render_scene_frames
        first = []

        def broken(scene, frames, jitter_mode="auto", sample_offset=0, **kw):
            if fault == "altered":
                return real(scene, frames, jitter_mode, sample_offset + 1, **kw)
            out = real(scene, frames, jitter_mode, sample_offset, **kw)
            if fault == "unchanged":
                first.append(out)
                return first[0]
            if fault == "half":
                out = out.clone()
                out[:, out.shape[1] // 2:] = 0.0
                return out
            raise ValueError(fault)

        with _patched(renderer, "render_scene_frames", broken):
            yield
        return
    from raytracinginonesemester_tpu_torch.diff import inverse

    if fault == "half_batch":
        def half(params, scene, target, *a, **k):
            img = inverse.render_scene(inverse.apply_params(scene, params),
                                       jitter_mode="center", spp_override=1)
            rows = img.shape[0] // 2
            return torch.mean((img[:rows] - target[:rows]) ** 2)

        with _patched(inverse, "render_loss", half):
            yield
    elif fault == "unchanged":
        with _patched(torch.optim.Adam, "step",
                      lambda self, closure=None: None):
            yield
    else:
        raise ValueError(fault)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--calls", type=int, default=24)
    ap.add_argument("--pixels", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from bench_port import harness

    for key in [k for k in os.environ if k.startswith("RT_")]:
        del os.environ[key]
    os.environ.update(harness.cache_env(root))
    import torch

    cell = harness.Cell(args.workload, root)
    kind = cell.traffic["entry"]
    entry_mod = cell.entry_module()
    out_dir = os.path.join(root, "bench_port", "out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"calibrate_{args.workload}.jsonl")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        with open(path, "a") as f:
            f.write(line + "\n")

    def setup(seed):
        run = types.SimpleNamespace(root=root, cfg=cell.cfg,
                                    traffic=cell.traffic, seed=seed,
                                    device=args.device,
                                    keep_pixels=args.pixels)
        entry = entry_mod.Entry(run)
        for c in range(args.calls):
            entry.call()
            entry.keep(c)
        entry.release()
        harness._sync(args.device)
        return entry

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        entry = setup(seed)
        t1 = time.perf_counter()
        emit({"workload": args.workload, "seed": seed, "side": "program",
              "numbers": entry.check(), "run_s": t1 - t0,
              "losses": getattr(entry, "outputs", {}).get("losses"),
              "reference_losses": getattr(entry, "reference_losses", None),
              "check_s": time.perf_counter() - t1})
        if i >= args.control:
            continue
        t1 = time.perf_counter()
        emit({"workload": args.workload, "seed": seed, "side": "control",
              "numbers": entry.control(), "check_s": time.perf_counter() - t1})
        for fault in FAULTS[kind]:
            with planted(fault, kind):
                broken = setup(seed)
            emit({"workload": args.workload, "seed": seed, "side": fault,
                  "numbers": broken.check()})
    if args.device == "cuda":
        emit({"device": torch.cuda.get_device_name(0),
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated())})
    return 0


if __name__ == "__main__":
    sys.exit(main())
