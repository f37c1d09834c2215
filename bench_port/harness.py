"""One run of one cell: set-up, the measured window, the check and the
result line.

Everything that belongs to one configuration, traffic mix, entry or
metric is found by name: ``BENCHMARK.json`` at the checkout's root names
the cells and metrics; ``configs/``, ``traffic/<cell>.json``,
``limits/<cell>.json``, ``entries/<entry>.py``, ``reference/`` and
``metrics/<family>.py`` under this directory hold the rest.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import resource
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
PACKAGE = "raytracinginonesemester_tpu_torch"
# top-level module names that may not be loaded in a run, compared whole:
# the port's name begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "raytracinginonesemester_tpu")


def cache_env(root: str = ROOT) -> dict:
    """Fixed cache directories inside the checkout: the port's nvcc builds,
    its capacity calibration and Triton's cache."""
    cache = os.path.join(root, os.path.basename(HERE), ".cache")
    return {"RT_TORCH_BUILD_DIR": os.path.join(cache, "build"),
            "RT_TORCH_CAP_CACHE": os.path.join(cache, "capacity"),
            "TRITON_CACHE_DIR": os.path.join(cache, "triton")}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str, e2e: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or, without one, every cell for an end-to-end metric
    and every cell that reports its ``moves`` metric for a per-layer one."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e


class Cell:
    """A cell of ``BENCHMARK.json`` with its files."""

    def __init__(self, name: str, root: str = ROOT):
        bench = load_json(os.path.join(root, "BENCHMARK.json"))
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        config = [c for c in bench["configs"]
                  if c["name"] == self.workload["config"]][0]
        self.cfg = load_json(os.path.join(root, config["file"]))
        here = os.path.join(root, os.path.basename(HERE))
        self.traffic = load_json(os.path.join(here, "traffic", f"{name}.json"))
        self.limits = load_json(os.path.join(here, "limits", f"{name}.json"))
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, name, set())]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if applies(m, name, e2e)]

    def entry_module(self):
        return importlib.import_module(
            f"{__package__}.entries.{self.traffic['entry']}")


def read_metric(metric: dict, record: dict):
    family = metric["name"].split(".")[0]
    reader = importlib.import_module(f"{__package__}.metrics.{family}")
    return reader.read(record, metric["name"])


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class _HostClock:
    """What the host did during the window, for the run's diagnostics:
    its CPU time against the wall, the context switches that others
    forced on it, and the time the garbage collector took."""

    def __init__(self):
        self.gc_s, self._gc0 = 0.0, None

    def _gc(self, phase, info):
        if phase == "start":
            self._gc0 = time.perf_counter()
        elif self._gc0 is not None:
            self.gc_s += time.perf_counter() - self._gc0

    def __enter__(self):
        self.cpu0, self.ru0 = time.process_time(), resource.getrusage(
            resource.RUSAGE_SELF)
        gc.callbacks.append(self._gc)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._gc)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu_s = time.process_time() - self.cpu0
        self.forced_switches = ru.ru_nivcsw - self.ru0.ru_nivcsw
        return False


def measure(entry, seconds: float, device) -> dict:
    """The closed loop: call, synchronise, keep, until ``seconds`` have
    passed; every call's latency from its start to its synchronise."""
    lat, units = [], 0
    with _HostClock() as host:
        t0 = time.perf_counter()
        while True:
            c0 = time.perf_counter()
            units += entry.call()
            _sync(device)
            c1 = time.perf_counter()
            lat.append(c1 - c0)
            entry.keep(len(lat) - 1)
            if c1 - t0 >= seconds:
                break
        _sync(device)
        window_s = time.perf_counter() - t0
    return {"window_s": window_s, "units": units, "calls": len(lat),
            "latencies": lat,
            "host": {"cpu_s": host.cpu_s, "gc_s": host.gc_s,
                     "forced_switches": host.forced_switches}}


def fifths_ms(lat: list) -> list:
    """The median call of each fifth of the window, in ms: whether the
    calls slowed or sped up within the run."""
    n = len(lat)
    parts = [sorted(lat[i * n // 5:(i + 1) * n // 5]) for i in range(5)]
    return [p[len(p) // 2] * 1e3 for p in parts if p]


def traced(entry, seconds: float, device, root: str = ROOT) -> tuple:
    """``measure`` under one ``torch.profiler`` session (host and device
    activity) -> (window record, trace summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from . import trace

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    with record_function(trace.WINDOW_SPAN):
        rec = measure(entry, seconds, device)
    prof.stop()
    t0 = time.perf_counter()
    names = trace.program_kernels(os.path.join(root, PACKAGE))
    summary = trace.summarize(trace.events(prof), names)
    del prof
    summary["reduce_s"] = time.perf_counter() - t0
    return rec, summary


def _ok(value, limit) -> bool:
    return isinstance(value, (int, float)) and not math.isnan(value) \
        and value <= limit


def run(name: str, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", root: str = ROOT, keep_pixels: int = None,
        out=None, err=None) -> int:
    """One run of cell ``name``; prints the result line on ``out`` and
    returns the exit code."""
    out, err = out or sys.stdout, err or sys.stderr
    import torch

    cell = Cell(name, root)
    chips = int(cell.workload["chips"])
    if torch.device(device).type == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < chips):
        print(f"bench_port: {name} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=err)
        return 2
    run_ns = types.SimpleNamespace(root=root, cfg=cell.cfg,
                                   traffic=cell.traffic, seed=int(seed),
                                   device=device, keep_pixels=keep_pixels)
    entry = cell.entry_module().Entry(run_ns)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    if trace:
        rec, summary = traced(entry, seconds, device, root)
    else:
        rec, summary = measure(entry, seconds, device), None
    cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    entry.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = entry.check()
    check_s = time.perf_counter() - t0
    record = dict(rec, setup_s=setup_s, unit=entry.unit, trace=summary)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = read_metric(m, record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    bad = forbidden_modules()
    if bad:
        print(f"bench_port: loaded in this process: {', '.join(bad)}",
              file=err)
        return 3
    limits = {k: float(v["limit"]) for k, v in cell.limits["numbers"].items()}
    correct = set(numbers) == set(limits) and all(
        _ok(numbers[k], limits[k]) for k in limits)
    from raytracinginonesemester_tpu_torch.ops._native import BUILD_LOG

    # the nvcc seconds of this run's builds (0.0: built before): what
    # splits a checkout's first set-up from the others
    info = {"calls": rec["calls"], "units": rec["units"],
            "window_s": rec["window_s"], "check_s": check_s,
            "call_ms_fifths": fifths_ms(rec["latencies"]),
            "harness_s": getattr(entry, "harness_s", 0.0), **rec["host"],
            "nvcc_s": {k: v["seconds"] for k, v in BUILD_LOG.items()
                       if v["seconds"] is not None}}
    if summary is not None:
        info["trace_reduce_s"] = summary["reduce_s"]
    print(f"bench_port: {name} seed {seed}: {json.dumps(info)}", file=err)
    device_rec = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                  "count": chips if cuda else 0, "memory_peak_bytes": peak}
    result = {"workload": name, "seed": int(seed), "correct": correct,
              "attempted": rec["calls"], "failed": 0, "metrics": metrics,
              "device": device_rec}
    if summary is not None:
        device_rec["busy_s"] = summary.get("busy_s", 0.0)
        device_rec["window_s"] = summary["window_s"]
        if "breakdown" in summary:
            result["breakdown"] = summary["breakdown"]
        out_dir = os.path.join(root, os.path.basename(HERE), "out")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{name}.trace.json"), "w") as f:
            json.dump(summary, f)
    result["check"] = {k: {"value": numbers.get(k), "limit": limits[k]}
                       for k in limits}
    for k in limits:
        print(f"check {k} {numbers.get(k)!r} limit {limits[k]!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
