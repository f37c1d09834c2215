"""Timing, throughput metrics and profiling.

Port of ``raytracinginonesemester_tpu.utils.timing``: the reference's
measurement discipline (``std::chrono`` spans around renders with a
device sync, ``main.cu:281-293, 361-378``; warm-up passes,
``warmup.h:10-90``; rays/s).  Device times come from CUDA events
(``cuda_time_ms``), which need a card; ``Timer`` and ``measure`` are host
clocks that synchronize the card where the JAX package fetches a
scalar, so on CPU tensors they time the host's work.  ``profile_trace``
records a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Callable

import torch

__all__ = ["sync", "Timer", "measure", "profile_trace", "rays_per_second",
           "cuda_time_ms"]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def sync(tree=None) -> None:
    """Wait for the card (``cudaDeviceSynchronize``, ``main.cu:290``):
    with no argument, for the current CUDA device; with a tensor or a
    nest of them, for each CUDA device they lie on (CPU tensors need no
    wait)."""
    if tree is None:
        torch.cuda.synchronize()
        return
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock span that waits for ``result``'s device on exit.

    >>> with Timer("render") as t:
    ...     t.result = render_scene(scene)
    >>> t.seconds
    """

    def __init__(self, name: str = "", echo: bool = False):
        self.name = name
        self.echo = echo
        self.result = None
        self.seconds = 0.0

    def __enter__(self):
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self.result is not None:
            sync(self.result)
        self.seconds = time.time() - self.t0
        if self.echo:
            print(f"{self.name}: {self.seconds * 1e3:.2f} ms", file=sys.stderr)
        return False


def measure(fn: Callable, *args, warmup: int = 1, iters: int = 5) -> dict:
    """Warm-up, then ``iters`` host-clock timings of ``fn(*args)``, each
    ending when its result's device is done (``warmup.h``,
    ``main.cu:361-367``) -> seconds: median, min, max."""
    for _ in range(warmup):
        sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.time()
        sync(fn(*args))
        times.append(time.time() - t0)
    times.sort()
    return {"median_s": times[len(times) // 2], "min_s": times[0],
            "max_s": times[-1], "iters": iters}


@contextlib.contextmanager
def profile_trace(log_dir: str = "torch_trace"):
    """Record a ``torch.profiler`` trace of the block (CPU, and the card
    when there is one) into ``log_dir/trace.json`` (Chrome trace
    format); yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def rays_per_second(width: int, height: int, spp: int, seconds: float,
                    waves: int = 1) -> dict:
    """Derived throughput: camera rays and the traced-ray estimate."""
    camera_rays = width * height * spp
    return {
        "camera_rays_per_s": camera_rays / seconds,
        "traced_rays_per_s_est": camera_rays * waves / seconds,
        "frame_ms": seconds * 1e3,
    }


def cuda_time_ms(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> dict:
    """Per-call device time of ``fn(*args)`` in ms from CUDA events, each
    call timed alone after ``warmup`` calls; returns the median, min,
    max and every sample.  There is no CPU fallback: a device time is
    only measured on a device."""
    if not torch.cuda.is_available():
        raise RuntimeError("cuda_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    sync()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    ordered = sorted(times)
    return {"median_ms": ordered[len(ordered) // 2], "min_ms": ordered[0],
            "max_ms": ordered[-1], "samples_ms": times}
