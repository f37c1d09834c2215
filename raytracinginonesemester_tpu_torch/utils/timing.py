"""Timing on the card with CUDA events.

Port of ``raytracinginonesemester_tpu.utils.timing``.  Device times come
from CUDA events around each call; ``sync`` is the reference's
``cudaDeviceSynchronize`` before stopping a timer (``main.cu:290``).
There is no CPU fallback: a device time is only measured on a device.
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["sync", "cuda_time_ms"]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_time_ms(fn: Callable, *args, warmup: int = 1, iters: int = 3) -> dict:
    """Per-call device time of ``fn(*args)`` in ms from CUDA events, each
    call timed alone after ``warmup`` calls; returns the median, min,
    max and every sample."""
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
