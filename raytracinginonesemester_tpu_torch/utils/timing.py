"""Device timing and the program's spans.

Port of ``raytracinginonesemester_tpu.utils.timing``'s device timing:
``sync`` waits for the card (``cudaDeviceSynchronize``, ``main.cu:290``)
and ``cuda_time_ms`` times a call with CUDA events, which need a card.

``span(name)`` marks a region of the port's host code as a
``torch.profiler`` user annotation, on the profiler's clock beside the
device's kernels and copies.  Names are ``rt.<layer>.<what>``, the layer
one of ``dispatch`` (the top-level calls' Python: the resolve, the pixel
grid, the training step), ``glue`` (the torch operations between kernels),
``sync`` (a host read of device data, one span a read) and ``launch``
(a kernel wrapper's card path, one span a launch that its module's
``launch_counts`` counts).  A span records only while a profiler session
records, an operator's own or a benchmark's; otherwise ``span`` returns
one shared no-op context at the cost of one flag read.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch

__all__ = ["sync", "cuda_time_ms", "span"]


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


# the no-op context of every span while no profiler records
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """Context of the span ``name`` (``rt.<layer>.<what>``, module
    docstring): a ``record_function`` annotation while a
    ``torch.profiler`` session records, else the shared no-op context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN
