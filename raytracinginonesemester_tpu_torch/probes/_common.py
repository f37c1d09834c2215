"""What the probe modules share: the launch of a ``probes.cu`` kernel and
the timing of their ``main()``."""

from __future__ import annotations

import subprocess
import time

import torch

from ..ops.megakernel import _ptr, _raise_on, _stream

__all__ = ["launch", "launch_floor", "card", "timed"]


def launch(c_name: str, label: str, *args) -> None:
    """Call ``rt_<c_name>`` of ``probes.cu`` on the current stream; a
    tensor argument passes its pointer.  Raises if the launch failed."""
    from ..ops._native import load

    lib = load("probes")
    conv = [_ptr(a) if isinstance(a, torch.Tensor) else a for a in args]
    _raise_on(lib, getattr(lib, f"rt_{c_name}")(*conv, _stream()), label)


def launch_floor(ctas: int, threads: int, cluster: int = 1) -> None:
    """An empty kernel of ``ctas`` CTAs of ``threads`` threads in clusters
    of ``cluster`` (1, or 8 as ``toy_mask``'s grid), launched through
    ``launch``: the floor under a probe's device time and enqueue.  On
    the card only (no launch counter: it replaces no TPU kernel)."""
    if cluster not in (1, 8) or ctas % cluster:
        raise ValueError(f"{ctas} CTAs in clusters of {cluster}")
    launch("probe_floor", "probe_floor", ctas, threads, cluster)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them;
    raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device (the probes time the card)")
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def timed(name: str, fn, visits: int, iters: int = 5) -> float:
    """The script's ``timed`` line on the card: the first call's host
    seconds ("warm", the build included), then the median of ``iters``
    CUDA-event timings of one call each, and the output's sum."""
    from ..utils.timing import cuda_time_ms

    t0 = time.time()
    c = float(fn().sum())
    warm = time.time() - t0
    med = cuda_time_ms(fn, warmup=0, iters=iters)["median_ms"]
    print(f"{name:8s}: {med:8.3f} ms  ({med / visits * 1e3:6.2f} us/"
          f"visit)  warm {warm:.1f}s  chk {c:.6e}", flush=True)
    return c
