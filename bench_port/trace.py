"""The reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read.

Device activity is every kernel, copy and memset on any stream; the
mirrors of host annotations on the device's timeline are not.  The
device is busy where the union of their intervals covers the window; a
kernel is the program's own when its name is a ``__global__`` function of
the port's ``csrc/`` or a Triton kernel the port defines (both read from
the sources at run time, so a kernel that a later change adds counts
without an edit); every other device activity is glue.  Device-to-host
copies are counted from the device's own records.  The longest idle gaps
are named by the host operations that ran across them.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

WINDOW_SPAN = "bench_port.window"
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:@[^\n]*\n)*def\s+(\w+)")


def program_kernels(package_dir: str) -> set:
    """Names of the kernels the package defines: ``__global__`` functions
    in ``csrc/*.cu`` and ``@triton.jit`` functions in its modules."""
    names = set()
    for path in glob.glob(os.path.join(package_dir, "csrc", "*.cu")):
        with open(path) as f:
            names.update(_GLOBAL.findall(f.read()))
    for path in glob.glob(os.path.join(package_dir, "**", "*.py"),
                          recursive=True):
        with open(path) as f:
            text = f.read()
        if "triton" in text:
            names.update(_TRITON.findall(text))
    return names


def events(prof):
    """(name, on_device, start_ns, end_ns) of every event of a stopped
    profiler, from its raw records.  A user annotation is a host event:
    the profiler mirrors each one (the window's span, ``torch.optim``'s
    ``Optimizer.step#Adam.step``) onto the device's timeline, and a
    mirror is not device activity, so it is dropped here."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        raise RuntimeError("this PyTorch's profiler keeps no kineto_results")
    from torch.autograd import DeviceType

    for e in raw.events():
        on_dev = e.device_type() != DeviceType.CPU
        if on_dev and e.is_user_annotation():
            continue
        yield e.name(), on_dev, e.start_ns(), e.end_ns()


def _kernel_regex(names):
    if not names:
        return None
    return re.compile(r"(?<![\w])(" + "|".join(sorted(map(re.escape, names)))
                      + r")(?![\w])")


def summarize(evts, kernel_names, top: int = 10) -> dict:
    """Window, busy and idle time, the program's kernel and glue time,
    device-to-host copies, and the breakdown of the traced window."""
    cpu, dev, win = [], [], None
    for name, on_dev, s, e in evts:
        if name == WINDOW_SPAN and not on_dev:
            win = (s, e)
        elif on_dev:
            dev.append((name, s, e))
        else:
            cpu.append((name, s, e))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = win
    window_s = (w1 - w0) / 1e9
    out = {"window_s": window_s, "device_events": 0}
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev if e > w0 and s < w1]
    if not dev:
        return out
    kern = _kernel_regex(kernel_names)
    kernel_ns = glue_ns = d2h = 0
    by_name = {}
    for n, s, e in dev:
        if "DtoH" in n or "Device -> Pageable" in n or "Device -> Pinned" in n:
            d2h += 1
        if kern is not None and kern.search(n):
            kernel_ns += e - s
        else:
            glue_ns += e - s
        by_name[n] = by_name.get(n, 0) + (e - s)
    starts = np.array([s for _, s, _ in dev], np.int64)
    ends = np.array([e for _, _, e in dev], np.int64)
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    run_end = np.maximum.accumulate(ends)
    new = np.ones(len(starts), bool)
    new[1:] = starts[1:] > run_end[:-1]
    seg_s = starts[new]
    seg_e = np.maximum.reduceat(ends, np.nonzero(new)[0])
    busy_ns = int((seg_e - seg_s).sum())
    gap_s = np.concatenate([[w0], seg_e])
    gap_e = np.concatenate([seg_s, [w1]])
    gaps = sorted(zip((gap_e - gap_s).tolist(), gap_s.tolist(),
                      gap_e.tolist()), reverse=True)[:top]
    c_s = np.array([s for _, s, _ in cpu], np.int64)
    c_e = np.array([e for _, _, e in cpu], np.int64)
    idle = []
    for length, s, e in gaps:
        if length <= 0:
            break
        mid = (s + e) // 2
        over = np.nonzero((c_s <= mid) & (c_e >= mid))[0]
        if len(over):
            span = c_e[over] - c_s[over]
            outer = cpu[over[np.argmax(span)]][0]
            inner = cpu[over[np.argmin(span)]][0]
            label = outer if outer == inner else f"{outer} > {inner}"
        else:
            label = "host Python between operations"
        idle.append([label, length / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    out.update(device_events=len(dev), busy_s=busy_ns / 1e9,
               kernel_s=kernel_ns / 1e9, glue_s=glue_ns / 1e9,
               d2h_copies=d2h,
               breakdown={"device_ops": [[n, t / 1e9] for n, t in ops],
                          "idle_gaps": idle})
    return out
