"""The program's spans in a traced window.

The port marks each host layer of a call with ``rt.<layer>.<what>``
spans (``raytracinginonesemester_tpu_torch/utils/timing.py``, layers
``dispatch``, ``glue``, ``sync`` and ``launch``): ``torch.profiler`` user
annotations, recorded only while a profiler session records.
``reduce(raw)`` reads them from a stopped profiler's raw records, on the
profiler's clock beside the device's activity: self time and count by
layer and by name, the device's idle time in the window split by the
innermost span that covers it on any thread (``none`` where no span
does), and the device-to-host copies that no ``rt.sync.*`` span covers,
with the innermost span around each.  The self times are host times
under the profiler, which records every operation as well: they run
several times their untraced values, and only their proportions carry
over to an untraced run.

Run as a script, it records one window of a cell under the profiler as
``run.py --trace 1`` does, without the check, and prints the summary of
``trace.py`` with this reduction under ``spans`` (also written to
``bench_port/out/<cell>.spans.json``).  Like ``run.py`` it needs the
cell's CUDA devices, and exits with code 2, writing nothing, without
them:

    python3 bench_port/spans.py --workload <cell> --seed <n> --seconds <s>
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import types
from collections import defaultdict

import numpy as np

PREFIX = "rt."


def layer_of(name: str) -> str:
    """``rt.<layer>.<what>`` -> ``<layer>``."""
    return name.split(".")[1]


def raw_events(prof):
    """The raw records of a stopped profiler."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        raise RuntimeError("this PyTorch's profiler keeps no kineto_results")
    return raw.events()


def _is_d2h(name: str) -> bool:
    # trace.summarize's test, so that both count the same copies
    return "DtoH" in name or "Device -> Pageable" in name \
        or "Device -> Pinned" in name


def _self_times(spans):
    """Per span name: (count, self ns), the self time being a span's
    duration less the part its child spans on the same thread cover."""
    count, self_ns = defaultdict(int), defaultdict(int)
    threads = defaultdict(list)
    for tid, s, e, name in spans:
        threads[tid].append((s, -e, name))

    def close(stack):
        end, name, child, start = stack.pop()
        count[name] += 1
        self_ns[name] += (end - start) - child
        if stack:
            parent = stack[-1]
            parent[2] += max(0, min(end, parent[0]) - max(start, parent[3]))

    for items in threads.values():
        items.sort()  # by start, the longer first
        stack = []
        for s, neg_e, name in items:
            while stack and stack[-1][0] <= s:
                close(stack)
            stack.append([-neg_e, name, 0, s])
        while stack:
            close(stack)
    return count, self_ns


def _idle_cum(gap_s, gap_e, t):
    """Idle ns in [window start, t] for each t, the idle gaps sorted and
    disjoint."""
    lengths = gap_e - gap_s
    before = np.concatenate([[0], np.cumsum(lengths)])
    i = np.searchsorted(gap_s, t, side="right") - 1
    safe = np.maximum(i, 0)
    part = np.clip(t - gap_s[safe], 0, lengths[safe])
    return np.where(i >= 0, before[safe] + part, 0)


def _segments(spans, w0, w1):
    """The window cut at every span boundary -> (starts, ends, labels):
    each piece's label is the innermost span that covers it on any
    thread (the latest started of the threads' innermost), or none."""
    bounds = []
    for i, (_, s, e, _) in enumerate(spans):
        if e > s:  # an empty span covers nothing
            bounds.append((s, 1, s - e, i))  # starts after ends; outer first
            bounds.append((e, 0, e - s, i))  # inner ends first
    bounds.sort()
    stacks = defaultdict(list)
    starts, ends, labels = [], [], []
    prev, label = w0, None
    for t, kind, _, i in bounds:
        if t > prev:
            starts.append(prev)
            ends.append(t)
            labels.append(label)
            prev = t
        stack = stacks[spans[i][0]]
        if kind:
            stack.append(i)
        elif stack and stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
        tops = [st[-1] for st in stacks.values() if st]
        label = max(tops, key=lambda j: spans[j][1]) if tops else None
    if w1 > prev:
        starts.append(prev)
        ends.append(w1)
        labels.append(label)
    return (np.array(starts, np.int64), np.array(ends, np.int64), labels)


def reduce(raw) -> dict:
    """The ``rt.*`` spans of raw profiler records inside the window span
    (``trace.WINDOW_SPAN``): self seconds and span counts by layer and by
    name, the device's idle seconds by the innermost covering span's
    layer and name, and the device-to-host copies, those that no
    ``rt.sync.*`` span covers, and the innermost span around each of
    those."""
    from torch.autograd import DeviceType

    from bench_port.trace import WINDOW_SPAN

    win, spans, dev, copies, calls = None, [], [], [], {}
    for e in raw:
        name = e.name()
        if e.device_type() != DeviceType.CPU:
            if not e.is_user_annotation():
                dev.append((name, e.start_ns(), e.end_ns()))
                if _is_d2h(name):
                    copies.append((_correlation(e), e.start_ns(),
                                   e.end_ns()))
        elif name == WINDOW_SPAN:
            win = (e.start_ns(), e.end_ns())
        elif name.startswith(PREFIX):
            spans.append((e.start_thread_id(), e.start_ns(), e.end_ns(),
                          name))
        elif name.startswith("cuda") and _correlation(e) is not None:
            # a CUDA runtime call on the host: the copy it issued has its
            # correlation id, and it ran on the host's clock and thread
            calls[_correlation(e)] = (e.start_thread_id(),
                                      (e.start_ns() + e.end_ns()) // 2)
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    w0, w1 = win
    spans = [(tid, max(s, w0), min(e, w1), n) for tid, s, e, n in spans
             if e > w0 and s < w1]
    dev = [(n, max(s, w0), min(e, w1)) for n, s, e in dev
           if e > w0 and s < w1]
    copies = [c for c in copies if c[2] > w0 and c[1] < w1]

    count, self_ns = _self_times(spans)
    out = {"window_s": (w1 - w0) / 1e9,
           "self_s_by_name": {n: v / 1e9 for n, v in sorted(self_ns.items())},
           "count_by_name": dict(sorted(count.items()))}
    out["self_s"] = _by_layer(out["self_s_by_name"])
    out["count"] = _by_layer(out["count_by_name"])

    # idle gaps: the window less the union of device activity
    if dev:
        iv = np.array(sorted((s, e) for _, s, e in dev), np.int64)
        run_end = np.maximum.accumulate(iv[:, 1])
        new = np.ones(len(iv), bool)
        new[1:] = iv[1:, 0] > run_end[:-1]
        seg_s = iv[new, 0]
        seg_e = np.maximum.reduceat(iv[:, 1], np.nonzero(new)[0])
        gap_s = np.concatenate([[w0], seg_e])
        gap_e = np.concatenate([seg_s, [w1]])
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
    else:
        gap_s = np.array([w0], np.int64)
        gap_e = np.array([w1], np.int64)
    starts, ends, labels = _segments(spans, w0, w1)
    idle = (_idle_cum(gap_s, gap_e, ends) - _idle_cum(gap_s, gap_e, starts)
            if len(starts) else np.zeros(0))
    by_name = defaultdict(float)
    for lab, ns in zip(labels, idle.tolist()):
        if ns:
            by_name["none" if lab is None else spans[lab][3]] += ns / 1e9
    out["idle_s"] = (float((gap_e - gap_s).sum()) / 1e9)
    out["idle_s_by_name"] = dict(sorted(by_name.items()))
    out["idle_s_by_layer"] = _by_layer(out["idle_s_by_name"])

    # device-to-host copies: covered where the runtime call that issued
    # the copy (or, without one in the records, the copy's midpoint on
    # the device's timeline) lies inside an rt.sync span of its thread
    syncs = defaultdict(list)
    for tid, s, e, n in spans:
        if n.startswith(PREFIX + "sync."):
            syncs[tid].append((s, e))
    syncs = {tid: (np.array([s for s, _ in v], np.int64),
                   np.maximum.accumulate(np.array([e for _, e in v],
                                                  np.int64)))
             for tid, v in ((t, sorted(v)) for t, v in syncs.items())}

    def covered(tid, t):
        for th, (ss, ee) in syncs.items():
            i = int(np.searchsorted(ss, t, side="right")) - 1
            if (tid is None or th == tid) and i >= 0 and ee[i] >= t:
                return True
        return False

    uncovered, matched = defaultdict(int), 0
    for corr, s, e in copies:
        mid = (s + e) // 2
        tid, at = calls.get(corr, (None, mid))
        matched += tid is not None
        if covered(tid, at):
            continue
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        lab = labels[j] if j >= 0 else None
        uncovered["none" if lab is None else spans[lab][3]] += 1
    out.update(d2h_copies=len(copies), d2h_by_runtime_call=matched,
               d2h_uncovered=sum(uncovered.values()),
               d2h_uncovered_in=dict(sorted(uncovered.items())))
    return out


def _correlation(e):
    get = getattr(e, "correlation_id", None)
    return get() if get is not None else None


def _by_layer(by_name: dict) -> dict:
    out = defaultdict(int)
    for name, v in by_name.items():
        out["none" if name == "none" else layer_of(name)] += v
    return dict(sorted(out.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    from bench_port import harness

    # the program's defaults and caches, as run.py sets them
    for key in [k for k in os.environ if k.startswith("RT_")]:
        del os.environ[key]
    os.environ.update(harness.cache_env(root))
    cell = harness.Cell(args.workload, root)
    threads = cell.traffic.get("host_threads")
    if threads:
        os.environ["OMP_NUM_THREADS"] = str(int(threads))
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench_port import trace

    chips = int(cell.workload["chips"])
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"bench_port: {args.workload} needs {chips} CUDA device(s); "
              f"found {found}", file=sys.stderr)
        return 2
    run = types.SimpleNamespace(root=root, cfg=cell.cfg, traffic=cell.traffic,
                                seed=args.seed, device="cuda",
                                keep_pixels=None)
    entry = cell.entry_module().Entry(run)
    harness._sync("cuda")
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    with record_function(trace.WINDOW_SPAN):
        rec = harness.measure(entry, args.seconds, "cuda")
    prof.stop()
    names = trace.program_kernels(os.path.join(root, harness.PACKAGE))
    summary = trace.summarize(trace.events(prof), names)
    summary["spans"] = reduce(raw_events(prof))
    del prof
    summary.update(calls=rec["calls"], units=rec["units"],
                   unit=entry.unit, window_s_host=rec["window_s"],
                   device=torch.cuda.get_device_name(0))
    out_dir = os.path.join(root, "bench_port", "out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{args.workload}.spans.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
