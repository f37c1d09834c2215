"""The reduction of the program's ``rt.*`` spans (``bench_port/spans.py``)
on synthetic raw profiler records, and the script's refusal to run
without a card."""

from __future__ import annotations

import os
import types

import pytest
import torch

from bench_port import spans, trace

MS = 1_000_000  # ns
MAIN, AUTOGRAD = 1, 2  # host threads


class _Raw:
    """A raw record, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, on_dev, s, e, tid=MAIN, annotation=None,
                 corr=None):
        from torch.autograd import DeviceType

        if annotation is None:
            annotation = name.startswith("rt.") or name == trace.WINDOW_SPAN
        self._v = (name, DeviceType.CUDA if on_dev else DeviceType.CPU, s, e,
                   annotation, tid, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]


def _call():
    """A 100 ms window holding one call: its root on the main thread, a
    grid span, a ladder with a sync inside, a backward span whose launch
    runs on autograd's thread; device activity at [10, 20], [50, 55] (a
    copy to the host inside the sync) and [70, 75] (a copy outside every
    sync span)."""
    return [
        _Raw(trace.WINDOW_SPAN, False, 0, 100 * MS),
        _Raw("rt.dispatch.frames", False, 5 * MS, 95 * MS),
        _Raw("rt.dispatch.grid", False, 20 * MS, 40 * MS),
        _Raw("rt.glue.ladder", False, 45 * MS, 60 * MS),
        _Raw("rt.sync.overflow", False, 48 * MS, 56 * MS),
        _Raw("aten::item", False, 48 * MS, 56 * MS),
        _Raw("rt.glue.backward", False, 60 * MS, 90 * MS),
        _Raw("rt.launch.segment_accum", False, 62 * MS, 80 * MS,
             tid=AUTOGRAD),
        _Raw("void emit_kernel<false>(SceneArgs)", True, 10 * MS, 20 * MS),
        _Raw("Memcpy DtoH (Device -> Pageable)", True, 50 * MS, 55 * MS),
        _Raw("Memcpy DtoH (Device -> Pageable)", True, 70 * MS, 75 * MS),
        # the profiler's mirror of a host annotation on the device
        _Raw("rt.glue.ladder", True, 45 * MS, 60 * MS, annotation=True),
    ]


def test_self_time_subtracts_the_same_threads_children_only():
    r = spans.reduce(_call())
    got = r["self_s_by_name"]
    # the root's 90 ms less the grid (20), the ladder (15) and the
    # backward (30), not less the launch on autograd's thread
    assert got["rt.dispatch.frames"] == pytest.approx(0.025)
    assert got["rt.glue.ladder"] == pytest.approx(0.015 - 0.008)
    assert got["rt.glue.backward"] == pytest.approx(0.030)
    assert got["rt.launch.segment_accum"] == pytest.approx(0.018)
    assert r["self_s"] == pytest.approx({"dispatch": 0.045, "glue": 0.037,
                                         "sync": 0.008, "launch": 0.018})
    assert r["count"] == {"dispatch": 2, "glue": 2, "launch": 1, "sync": 1}
    assert r["count_by_name"]["rt.sync.overflow"] == 1


def test_idle_time_goes_to_the_innermost_covering_span():
    r = spans.reduce(_call())
    idle = r["idle_s_by_name"]
    # busy [10, 20], [50, 55], [70, 75]: 80 ms idle
    assert r["idle_s"] == pytest.approx(0.080)
    assert sum(idle.values()) == pytest.approx(0.080)
    assert idle["none"] == pytest.approx(0.005 + 0.005)  # [0, 5], [95, 100]
    assert idle["rt.dispatch.frames"] == pytest.approx(0.005 + 0.005 + 0.005)
    assert idle["rt.dispatch.grid"] == pytest.approx(0.020)
    assert idle["rt.glue.ladder"] == pytest.approx(0.003 + 0.004)
    assert idle["rt.sync.overflow"] == pytest.approx(0.002 + 0.001)
    assert idle["rt.glue.backward"] == pytest.approx(0.002 + 0.010)
    # on [62, 80] the latest started span of any thread is the launch
    assert idle["rt.launch.segment_accum"] == pytest.approx(0.018 - 0.005)
    assert r["idle_s_by_layer"]["none"] == pytest.approx(0.010)


def test_a_copy_outside_every_sync_span_is_counted():
    r = spans.reduce(_call())
    assert r["d2h_copies"] == 2
    assert r["d2h_uncovered"] == 1
    assert r["d2h_uncovered_in"] == {"rt.launch.segment_accum": 1}


def test_a_copy_is_placed_by_the_runtime_call_that_issued_it():
    """The device's clock may place a copy a little outside the sync span
    whose read issued it: the host's runtime call, linked by its
    correlation id, decides, on its own thread."""
    raw = _call()[:-3] + [
        # the read at [48, 56] issued its copy at 55.5 on the host; the
        # device's record lands at [56.5, 57]
        _Raw("cudaMemcpyAsync", False, 55 * MS, 56 * MS, corr=7),
        _Raw("Memcpy DtoH (Device -> Pageable)", True, 56_500_000,
             57 * MS, corr=7),
        # a copy issued on autograd's thread, inside the main thread's
        # sync span's time but not in a sync span of its own thread
        _Raw("cudaMemcpyAsync", False, 50 * MS, 51 * MS, tid=AUTOGRAD,
             corr=8),
        _Raw("Memcpy DtoH (Device -> Pageable)", True, 50 * MS, 51 * MS,
             corr=8)]
    r = spans.reduce(raw)
    assert r["d2h_copies"] == 2 and r["d2h_by_runtime_call"] == 2
    assert r["d2h_uncovered"] == 1
    assert r["d2h_uncovered_in"] == {"rt.sync.overflow": 1}


def test_spans_leave_the_trace_summary_as_it_was():
    """The program's annotations are host events: busy, kernel and glue
    time and the copies read the same with and without them."""
    names = {"emit_kernel"}
    with_spans = trace.summarize(
        trace.events(_prof(_call())), names)
    without = trace.summarize(trace.events(_prof(
        [e for e in _call() if not e.name().startswith("rt.")])), names)
    for key in ("busy_s", "kernel_s", "glue_s", "d2h_copies", "window_s"):
        assert with_spans[key] == pytest.approx(without[key])
    assert with_spans["breakdown"]["idle_gaps"][0][0].startswith(
        "rt.dispatch.frames > ")


def _prof(raw):
    results = types.SimpleNamespace(events=lambda: raw)
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


def test_the_window_must_be_in_the_records():
    with pytest.raises(RuntimeError):
        spans.reduce(_call()[1:])


def test_the_script_refuses_to_run_without_a_card(monkeypatch, capsys):
    """Without the cell's CUDA devices the script exits 2, saying why,
    and neither prints nor writes a summary."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # the script sets the program's environment as run.py does
    monkeypatch.setattr(os, "environ", dict(os.environ))
    out = os.path.join(os.path.dirname(os.path.dirname(spans.__file__)),
                       "bench_port", "out", "frog_1080p.terminal.spans.json")
    before = os.path.getmtime(out) if os.path.exists(out) else None
    rc = spans.main(["--workload", "frog_1080p.terminal", "--seed",
                     str(2**31 + 7), "--seconds", "1"])
    got = capsys.readouterr()
    assert rc == 2
    assert got.out == ""
    assert "needs 1 CUDA device(s); found 0" in got.err
    after = os.path.getmtime(out) if os.path.exists(out) else None
    assert after == before
