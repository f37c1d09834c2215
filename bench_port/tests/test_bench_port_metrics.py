"""The metric arithmetic on synthetic records and trace events."""

from __future__ import annotations

import statistics

import pytest

from bench_port import trace
from bench_port.metrics import (call_p95_ms, d2h_copies_per_frame,
                                device_idle_pct, frame_ms, glue_ms_per_step,
                                kernel_ms_per_frame, kernel_ms_per_step,
                                setup_s, step_ms)

MS = 1_000_000  # ns


def _events():
    """A 100 ms window; two streams whose kernels overlap; a copy to the
    host; host operations across the gaps."""
    return [
        (trace.WINDOW_SPAN, False, 0, 100 * MS),
        ("aten::nonzero", False, 30 * MS, 60 * MS),
        ("cudaMemcpyAsync", False, 40 * MS, 55 * MS),
        ("void emit_kernel<false>(SceneArgs)", True, 10 * MS, 30 * MS),
        ("void at::native::elementwise_kernel<128>()", True, 20 * MS, 35 * MS),
        ("Memcpy DtoH (Device -> Pageable)", True, 35 * MS, 36 * MS),
        ("bounce_step_kernel<false, false, 8>", True, 70 * MS, 80 * MS),
        ("Memset (Device)", True, 75 * MS, 90 * MS),
        ("bounce_step_kernel<false, false, 8>", True, 95 * MS, 105 * MS),
    ]


def test_busy_time_is_the_union_over_streams_within_the_window():
    s = trace.summarize(_events(), {"emit_kernel", "bounce_step_kernel"})
    # [10, 36] + [70, 90] + [95, 100 (clipped)] = 26 + 20 + 5 ms
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.051)
    assert s["kernel_s"] == pytest.approx(0.020 + 0.010 + 0.005)
    assert s["glue_s"] == pytest.approx(0.015 + 0.001 + 0.015)
    assert s["d2h_copies"] == 1
    record = {"trace": s, "units": 4, "unit": "frame"}
    assert device_idle_pct.read(record, "device_idle_pct.render") == \
        pytest.approx(49.0)
    assert kernel_ms_per_frame.read(record, "") == pytest.approx(35.0 / 4)
    assert d2h_copies_per_frame.read(record, "") == pytest.approx(0.25)
    assert glue_ms_per_step.read(dict(record, unit="step"), "") == \
        pytest.approx(31.0 / 4)


class _Raw:
    """A profiler's raw record, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, on_dev, s, e, annotation=False):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if on_dev else DeviceType.CPU, s, e,
                   annotation)

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


def test_mirrored_annotations_are_not_device_activity():
    """The profiler mirrors host annotations (the window's span, the
    optimizer's step) onto the device's timeline: neither is busy time,
    kernel time or glue."""
    import types

    raw = [_Raw(*e, annotation=e[0] == trace.WINDOW_SPAN) for e in _events()]
    raw += [_Raw(trace.WINDOW_SPAN, True, 0, 100 * MS, annotation=True),
            _Raw("Optimizer.step#Adam.step", False, 60 * MS, 99 * MS,
                 annotation=True),
            _Raw("Optimizer.step#Adam.step", True, 40 * MS, 99 * MS,
                 annotation=True)]
    results = types.SimpleNamespace(events=lambda: raw)
    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))
    names = {"emit_kernel", "bounce_step_kernel"}
    got = trace.summarize(trace.events(prof), names)
    want = trace.summarize(_events(), names)
    for key in ("busy_s", "kernel_s", "glue_s", "d2h_copies", "window_s"):
        assert got[key] == pytest.approx(want[key])
    assert "Optimizer.step#Adam.step" not in dict(
        got["breakdown"]["device_ops"])


def test_a_profiler_without_raw_records_fails():
    import types

    with pytest.raises(RuntimeError):
        list(trace.events(types.SimpleNamespace(profiler=None)))


def test_idle_gaps_are_named_by_the_host_operations_across_them():
    s = trace.summarize(_events(), {"emit_kernel", "bounce_step_kernel"})
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0][0] == "aten::nonzero > cudaMemcpyAsync"
    assert gaps[0][1] == pytest.approx(0.034)
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    ops = dict(s["breakdown"]["device_ops"])
    assert ops["void emit_kernel<false>(SceneArgs)"] == pytest.approx(0.020)
    assert ops["bounce_step_kernel<false, false, 8>"] == pytest.approx(0.015)
    assert s["breakdown"]["device_ops"][0][0] == \
        "void emit_kernel<false>(SceneArgs)"


def test_a_trace_without_device_activity_reads_nothing():
    s = trace.summarize([(trace.WINDOW_SPAN, False, 0, MS)], {"x"})
    record = {"trace": s, "units": 3, "unit": "step"}
    for reader in (device_idle_pct, kernel_ms_per_step, glue_ms_per_step):
        assert reader.read(record, "") is None


def test_kernel_names_come_from_the_sources():
    import os

    from bench_port import harness

    names = trace.program_kernels(os.path.join(harness.ROOT, harness.PACKAGE))
    assert {"emit_kernel", "bounce_step_kernel", "render_kernel",
            "closest_kernel", "chunk_sum_kernel",
            "streamed_kernel"} <= names


def test_p95_and_rates_take_every_call_of_the_window():
    lat = [0.001 * (i + 1) for i in range(200)]
    p95 = call_p95_ms.read({"latencies": lat}, "")
    assert p95 == pytest.approx(
        statistics.quantiles(lat, n=100, method="inclusive")[94] * 1e3)
    assert 190.0 < p95 < 191.0
    rec = {"window_s": 2.5, "units": 40, "unit": "frame", "setup_s": 9.5}
    assert frame_ms.read(rec, "") == pytest.approx(62.5)
    assert step_ms.read(rec, "") is None
    assert step_ms.read(dict(rec, unit="step"), "") == pytest.approx(62.5)
    assert setup_s.read(rec, "") == 9.5
