"""Every cell, configuration, traffic mix, entry and metric of
``BENCHMARK.json`` is found by name, and a new cell is a new file."""

from __future__ import annotations

import io
import json
import os
import re

import pytest

from bench_port import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench(root=harness.ROOT):
    return harness.load_json(os.path.join(root, "BENCHMARK.json"))


def test_benchmark_json_keeps_the_contract_shape():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "bench_port/run.py"]
    assert bench["paths"] == ["bench_port"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_loads_by_name(cell):
    c = harness.Cell(cell)
    assert c.traffic["entry"] and hasattr(c.entry_module(), "Entry")
    assert set(c.limits["numbers"])
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        family = m["name"].split(".")[0]
        mod = __import__(f"bench_port.metrics.{family}", fromlist=["read"])
        assert callable(mod.read)


def test_a_new_traffic_file_is_a_new_cell(small_root):
    """A cell added as a traffic file, a limits file and an entry in
    ``BENCHMARK.json`` runs with no edit to any code."""
    here = os.path.join(small_root, "bench_port")
    with open(os.path.join(here, "traffic", "frog_1080p.terminal.json")) as f:
        traffic = json.load(f)
    traffic.update(max_bounces=2, frames_per_call=1)
    name = "frog_1080p.two_bounce"
    with open(os.path.join(here, "traffic", f"{name}.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(here, "limits", "frog_1080p.terminal.json")) as f:
        limits = f.read()
    with open(os.path.join(here, "limits", f"{name}.json"), "w") as f:
        f.write(limits)
    bench = _bench(small_root)
    bench["workloads"].append({"name": name, "config": "frog_1080p",
                               "traffic": "two_bounce", "chips": 1,
                               "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "frog_1080p.terminal" in m.get("workloads", ()):
            m["workloads"].append(name)
    try:
        with open(os.path.join(small_root, "BENCHMARK.json"), "w") as f:
            json.dump(bench, f)
        out, err = io.StringIO(), io.StringIO()
        rc = harness.run(name, 5, 0.0, False, 0.0, device="cpu",
                         root=small_root, out=out, err=err)
    finally:
        with open(os.path.join(small_root, "BENCHMARK.json"), "w") as f:
            json.dump(_bench(), f)
        for sub in ("traffic", "limits"):
            os.remove(os.path.join(here, sub, f"{name}.json"))
    assert rc == 0, err.getvalue()
    result = json.loads(out.getvalue().splitlines()[-1])
    assert result["correct"] and result["attempted"] == 1
    assert set(result["metrics"]) == {"frame_ms", "setup_s"}
    assert list(result)[-1] == "check"


def _boxed():
    """The configurations that give a ``check_box``."""
    cfgs = [harness.load_json(os.path.join(harness.ROOT, c["file"]))
            for c in _bench()["configs"]]
    return [c for c in cfgs if "check_box" in c]


@pytest.mark.parametrize("cfg", _boxed(), ids=lambda c: c["name"])
def test_a_check_box_is_where_the_triangles_project(cfg):
    """A configuration's ``check_box`` (where half of the checked pixels
    are drawn) is the box that the benchmark's own loader projects."""
    from bench_port.reference import scene

    arrays = scene.build(cfg, {"max_bounces": 1, "diffuse_bounce": False},
                         harness.ROOT)
    assert tuple(cfg["check_box"]) == scene.screen_box(arrays)
