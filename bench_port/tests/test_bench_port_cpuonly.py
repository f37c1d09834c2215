"""The CPUOnly soft-shadow cell (``mirror_1080p.soft``) at test sizes on the
CPU: its entry agrees with its reference (``reference/cpuonly.py``), and
the control and every fault that a render cell can have come out not
correct; its configuration's box is the one its own loader projects; and
its reference imports nothing of the program."""

from __future__ import annotations

import ast
import io
import json
import os
import shutil

import pytest

from bench_port import calibrate, harness
from bench_port.reference import cpuonly_scene

CELL = "mirror_1080p.soft"
CONFIG = "mirror_1080p"
W, H = 64, 32
SEED = 2 ** 31 + 4321  # a seed past 32 signed bits
SETTINGS = {"max_bounces": 1, "diffuse_bounce": False}


def _box(cfg: dict, root: str) -> list:
    return list(cpuonly_scene.screen_box(cpuonly_scene.build(cfg, SETTINGS,
                                                             root)))


@pytest.fixture(scope="module")
def root(small_root, tmp_path_factory):
    """The shared test copy (two frames and 64 checked pixels a call),
    copied again with this cell's configuration at 64x32, which the
    shared copy leaves at its size; the traffic's depth, diffuse bounces
    and 32-sample area light are kept."""
    dest = str(tmp_path_factory.mktemp("cpuonly") / "root")
    shutil.copytree(small_root, dest, symlinks=True)
    path = os.path.join(dest, "bench_port", "configs", f"{CONFIG}.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["camera"]["pixel_width"], cfg["camera"]["pixel_height"] = W, H
    cfg["cpuonly_check_box"] = _box(cfg, dest)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return dest


def _run(root, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(CELL, seed, 0.0, False, 0.0, device="cpu", root=root,
                     out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1])


def test_the_reference_agrees_with_the_port(root):
    result = _run(root)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"frame_ms", "setup_s"}


def test_the_control_is_not_correct(root):
    import types

    cell = harness.Cell(CELL, root)
    run = types.SimpleNamespace(root=root, cfg=cell.cfg,
                                traffic=cell.traffic, seed=7, device="cpu",
                                keep_pixels=None)
    entry = cell.entry_module().Entry(run)
    for i in range(2):
        entry.call()
        entry.keep(i)
    entry.release()
    numbers = entry.control()
    limits = {k: v["limit"] for k, v in cell.limits["numbers"].items()}
    assert not all(harness._ok(numbers[k], limits[k]) for k in limits), \
        numbers


@pytest.mark.parametrize("fault", calibrate.FAULTS["render_frames"])
def test_a_broken_render_is_not_correct(root, fault):
    # the render faults patch render_scene_frames, which this entry calls
    with calibrate.planted(fault, "render_frames"):
        result = _run(root)
    assert not result["correct"], result["check"]


def test_the_check_box_is_where_the_triangles_project():
    """The configuration's ``cpuonly_check_box`` is the box that the
    benchmark's own CPUOnly loader projects (its camera keeps the
    schema's 36 mm sensor width; the gpu loader would derive another)."""
    cfg = harness.load_json(os.path.join(harness.ROOT, "bench_port",
                                         "configs", f"{CONFIG}.json"))
    assert cfg["cpuonly_check_box"] == _box(cfg, harness.ROOT)


def test_the_cpuonly_reference_imports_nothing_of_the_program():
    """Every top-level module that ``reference/cpuonly.py`` reaches, its
    relative imports followed through ``reference/``: no JAX, no JAX
    package, no port."""
    here = os.path.join(harness.ROOT, "bench_port", "reference")
    todo, seen, top = ["cpuonly", "cpuonly_scene"], set(), set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        tree = ast.parse(open(os.path.join(here, f"{name}.py")).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                top.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level:
                todo += [node.module] if node.module else \
                    [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                top.add(node.module.split(".")[0])
    assert {"cpuonly", "cpuonly_scene", "scene", "tracer"} <= seen
    forbidden = {"jax", "jaxlib", "flax", "raytracinginonesemester_tpu",
                 harness.PACKAGE}
    assert not top & forbidden, sorted(top)
    assert {"torch", "numpy"} <= top
