"""The subdivided-mesh cells (``frog_large_1080p.wavefront`` and
``frog_large_1080p.staged``) at test sizes on the CPU: the frog
subdivided one level at 64x32, the plane budget lowered so that its grid
goes over it as the 1.27M-triangle grid does.  The entry agrees with its
reference (``reference/subdivided.py``) on both sides of the budget, the
control and every fault that a render cell can have come out not
correct, the reference's subdivision equals the port's array for array,
and the reference imports nothing of the program."""

from __future__ import annotations

import ast
import io
import json
import os
import shutil
import types

import numpy as np
import pytest

from bench_port import calibrate, harness
from bench_port.reference import scene, subdivided

CELLS = ["frog_large_1080p.wavefront", "frog_large_1080p.staged"]
CONFIG = "frog_large_1080p"
W, H = 64, 32
SEED = 2 ** 31 + 2424  # a seed past 32 signed bits


@pytest.fixture(scope="module")
def root(small_root, tmp_path_factory):
    """The shared test copy (two frames and 64 checked pixels a call),
    copied again with this configuration at 64x32 and one level of
    subdivision (79,432 triangles, 156 blocks) and the traffic at 3
    bounces; its diffuse bounces and jitter are kept."""
    dest = str(tmp_path_factory.mktemp("large") / "root")
    shutil.copytree(small_root, dest, symlinks=True)
    path = os.path.join(dest, "bench_port", "configs", f"{CONFIG}.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["camera"]["pixel_width"], cfg["camera"]["pixel_height"] = W, H
    cfg["subdivide_levels"] = 1
    cfg["check_box"] = list(scene.screen_box(scene.build(
        cfg, {"max_bounces": 1, "diffuse_bounce": False}, dest)))
    with open(path, "w") as f:
        json.dump(cfg, f)
    for cell in CELLS:
        path = os.path.join(dest, "bench_port", "traffic", f"{cell}.json")
        with open(path) as f:
            traffic = json.load(f)
        traffic["max_bounces"] = 3
        with open(path, "w") as f:
            json.dump(traffic, f)
    return dest


@pytest.fixture(autouse=True)
def over_budget(monkeypatch):
    """The plane budget at 64 blocks of 512 lanes: the test grid's 156
    blocks go over it, as the cells' 2,483 go over the real one."""
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk

    monkeypatch.setattr(bk, "_VMEM_TRI_BUDGET_BYTES", bk._grid_bytes(64, 512))


def _run(root, cell, seed=SEED):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run(cell, seed, 0.0, False, 0.0, device="cpu", root=root,
                     out=out, err=err)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().splitlines()[-1])


@pytest.mark.parametrize("cell, capacity", [(CELLS[0], None),
                                            (CELLS[0], 8), (CELLS[1], None)])
def test_the_reference_agrees_with_the_port(root, cell, capacity,
                                            monkeypatch):
    """At 64x32 the calibration finds no capacity, so the wavefront cell
    takes kernel D; with the calibration made to answer the frame's 8
    tiles it takes the wavefront with A and B, as at 1080p."""
    from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
    from raytracinginonesemester_tpu_torch.render import renderer

    if capacity is not None:
        monkeypatch.setattr(renderer, "_calibrate",
                            lambda *a, **k: capacity)
    renderer.reset_route_counts()
    bk.reset_launch_counts()
    result = _run(root, cell)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"frame_ms", "setup_s"}
    # over the budget: the wavefront cell on the fused kernels, the
    # reference_cpu cell on the staged integrator
    routes = renderer.route_counts()
    if cell.endswith("wavefront"):
        assert set(routes) == {"render" if capacity is None else "wavefront"}
    else:
        assert set(routes) == {"staged: gpu dialect with "
                               "jitter_mode='reference_cpu' (needs 'wang')"}


def test_the_control_is_not_correct(root):
    cell = harness.Cell(CELLS[0], root)
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
        result = _run(root, CELLS[0])
    assert not result["correct"], result["check"]


@pytest.mark.parametrize("levels", [1, 2])
def test_the_subdivision_is_the_ports_array_for_array(levels):
    """On the frog's own triangles, its normals and object ids made
    distinct: every vertex, normal and id of the port's
    ``subdivide_tris``."""
    from raytracinginonesemester_tpu_torch.scene.subdivide import (
        subdivide_tris)

    cfg = harness.load_json(os.path.join(harness.ROOT, "bench_port",
                                         "configs", f"{CONFIG}.json"))
    arrays = scene.build(cfg, {"max_bounces": 1, "diffuse_bounce": False},
                         harness.ROOT)
    t = 1000
    v = arrays.vertices[:t]
    n = np.random.default_rng(3).normal(size=v.shape).astype(np.float32)
    o = np.arange(t, dtype=np.int32) % 7
    got = subdivided.subdivide(v, n, o, levels)
    want = subdivide_tris(v, n, o, levels)
    assert got[0].shape == (4 ** levels * t, 3, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_the_reference_builds_the_subdivided_soup():
    cfg = {**harness.load_json(os.path.join(
        harness.ROOT, "bench_port", "configs", f"{CONFIG}.json")),
        "subdivide_levels": 1}
    settings = {"max_bounces": 1, "diffuse_bounce": False}
    base = scene.build(cfg, settings, harness.ROOT)
    fine = subdivided.build(cfg, settings, harness.ROOT)
    assert fine.num_triangles == 4 * base.num_triangles == 79432
    assert fine.vertices.shape[0] % scene.PAD == 0
    assert (fine.obj_id[fine.num_triangles:] == -1).all()
    np.testing.assert_array_equal(fine.vertices[0:4, 0, :],
                                  [base.vertices[0, 0],
                                   (base.vertices[0, 0] + base.vertices[0, 1])
                                   * np.float32(0.5),
                                   (base.vertices[0, 0] + base.vertices[0, 2])
                                   * np.float32(0.5),
                                   (base.vertices[0, 0] + base.vertices[0, 1])
                                   * np.float32(0.5)])


def test_the_subdivided_reference_imports_nothing_of_the_program():
    """Every top-level module that ``reference/subdivided.py`` reaches,
    its relative imports followed through ``reference/``: no JAX, no
    JAX package, no port."""
    here = os.path.join(harness.ROOT, "bench_port", "reference")
    todo, seen, top = ["subdivided"], set(), set()
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
    assert {"subdivided", "scene", "tracer"} <= seen
    forbidden = {"jax", "jaxlib", "flax", "raytracinginonesemester_tpu",
                 harness.PACKAGE}
    assert not top & forbidden, sorted(top)
    assert {"torch", "numpy"} <= top
