"""Parity of the port's front ends with the JAX package: the HW1
pipeline, progressive rendering, the command line and ``viz``.

``render_hw1`` against the JAX package's (within 4 ulp or 1e-5) and
against the C++ oracle's ``tests/goldens/hw1_sphere.png``
(``assert_images_close``); the HW1 frog golden is held on the card only
(``chip_smoke.py``: a CPU brute force of 1.1e9 tests is too slow here).
The progressive tests of ``tests/test_progressive.py`` on the port, and
the CLI with ``--device cpu``.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinginonesemester_tpu_torch.render.progressive import (
    load_render_state, render_progressive, save_render_state)
from raytracinginonesemester_tpu_torch.render.renderer import render_scene

from _torch_parity import REPO, one_torch_thread, ulp_close
from conftest import assert_images_close

HW1_CAMERA = dict(position=(0.0, -1.0, 1.0), look_at=(0.0, 0.15, 0.0),
                  up=(0.0, 0.0, 1.0), focal_length_mm=255.0,
                  sensor_height_mm=24.0)
SPHERE = os.path.join(REPO, "tests/assets/meshes/sphere.obj")


def _sphere_geometry():
    from raytracinginonesemester_tpu.io.obj import load_obj, mesh_to_triangles
    from raytracinginonesemester_tpu.scene.build import geometry_from_mesh

    mesh, _ = load_obj(SPHERE)
    return geometry_from_mesh(*mesh_to_triangles(mesh))


def _t_hw1(g, width, height, **kw):
    from raytracinginonesemester_tpu_torch.core.camera import Camera
    from raytracinginonesemester_tpu_torch.render.renderer import render_hw1

    return render_hw1(torch.from_numpy(np.array(g.vertices)),
                      torch.from_numpy(np.array(g.normals)),
                      Camera.create(**HW1_CAMERA, width=width, height=height,
                                    device="cpu"),
                      [-3.0, 0.0, 1.0], [1.0, 0.0, 1.0], width, height,
                      **kw).numpy()


def test_render_hw1_matches_jax():
    from raytracinginonesemester_tpu.core.camera import Camera
    from raytracinginonesemester_tpu.render.renderer import render_hw1

    g = _sphere_geometry()
    want = np.asarray(render_hw1(
        g.vertices, g.normals, Camera.create(**HW1_CAMERA, width=96,
                                             height=54),
        jnp.asarray([-3.0, 0.0, 1.0]), jnp.asarray([1.0, 0.0, 1.0]), 96, 54,
        spp=2))
    got = _t_hw1(g, 96, 54, spp=2)
    assert ulp_close(got, want).all()
    assert np.ptp(want) > 0.05


def test_render_hw1_sphere_golden():
    """320x180 against the C++ HW1 renderer (``HW1/src/render.cpp``);
    ray tiles of 1024 keep the brute force's chunks in cache (the image
    does not depend on the tiling)."""
    from raytracinginonesemester_tpu_torch.io.image import quantize, read_png

    ours = quantize(_t_hw1(_sphere_geometry(), 320, 180, ray_tile=1024),
                    "hw1")
    golden = read_png(os.path.join(REPO, "tests/goldens/hw1_sphere.png"))
    assert_images_close(ours, golden, context="hw1 sphere")


@pytest.fixture(scope="module")
def diffuse_scene():
    """``gpu_diffuse.json`` (962 triangles, depth 3, diffuse bounces) at
    48x32 and spp 4 on the port: ``tests/test_progressive.py``'s tests
    on a scene a fifth as costly to render here as its two-frog scene."""
    import dataclasses

    from raytracinginonesemester_tpu_torch.core.camera import Camera
    from raytracinginonesemester_tpu_torch.scene.build import load_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        load_scene_config)

    path = os.path.join(REPO, "tests/assets/scenes/gpu_diffuse.json")
    c = load_scene_config(path)
    cam = Camera.create(position=c.camera_position,
                        look_at=c.camera_look_at, up=c.camera_up,
                        focal_length_mm=c.focal_length_mm,
                        sensor_height_mm=c.sensor_height_mm,
                        sensor_width_mm=c.sensor_width_mm, width=48,
                        height=32, device="cpu")
    return dataclasses.replace(load_scene(path, device="cpu"), camera=cam,
                               spp=4)


@pytest.fixture(scope="module")
def one_shot(diffuse_scene):
    return render_scene(diffuse_scene).numpy()


def test_progressive_chunk1_bit_identical(diffuse_scene, one_shot):
    np.testing.assert_array_equal(
        one_shot, render_progressive(diffuse_scene, chunk=1))


def test_progressive_chunk2_close(diffuse_scene, one_shot):
    np.testing.assert_allclose(
        one_shot, render_progressive(diffuse_scene, chunk=2), rtol=0.0,
        atol=2e-6)


def test_progressive_resume(diffuse_scene, one_shot, tmp_path):
    state = str(tmp_path / "state")
    calls = []

    class Stop(Exception):
        pass

    def interrupt(done, _preview):
        calls.append(done)
        if done == 2:
            raise Stop

    with pytest.raises(Stop):
        render_progressive(diffuse_scene, chunk=1, state_dir=state, on_chunk=interrupt)
    _, nxt = load_render_state(state)
    assert nxt == 2 and calls == [1, 2]
    resumed = render_progressive(diffuse_scene, chunk=1, state_dir=state)
    np.testing.assert_array_equal(one_shot, resumed)
    # a finished state just returns the image
    np.testing.assert_array_equal(
        resumed, render_progressive(diffuse_scene, chunk=1, state_dir=state))


def test_render_state_roundtrip(tmp_path):
    acc = np.arange(24, dtype=np.float32).reshape(2, 4, 3)
    save_render_state(str(tmp_path), acc, 7)
    loaded, nxt = load_render_state(str(tmp_path))
    assert nxt == 7
    np.testing.assert_array_equal(acc, loaded)
    assert load_render_state(str(tmp_path / "nope")) is None


def _cli(argv):
    from raytracinginonesemester_tpu_torch.render.cli import main

    return main(argv + ["--device", "cpu"])


def test_cli_scene_matches_jax(tmp_path):
    """A gpu scene at 64x36 through both CLIs: the PNGs pass
    ``assert_images_close``."""
    from raytracinginonesemester_tpu.render.cli import main as j_main
    from raytracinginonesemester_tpu_torch.io.image import read_png

    scene = os.path.join(REPO, "tests/assets/scenes/gpu_diffuse.json")
    args = [scene, "--spp", "1", "--width", "64", "--height", "36"]
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert _cli(args + ["-o", ours]) == 0
    assert j_main(args + ["-o", theirs]) == 0
    a, b = read_png(ours), read_png(theirs)
    assert a.shape == (36, 64, 3)
    assert_images_close(a, b, context="cli gpu_diffuse")


def test_cli_obj_matches_jax(tmp_path):
    """OBJ mode (the HW1 pipeline) on a plane mesh at 32x18."""
    from raytracinginonesemester_tpu.render.cli import main as j_main
    from raytracinginonesemester_tpu_torch.io.image import read_png

    mesh = os.path.join(REPO, "tests/assets/meshes/plane_5x5.obj")
    args = [mesh, "--width", "32", "--height", "18"]
    ours, theirs = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert _cli(args + ["-o", ours]) == 0
    assert j_main(args + ["-o", theirs]) == 0
    assert_images_close(read_png(ours), read_png(theirs), context="cli obj")


def test_cli_progressive_and_export(tmp_path):
    """``--progressive 1`` writes the one-shot PNG byte for byte and a
    resumable state; ``--export-bvh`` writes one box per grid block."""
    from raytracinginonesemester_tpu_torch.scene.build import load_scene
    from raytracinginonesemester_tpu_torch.viz.view_bvh import (
        load_wireframe_obj)

    scene = os.path.join(REPO, "tests/assets/scenes/gpu_diffuse.json")
    size = ["--spp", "2", "--width", "48", "--height", "32"]
    one, prog = str(tmp_path / "one.png"), str(tmp_path / "prog.png")
    state, boxes = str(tmp_path / "state"), str(tmp_path / "bvh.obj")
    assert _cli([scene, "-o", one, "--export-bvh", boxes] + size) == 0
    assert _cli([scene, "-o", prog, "--progressive", "1", "--state-dir",
                 state] + size) == 0
    with open(one, "rb") as a, open(prog, "rb") as b:
        assert a.read() == b.read()
    assert os.path.exists(os.path.join(state, "render_state.npz"))
    verts, lines = load_wireframe_obj(boxes)
    blocks = load_scene(scene, device="cpu").accel.num_blocks
    assert verts.shape == (8 * blocks, 3) and lines.shape == (12 * blocks, 2)


def test_cli_needs_a_card_unless_told(monkeypatch):
    """Without a card the CLI refuses to render unless ``--device cpu``."""
    from raytracinginonesemester_tpu_torch.render.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = os.path.join(REPO, "tests/assets/scenes/gpu_diffuse.json")
    with pytest.raises(SystemExit):
        main([scene])


def test_cli_stage_preview_and_viewer(tmp_path):
    from raytracinginonesemester_tpu_torch.viz.bvh_export import (
        export_aabbs_to_obj)
    from raytracinginonesemester_tpu_torch.viz.view_bvh import view

    scene = os.path.join(REPO, "tests/assets/scenes/gpu_spheres.json")
    out = str(tmp_path / "stage.png")
    assert _cli([scene, "--stage-preview", "-o", out]) == 0
    assert os.path.getsize(out) > 10000
    boxes = str(tmp_path / "b.obj")
    export_aabbs_to_obj(boxes, np.zeros((2, 3)), np.ones((2, 3)))
    png = str(tmp_path / "view.png")
    view(boxes, headless=True, out_png=png)
    assert os.path.getsize(png) > 1000


def test_show_headless_fallback(tmp_path):
    """``viz.show`` falls back to the stage-preview PNG without a
    window."""
    from raytracinginonesemester_tpu_torch.scene.config import (
        load_scene_config)
    from raytracinginonesemester_tpu_torch.viz.show import show

    scene_path = os.path.join(REPO, "tests/assets/scenes/gpu_spheres.json")
    out = str(tmp_path / "stage_show.png")
    res = show(load_scene_config(scene_path), scene_path=scene_path,
               out_png=out, headless=True)
    assert res == out and os.path.getsize(out) > 10000
