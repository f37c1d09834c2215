"""Parity of the PyTorch port's camera, scene building and block grid
with the JAX package, and the port's import and coverage contracts."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinginonesemester_tpu.core.camera import Camera as JCamera
from raytracinginonesemester_tpu.ops.accel import build_block_grid as j_bbg
from raytracinginonesemester_tpu.ops.accel import super_aabbs as j_super
from raytracinginonesemester_tpu_torch.core.camera import Camera as TCamera
from raytracinginonesemester_tpu_torch.ops.accel import build_block_grid as t_bbg
from raytracinginonesemester_tpu_torch.ops.accel import super_aabbs as t_super

from _torch_parity import (
    REPO, jax_two_frog, one_torch_thread, torch_from_jax, two_frog_config,
    ulp_close)


@pytest.mark.parametrize("sensor_width_mm", [None, 36.0])
def test_camera_matches(sensor_width_mm):
    kw = dict(position=(0.0, -0.2, 0.2), look_at=(0.0, 0.1, 0.0),
              up=(0.0, 0.0, 1.0), focal_length_mm=45.0,
              sensor_height_mm=24.0, sensor_width_mm=sensor_width_mm,
              width=96, height=40)
    jc, tc = JCamera.create(**kw), TCamera.create(**kw, device="cpu")
    for name in ("center", "pixel00_loc", "pixel_delta_u", "pixel_delta_v"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    assert tc.is_pinhole and jc.is_pinhole
    rs = np.random.RandomState(0)
    i = rs.uniform(0, 96, 1024).astype(np.float32)
    j = rs.uniform(0, 40, 1024).astype(np.float32)
    jo, jd = jc.get_rays(jnp.asarray(i), jnp.asarray(j))
    to, td = tc.get_rays(torch.from_numpy(i), torch.from_numpy(j))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    # a 3-term norm and a divide: XLA may contract, so 4 ulp
    assert ulp_close(td.numpy(), np.asarray(jd), ulps=4, atol=0.0).all()


def test_camera_rejects_empty_frame():
    with pytest.raises(ValueError):
        TCamera.create(width=0, device="cpu")


def _frog_geometry():
    from raytracinginonesemester_tpu.io.fast_obj import load_obj_fast
    from raytracinginonesemester_tpu.io.obj import mesh_to_triangles
    from raytracinginonesemester_tpu.scene.build import geometry_from_mesh

    mesh, _ = load_obj_fast(os.path.join(REPO, "tests/assets/meshes/frog.obj"), 0)
    verts, normals = mesh_to_triangles(mesh)
    return geometry_from_mesh(verts, normals, mesh.triangle_obj_ids)


def test_block_grid_matches_on_frog():
    """Frog at block size 128: the Morton order, the triangle planes, ids,
    object ids, block AABBs and vertex-normal planes are exactly equal;
    the geometric normals agree to the tolerance stated below."""
    g = _frog_geometry()
    jg = j_bbg(g.vertices, jnp.asarray(g.num_triangles), normals=g.normals,
               obj_ids=g.obj_id, block_size=128)
    tg = t_bbg(torch.from_numpy(np.asarray(g.vertices)), g.num_triangles,
               normals=torch.from_numpy(np.asarray(g.normals)),
               obj_ids=torch.from_numpy(np.asarray(g.obj_id)), block_size=128)
    assert tg.num_blocks == jg.num_blocks == g.padded_triangles // 128
    np.testing.assert_array_equal(tg.tri_index.numpy(), np.asarray(jg.tri_index))
    np.testing.assert_array_equal(tg.obj.numpy(), np.asarray(jg.obj))
    np.testing.assert_array_equal(tg.tri.numpy(), np.asarray(jg.tri))
    np.testing.assert_array_equal(tg.aabb.numpy(), np.asarray(jg.aabb))
    np.testing.assert_array_equal(t_super(tg).numpy(), np.asarray(j_super(jg)))
    np.testing.assert_array_equal(tg.norm[:9].numpy(), np.asarray(jg.norm[:9]))
    # geometric normals of real triangles: a cross product of edges,
    # which XLA:CPU evaluates with FMA contraction, so 4 ulp or 1e-6 on
    # these unit components.  Padding triangles have zero edges, where
    # XLA:CPU flushes the 1e-38 length clamp (a denormal) to zero and
    # gets 0/0 = NaN while the port keeps the clamp and gets 0 (never
    # read: padding never hits)
    valid = tg.tri_index.numpy() >= 0
    assert ulp_close(tg.norm[9:].numpy()[:, valid],
                     np.asarray(jg.norm[9:])[:, valid], ulps=4, atol=1e-6).all()
    assert (tg.norm[9:].numpy()[:, ~valid] == 0.0).all()


def test_build_scene_matches(monkeypatch):
    """The port's own scene build of the two-frog scene: same geometry,
    materials, lights and camera as the JAX build."""
    monkeypatch.setenv("RT_BLOCK_SIZE", "128")
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (SceneConfig,
                                                                SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    js = jax_two_frog()
    ts = build_scene(two_frog_config(SceneConfig, SceneNodeConfig, Transform),
                     device="cpu")
    np.testing.assert_array_equal(ts.geometry.vertices.numpy(),
                                  np.asarray(js.geometry.vertices))
    np.testing.assert_array_equal(ts.geometry.obj_id.numpy(),
                                  np.asarray(js.geometry.obj_id))
    np.testing.assert_array_equal(ts.materials.albedo.numpy(),
                                  np.asarray(js.materials.albedo))
    np.testing.assert_array_equal(ts.lights.intensity.numpy(),
                                  np.asarray(js.lights.intensity))
    np.testing.assert_array_equal(ts.accel.tri.numpy(), np.asarray(js.accel.tri))
    assert ts.accel.block_size == 128
    assert (ts.terminal_only, ts.max_bounces, ts.dialect) == \
        (js.terminal_only, js.max_bounces, js.dialect)


def test_scene_from_numpy_round_trip():
    js = jax_two_frog()
    ts = torch_from_jax(js)
    np.testing.assert_array_equal(ts.accel.norm.numpy(), np.asarray(js.accel.norm))
    np.testing.assert_array_equal(ts.camera.pixel00_loc.numpy(),
                                  np.asarray(js.camera.pixel00_loc))
    assert ts.accel.num_blocks == js.accel.num_blocks
    assert ts.lights.shadow_samples == js.lights.shadow_samples
    m = ts.materials.gather(torch.tensor([1, 0, 5]))
    np.testing.assert_array_equal(m.kd.numpy(),
                                  np.asarray(js.materials.kd)[[1, 0, 1]])


def test_package_imports_without_jax():
    code = ("import sys, raytracinginonesemester_tpu_torch as p; "
            "import raytracinginonesemester_tpu_torch.render.renderer, "
            "raytracinginonesemester_tpu_torch.ops.wavefront, "
            "raytracinginonesemester_tpu_torch.ops.binned, "
            "raytracinginonesemester_tpu_torch.ops.integrator, "
            "raytracinginonesemester_tpu_torch.ops._native; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('raytracinginonesemester_tpu.')"
            " or m == 'raytracinginonesemester_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_unsupported_scenes_raise():
    """Differentiable scenes raise NotImplementedError (that path is not
    ported); the scenes the fused kernels refuse, for the JAX package's
    reasons, now take the staged integrator without calibrating a
    wavefront, and render."""
    import dataclasses

    from raytracinginonesemester_tpu_torch.ops.megakernel import (
        megakernel_ineligible_reason as reason)
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene, resolve_wavefront)
    from raytracinginonesemester_tpu_torch.scene.build import load_scene

    cpu = load_scene(os.path.join(REPO, "tests/assets/scenes/cpuonly_point.json"),
                     device="cpu")
    many = dataclasses.replace(cpu, lights=dataclasses.replace(
        cpu.lights, shadow_samples=(17,)))
    ts = torch_from_jax(jax_two_frog(width=32, height=16))
    grid_less = dataclasses.replace(ts, accel=None)
    for scene, jitter, why in ((cpu, "reference_cpu", "jitter"),
                               (many, "center", "shadow_samples=17"),
                               (ts, "center", "jitter"),
                               (grid_less, "wang", "accel")):
        assert why in reason(scene, jitter)
        assert resolve_wavefront(scene, jitter, 1) == (False, None)
    img = render_scene(ts, jitter_mode="center")
    assert torch.isfinite(img).all() and float(img.std()) > 0.0
    with pytest.raises(NotImplementedError, match="differentiable"):
        render_scene(dataclasses.replace(ts, differentiable=True))
