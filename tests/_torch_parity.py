"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

``scene_to_numpy`` hands a JAX ``Scene`` to the port as numpy
(``raytracinginonesemester_tpu_torch.scene.build.scene_from_numpy``), so
both packages render the very same block-grid planes.  The scene
builders make the two-frog test scene of ``tests/test_megakernel.py``
for either package.  ``one_torch_thread`` keeps the port's tests to one
PyTorch thread.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One PyTorch CPU thread for each test module that imports this
    fixture (autouse: importing it is enough).  The test workers share
    the machine's cores: with PyTorch's default of one thread per core
    in every worker, the port's test files took 920 s under six workers
    on an 8-core machine, against 140 s with one thread each, while one
    process alone runs as fast with one thread as with eight.  The
    count is restored after the module."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scene_to_numpy(scene):
    """JAX Scene -> (arrays, statics) for ``scene_from_numpy``."""
    arrays = {
        "camera.center": scene.camera.center,
        "camera.pixel00_loc": scene.camera.pixel00_loc,
        "camera.pixel_delta_u": scene.camera.pixel_delta_u,
        "camera.pixel_delta_v": scene.camera.pixel_delta_v,
        "lights.position": scene.lights.position,
        "lights.color": scene.lights.color,
        "lights.intensity": scene.lights.intensity,
        "lights.radius": scene.lights.radius,
        "miss_color": scene.miss_color,
        "geometry.vertices": scene.geometry.vertices,
        "geometry.normals": scene.geometry.normals,
        "geometry.obj_id": scene.geometry.obj_id,
    }
    for f in dataclasses.fields(scene.materials):
        arrays[f"materials.{f.name}"] = getattr(scene.materials, f.name)
    statics = dict(
        width=scene.camera.width, height=scene.camera.height,
        max_bounces=scene.max_bounces, spp=scene.spp,
        diffuse_bounce=scene.diffuse_bounce,
        background_kind=scene.background_kind, dialect=scene.dialect,
        terminal_only=scene.terminal_only,
        differentiable=scene.differentiable,
        num_triangles=scene.geometry.num_triangles,
        shadow_samples=scene.lights.shadow_samples)
    if scene.accel is not None:
        for name in ("tri", "norm", "tri_index", "obj", "aabb"):
            arrays[f"accel.{name}"] = getattr(scene.accel, name)
        statics["block_size"] = scene.accel.block_size
    return {k: np.asarray(v) for k, v in arrays.items()}, statics


def two_frog_config(config_cls, node_cls, transform_cls, width=64, height=32,
                    spp=1, max_bounces=3, diffuse_bounce=True, dialect="gpu"):
    """The two-frog scene of ``tests/test_megakernel.py`` (frog + a
    small sphere, two point lights), built from either package's
    config classes."""
    return config_cls(
        max_bounces=max_bounces, spp=spp, diffuse_bounce=diffuse_bounce,
        camera_position=(0.0, -0.2, 0.2), camera_look_at=(0.0, 0.1, 0.0),
        camera_up=(0.0, 0.0, 1.0), focal_length_mm=45.0,
        sensor_height_mm=24.0, sensor_width_mm=None,
        pixel_width=width, pixel_height=height,
        background=("miss", (0.25, 0.45, 0.9)),
        lights=[
            dict(position=(-3.0, 0.0, 1.0), color=(1.0, 1.0, 0.0),
                 intensity=5.0, radius=0.0, shadow_samples=1),
            dict(position=(2.0, -1.0, 2.0), color=(0.2, 0.6, 1.0),
                 intensity=2.0, radius=0.0, shadow_samples=1),
        ],
        nodes=[
            node_cls(name="frog", type="mesh",
                     path=os.path.join(REPO, "tests/assets/meshes/frog.obj"),
                     transform=transform_cls(),
                     material=dict(albedo=(0.8, 0.2, 0.2), kd=1.0, ks=0.5,
                                   specular_color=(0.04, 0.04, 0.04),
                                   shininess=32.0, kr=0.0)),
            node_cls(name="ball", type="mesh",
                     path=os.path.join(REPO, "tests/assets/meshes/sphere.obj"),
                     transform=transform_cls(position=(0.05, 0.05, 0.02),
                                             scale=(0.04, 0.04, 0.04)),
                     material=dict(albedo=(0.2, 0.7, 0.3), kd=0.8, ks=0.2,
                                   specular_color=(0.5, 0.5, 0.5),
                                   shininess=8.0, kr=0.0)),
        ],
        dialect=dialect)


def jax_two_frog(**kw):
    """The two-frog scene built by the JAX package (block size from
    ``RT_BLOCK_SIZE``, 128 under the test conftest)."""
    from raytracinginonesemester_tpu.scene.build import build_scene
    from raytracinginonesemester_tpu.scene.config import (SceneConfig,
                                                          SceneNodeConfig)
    from raytracinginonesemester_tpu.scene.transform import Transform

    return build_scene(two_frog_config(SceneConfig, SceneNodeConfig,
                                       Transform, **kw))


def torch_from_jax(jscene, device="cpu"):
    """The port's Scene on exactly the JAX scene's arrays and planes."""
    from raytracinginonesemester_tpu_torch.scene.build import scene_from_numpy

    arrays, statics = scene_to_numpy(jscene)
    return scene_from_numpy(arrays, statics, device=device)


def ulp_close(a, b, ulps=4, atol=1e-5):
    """Elementwise |a - b| <= max(atol, ulps * ulp(max(|a|, |b|)))."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    mag = np.maximum(np.abs(a), np.abs(b))
    tol = np.maximum(np.float32(atol), ulps * np.spacing(mag))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) <= tol
