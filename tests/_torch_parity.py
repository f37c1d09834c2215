"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

``scene_to_numpy`` hands a JAX ``Scene`` to the port as numpy
(``raytracinginonesemester_tpu_torch.scene.build.scene_from_numpy``), so
both packages render the very same block-grid planes.  The scene
builders make the two-frog test scene of ``tests/test_megakernel.py``
for either package, and ``grad_scene`` the JAX grad-bench scene.  ``one_torch_thread`` keeps the port's tests to one
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


def grad_scene(width=48, height=32, bounces=2, scene="gpu_spheres"):
    """The JAX package's differentiable grad-bench scene (``bench.py
    --grad``: ``gpu_spheres.json``, its camera, a block grid,
    ``differentiable=True``) at a test size, with its Pallas kernels in
    interpret mode."""
    import raytracinginonesemester_tpu as jrt
    from raytracinginonesemester_tpu.core.camera import Camera

    js = jrt.load_scene(os.path.join(REPO, f"tests/assets/scenes/{scene}.json"),
                        accel="blocks")
    cam = Camera.create(position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5),
                        up=(0, 0, 1), focal_length_mm=24.0, width=width,
                        height=height)
    return dataclasses.replace(js, camera=cam, differentiable=True,
                               max_bounces=bounces, spp=1, use_pallas=True)


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


def list_occluded(rows, p, ld, dist, facing, det_eps, shadow_tmin,
                  tmax=None):
    """The shadow-list walk of ``csrc/megakernel.cu`` (emit's shadow rays,
    kernel F), emulated with the signature of the port's
    ``megakernel._occluded_plain`` -> (blocked, tests made).

    Every ``facing`` ray whose slab test on [tmin, dist] passes for some
    block is listed (the kernels list them in whatever order their CTAs
    reach the list's counter; here in ray order), the others come out
    unblocked; warps take the list kListRays entries at a time and walk
    each entry as ``occluded_coop`` does (blocks gated in order
    on [tmin, dist], a passing block's triangles tested on [tmin, tmax]
    128 between votes, the walk over at the first block holding a
    blocker), and write its flag."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import megakernel as tmk

    tmax = dist if tmax is None else tmax
    r, n_blocks, bs = dist.shape[0], rows.num_blocks, rows.block_size
    tmin = (shadow_tmin if torch.is_tensor(shadow_tmin)
            else torch.full_like(dist, shadow_tmin))
    inv = tuple(1.0 / c for c in ld)
    slabs = tmk._slab(rows.aabb.T[:, None, :], tuple(c[:, None] for c in p),
                      tuple(c[:, None] for c in inv), tmin[:, None],
                      dist[:, None]) & facing[:, None]  # (R, L)
    listed = slabs.any(dim=1).nonzero().squeeze(1)
    # each entry's walk is its own: the warps' groups of 8
    # entries decide which warp walks it, not its flag, so the entries
    # are walked here all at once
    blocked = torch.zeros(listed.numel(), dtype=torch.bool)
    tests = 0
    for b in range(n_blocks):
        walk = (slabs[listed, b] & ~blocked).nonzero().squeeze(1)
        if walk.numel() == 0:
            continue
        e = listed[walk]
        t, _, _ = tmk._mt(tuple(x[e, None] for x in p),
                          tuple(x[e, None] for x in ld),
                          tuple(rows.tri[k, b][None, :] for k in range(9)),
                          det_eps, tmin[e, None], tmax[e, None])
        hit = (rows.ids[b] >= 0)[None, :] & (t < tmk.F32_MAX)
        done = torch.zeros(e.numel(), dtype=torch.bool)
        for j0 in range(0, bs, 128):  # a vote every 128 slots
            tests += int((~done).sum()) * min(128, bs - j0)
            done = done | hit[:, j0:j0 + 128].any(dim=1)
        blocked[walk] = done
    flags = torch.zeros(r, dtype=torch.bool)
    flags[listed] = blocked
    return flags, torch.tensor(tests)
