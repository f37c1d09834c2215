"""Shared helpers of the parity tests between the JAX package and its
PyTorch port (``tests/test_torch_*.py``).

``scene_to_numpy`` hands a JAX ``Scene`` to the port as numpy
(``raytracinginonesemester_tpu_torch.scene.build.scene_from_numpy``), so
both packages render the very same block-grid planes.  The scene
builders make the two-frog test scene of ``tests/test_megakernel.py``
for either package, and ``grad_scene`` the JAX grad-bench scene.  ``one_torch_thread`` keeps the port's tests to one
PyTorch thread.  ``assert_images_close`` compares two quantized images,
``staged_image`` renders a scene on the staged integrator whatever its
route, ``regridded`` subdivides a scene's mesh, ``warp_chunk_counts``
counts the chunks the kernels' depth-0 binned walk skips; none imports
JAX, so the card's test files use them too.
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


def assert_images_close(ours: np.ndarray, golden: np.ndarray, max_bad_frac=2e-3,
                        max_mean=0.5, context=""):
    """Quantized-image comparison tolerant of last-ulp float divergence.

    Compares uint8 images: at most ``max_bad_frac`` of channel samples may
    differ by more than 1 step, and the mean absolute difference must stay
    under ``max_mean`` steps.
    """
    assert ours.shape == golden.shape, f"{context}: shape {ours.shape} vs {golden.shape}"
    diff = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    bad_frac = float((diff > 1).mean())
    mean = float(diff.mean())
    assert bad_frac <= max_bad_frac and mean <= max_mean, (
        f"{context}: bad_frac={bad_frac:.5f} (limit {max_bad_frac}), "
        f"mean={mean:.4f} (limit {max_mean}), max={diff.max()}"
    )


def staged_image(scene, jitter_mode, sample_offset=0):
    """The port's staged integrator's spp-1 image of ``scene`` (G and I
    over the plane budget), called on its route directly: the fused
    kernels take a grid over the budget, so the renderer's own dispatch
    does not come here for the wang or auto jitter."""
    from raytracinginonesemester_tpu_torch.render import renderer as tr

    w, h = scene.camera.width, scene.camera.height
    xs, ys, n, (hp, wp) = tr.pixel_stream(w, h, scene.device)
    route = tr.Route("staged: called directly",
                     tr.resolve_jitter_mode(scene, jitter_mode, 1))
    accum = tr.render_stream(scene, route, xs[:n], ys[:n], 1, sample_offset)
    return tr.unswizzle(accum, w, h, hp, wp)


def regridded(scene, levels):
    """``scene`` with its mesh subdivided ``levels`` times and the block
    grid rebuilt at 512 lanes, as ``chip_smoke.py`` ``large_scene`` and
    the benchmark's ``render_subdivided`` entry build the large frog."""
    from raytracinginonesemester_tpu_torch.ops.accel import build_block_grid
    from raytracinginonesemester_tpu_torch.scene.subdivide import (
        subdivide_geometry)

    geom = (subdivide_geometry(scene.geometry, levels) if levels
            else scene.geometry)
    grid = build_block_grid(geom.vertices, geom.num_triangles,
                            block_size=512, normals=geom.normals,
                            obj_ids=geom.obj_id)
    return dataclasses.replace(scene, geometry=geom, accel=grid)


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


def poisoned_padding(scene, pad=3):
    """``scene`` (the port's) with its block grid padded by
    ``shard_scene_blocks`` with ``pad`` empty blocks (AABB +inf/-inf, as a
    grid split over a model axis gets them) whose first 12 lanes hold a
    box of triangles around the scene, ids 10**6 on: a ray whose slab
    test let such a block through would hit the box (or, outside it,
    could).  Used by ``test_torch_parallel.py`` and ``chip_smoke.py``."""
    import torch

    from raytracinginonesemester_tpu_torch.parallel.sharded import (
        shard_scene_blocks)

    grid = scene.accel
    n0 = grid.num_blocks
    padded = shard_scene_blocks(scene, n0 + pad)
    g = padded.accel
    lo = grid.aabb[:3].amin(dim=1) - 1.0
    hi = grid.aabb[3:].amax(dim=1) + 1.0
    c = [torch.where(torch.tensor([(k >> a) & 1 for a in range(3)],
                                  device=lo.device) > 0, hi, lo)
         for k in range(8)]
    faces = [(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5), (0, 5, 1),
             (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4), (1, 5, 7), (1, 7, 3)]
    g.tri[:, n0:, :12] = torch.stack(
        [torch.cat([c[a], c[b] - c[a], c[e] - c[a]]) for a, b, e in faces],
        dim=1)[:, None, :]
    g.tri_index[n0:, :12] = (torch.arange(12, device=lo.device)
                             + 10 ** 6).to(g.tri_index.dtype)
    g.obj[n0:, :12] = 0
    return padded


def warp_chunk_counts(cand_plan, o, d, alive, det_eps, tmin, warp_rays=8):
    """The warp-chunks (``warp_rays`` rays of a tile and one chunk of its
    binned plan) that ``closest_binned_cta`` of ``csrc/megakernel.cu``
    (emit's and render's depth-0 walk, 8 rays a warp) schedules and tests,
    for the arguments of the port's ``megakernel._closest_binned_plain``
    -> a (2,) int64 tensor (scheduled, tested).  Each warp of a tile with
    a live ray is scheduled each of the tile's chunks, and tests one
    unless every ray of the warp has a least t over the tile's earlier
    chunks (F32_MAX: none, and a dead ray's) below the chunk's near bound
    (row 12 of its lane 0, ``binned.order_front_to_back``)."""
    import torch

    from raytracinginonesemester_tpu_torch.ops import binned
    from raytracinginonesemester_tpu_torch.ops import megakernel as tmk

    c, n = cand_plan.chunk, tmk.RAY_TILE
    stream = cand_plan.stream.reshape(-1, binned.CAND_ROWS, c).cpu()
    o, d = tuple(x.cpu() for x in o), tuple(x.cpu() for x in d)
    alive = alive.cpu()
    tmin = tmin.cpu() if torch.is_tensor(tmin) else tmin
    counts = torch.zeros(2, dtype=torch.int64)
    for ti, (start, cnt) in enumerate(cand_plan.meta[:, :2].tolist()):
        sub = ti * n + alive[ti * n:(ti + 1) * n].nonzero().squeeze(1)
        if cnt == 0 or sub.numel() == 0:
            continue
        rows = stream[start:start + cnt]  # (cnt, 16, c)
        tri = tuple(rows[:, k].reshape(1, cnt * c) for k in range(9))
        live = (rows[:, 9] >= 0).reshape(1, cnt * c)
        least = torch.full((n, cnt), tmk.F32_MAX)
        for ch in tmk._chunks(sub, cnt * c):
            tm = tmin[ch, None] if torch.is_tensor(tmin) else tmin
            t, _, _ = tmk._mt(tuple(x[ch, None] for x in o),
                              tuple(x[ch, None] for x in d), tri, det_eps,
                              tm, tmk.F32_MAX)
            t = torch.where(live, t, tmk.F32_MAX)
            least[ch - ti * n] = t.reshape(-1, cnt, c).amin(dim=2)
        before = torch.cat((torch.full((n, 1), tmk.F32_MAX),
                            least.cummin(dim=1).values[:, :-1]), dim=1)
        behind = (before < rows[:, binned.NEAR_ROW, 0]).reshape(
            -1, warp_rays, cnt).all(dim=1)
        counts += torch.tensor([behind.numel(), int((~behind).sum())])
    return counts


def counting_binned_walk(walk, into):
    """``walk`` (with the signature of ``megakernel._closest_binned_plain``)
    that also adds each call's ``warp_chunk_counts`` to the (2,) tensor
    ``into``."""
    def counted(*args):
        into.add_(warp_chunk_counts(*args))
        return walk(*args)
    return counted
