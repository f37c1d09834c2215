"""Parity of the port's LBVH, its stack walk, the treelet block layout and
the AABB wireframe export with the JAX package.

The tree is held exactly (topology, object ids and refit boxes: min and
max are exact); ``bvh_closest``'s winners exactly against the JAX walk
(t, u and v within 4 ulp or 1e-5: XLA:CPU contracts the Moller-Trumbore
products into FMAs) and against the brute-force intersector as
``tests/test_lbvh.py`` holds the JAX walk.  Treelet frames must equal
runs frames bit for bit, as in the JAX package.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinginonesemester_tpu.ops.accel import (
    build_block_grid_treelet as j_treelet)
from raytracinginonesemester_tpu.ops.lbvh import build_lbvh as j_build
from raytracinginonesemester_tpu.ops.traversal import bvh_closest as j_closest
from raytracinginonesemester_tpu.viz import bvh_export as j_export
from raytracinginonesemester_tpu_torch.ops import traversal
from raytracinginonesemester_tpu_torch.ops.accel import (
    build_block_grid, build_block_grid_treelet as t_treelet)
from raytracinginonesemester_tpu_torch.ops.intersect import intersect_closest
from raytracinginonesemester_tpu_torch.ops.lbvh import INVALID, build_lbvh
from raytracinginonesemester_tpu_torch.viz import bvh_export as t_export

from _torch_parity import (REPO, jax_two_frog, one_torch_thread,
                           torch_from_jax, ulp_close)

TREE_FIELDS = ("parent", "left", "right", "object_idx", "aabb_min",
               "aabb_max")


def random_tris(n, seed=0, spread=4.0):
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-spread, spread, size=(n, 1, 3))
    return (centers + rs.uniform(-0.4, 0.4, size=(n, 3, 3))).astype(np.float32)


def random_rays(n, seed=1, spread=6.0):
    rs = np.random.RandomState(seed)
    o = rs.uniform(-spread, spread, size=(n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def frog_geometry():
    """The frog as the JAX package pads it (to a multiple of 512)."""
    from raytracinginonesemester_tpu.io.fast_obj import load_obj_fast
    from raytracinginonesemester_tpu.io.obj import mesh_to_triangles
    from raytracinginonesemester_tpu.scene.build import geometry_from_mesh

    mesh, _ = load_obj_fast(os.path.join(REPO, "tests/assets/meshes/frog.obj"),
                            0)
    verts, normals = mesh_to_triangles(mesh)
    return geometry_from_mesh(verts, normals, mesh.triangle_obj_ids)


def assert_same_tree(tbvh, jbvh):
    for name in TREE_FIELDS:
        want = np.asarray(getattr(jbvh, name))
        got = getattr(tbvh, name).numpy()
        np.testing.assert_array_equal(got, want.astype(got.dtype),
                                      err_msg=name)
    assert tbvh.num_leaves == jbvh.num_leaves


@pytest.mark.parametrize("n", [2, 3, 17, 256, 1000])
def test_build_lbvh_matches_jax(n):
    tris = random_tris(n, seed=n)
    tbvh = build_lbvh(torch.from_numpy(tris))
    assert_same_tree(tbvh, j_build(jnp.asarray(tris)))
    obj = tbvh.object_idx.numpy()
    assert sorted(obj[n - 1:].tolist()) == list(range(n))
    assert (obj[:n - 1] == INVALID).all()


def test_build_lbvh_matches_jax_on_frog():
    """The padded frog (the padding triangles are built over, as the JAX
    package builds them): the same tree, and every child's box inside its
    parent's."""
    g = frog_geometry()
    tbvh = build_lbvh(torch.from_numpy(np.array(g.vertices)))
    assert_same_tree(tbvh, j_build(g.vertices))
    p = tbvh.num_leaves
    left, right = tbvh.left[:p - 1], tbvh.right[:p - 1]
    for c in (left, right):
        assert (tbvh.aabb_min[c] >= tbvh.aabb_min[:p - 1]).all()
        assert (tbvh.aabb_max[c] <= tbvh.aabb_max[:p - 1]).all()


def _walk_both(tris, o, d):
    jh = j_closest(jnp.asarray(o), jnp.asarray(d), j_build(jnp.asarray(tris)),
                   jnp.asarray(tris), tmin=1e-4)
    stats = {}
    th = traversal.bvh_closest(torch.from_numpy(o), torch.from_numpy(d),
                               build_lbvh(torch.from_numpy(tris)),
                               torch.from_numpy(tris), tmin=1e-4, stats=stats)
    return jh, th, stats


@pytest.mark.parametrize("n", [512, 1024])
def test_bvh_closest_matches_jax(n):
    tris = random_tris(n, seed=3)
    o, d = random_rays(512, seed=4)
    jh, th, stats = _walk_both(tris, o, d)
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(jh.hit))
    np.testing.assert_array_equal(th.tri_idx.numpy(), np.asarray(jh.tri_idx))
    hit = th.hit.numpy()
    assert hit.sum() > 20
    for name in ("t", "u", "v"):
        assert ulp_close(getattr(th, name).numpy()[hit],
                         np.asarray(getattr(jh, name))[hit]).all(), name
    assert stats["rounds"] > 0 and stats["overflowed"] == 0


def test_bvh_closest_matches_bruteforce():
    """As ``tests/test_lbvh.py`` holds the JAX walk: hit flags exact, t
    within 1e-6 relative, ids equal except where an exact tie could pick
    another triangle (the walk keeps the last leaf of equal t, the brute
    force the lowest id)."""
    tris = torch.from_numpy(random_tris(512, seed=3))
    o, d = (torch.from_numpy(a) for a in random_rays(256, seed=4))
    hb = traversal.bvh_closest(o, d, build_lbvh(tris), tris, tmin=1e-4)
    hr = intersect_closest(o, d, tris, tmin=1e-4)
    np.testing.assert_array_equal(hb.hit.numpy(), hr.hit.numpy())
    hit = hr.hit.numpy()
    np.testing.assert_allclose(hb.t.numpy()[hit], hr.t.numpy()[hit], rtol=1e-6)
    same = hb.tri_idx.numpy()[hit] == hr.tri_idx.numpy()[hit]
    assert same.mean() > 0.99


def test_bvh_closest_on_mesh():
    """Rays from a ring toward the sphere mesh padded to 1024 triangles
    (``tests/test_lbvh.py``'s mesh case)."""
    from raytracinginonesemester_tpu_torch.io.obj import (load_obj,
                                                          mesh_to_triangles)

    mesh, _ = load_obj(os.path.join(REPO, "tests/assets/meshes/sphere.obj"))
    verts, _ = mesh_to_triangles(mesh)
    pad = -verts.shape[0] % 1024
    verts = np.concatenate([verts, np.broadcast_to(verts[0, 0], (pad, 3, 3))])
    tris = torch.from_numpy(np.ascontiguousarray(verts, np.float32))
    n = 128
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    o = np.stack([2 * np.cos(ang), 2 * np.sin(ang), np.full(n, 0.3)],
                 -1).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    hb = traversal.bvh_closest(o, d, build_lbvh(tris), tris, tmin=1e-4)
    hr = intersect_closest(o, d, tris, tmin=1e-4)
    np.testing.assert_array_equal(hb.hit.numpy(), hr.hit.numpy())
    assert bool(hb.hit.all())
    np.testing.assert_allclose(hb.t.numpy(), hr.t.numpy(), rtol=1e-6)


def test_bvh_closest_overflow(monkeypatch):
    """A stack of 3 slots overflows on most rays; the overflowed rays are
    brute-forced, and every ray ends with the brute force's hit and t
    (and the full stack's result where no ray overflowed)."""
    tris = torch.from_numpy(random_tris(1024, seed=5))
    o, d = (torch.from_numpy(a) for a in random_rays(256, seed=6))
    bvh = build_lbvh(tris)
    full = traversal.bvh_closest(o, d, bvh, tris)
    monkeypatch.setattr(traversal, "STACK_DEPTH", 3)
    stats = {}
    small = traversal.bvh_closest(o, d, bvh, tris, stats=stats)
    assert stats["overflowed"] > 16
    brute = intersect_closest(o, d, tris)
    for h in (small, full):
        np.testing.assert_array_equal(h.hit.numpy(), brute.hit.numpy())
        hit = h.hit.numpy()
        np.testing.assert_array_equal(h.t.numpy()[hit], brute.t.numpy()[hit])
    np.testing.assert_array_equal(small.t.numpy(), full.t.numpy())


@pytest.mark.parametrize("block_size", [128, 512])
def test_treelet_grid_matches_jax(block_size):
    """The rules of ``test_block_grid_matches_on_frog``: ids, object ids,
    triangle planes, block boxes and vertex normals exact; geometric
    normals of real triangles within 4 ulp or 1e-6 (XLA:CPU's FMA cross
    product); dead lanes' geometric normals 0 here (XLA:CPU flushes the
    1e-38 clamp and gets NaN, never read)."""
    g = frog_geometry()
    jg = j_treelet(g.vertices, g.num_triangles, normals=g.normals,
                   obj_ids=g.obj_id, block_size=block_size)

    def t_(a):
        return torch.from_numpy(np.array(a))

    tg = t_treelet(t_(g.vertices), g.num_triangles, normals=t_(g.normals),
                   obj_ids=t_(g.obj_id), block_size=block_size)
    assert tg.num_blocks == jg.num_blocks > g.padded_triangles // block_size
    for name in ("tri_index", "obj", "tri", "aabb"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tg.norm[:9].numpy(), np.asarray(jg.norm[:9]))
    valid = tg.tri_index.numpy() >= 0
    assert 0.5 < valid.mean() < 1.0  # dead lanes inside the blocks
    assert ulp_close(tg.norm[9:].numpy()[:, valid],
                     np.asarray(jg.norm[9:])[:, valid], ulps=4, atol=1e-6).all()
    assert (tg.norm[9:].numpy()[:, ~valid] == 0.0).all()


@pytest.fixture(scope="module")
def two_frog_layouts():
    """The two-frog scene (64x32, depth 3, diffuse) with the runs and the
    treelet grid at 512 lanes, built by the port."""
    import dataclasses

    ts = torch_from_jax(jax_two_frog(width=64, height=32, max_bounces=3,
                                     diffuse_bounce=True))
    ts = dataclasses.replace(ts, terminal_only=False)
    g = ts.geometry
    kw = dict(normals=g.normals, obj_ids=g.obj_id, block_size=512)
    runs = build_block_grid(g.vertices, g.num_triangles, **kw)
    tree = t_treelet(g.vertices, g.num_triangles, **kw)
    assert tree.num_blocks > runs.num_blocks
    return (dataclasses.replace(ts, accel=runs),
            dataclasses.replace(ts, accel=tree))


@pytest.mark.parametrize("wavefront", ["1", "0"])
def test_treelet_frames_bit_identical(two_frog_layouts, wavefront):
    """Treelet and runs grids give the same frames bit for bit, on the
    staged wavefront (emit and bounce_step at a capacity of 4 tiles) and
    on the render kernel (the route at this size without a capacity)."""
    from raytracinginonesemester_tpu_torch.render.renderer import (
        render_scene_frames)

    cap = 4 if wavefront == "1" else None
    runs, tree = two_frog_layouts
    a = render_scene_frames(runs, 1, "wang", 0, capacity_tiles=cap)
    b = render_scene_frames(tree, 1, "wang", 0, capacity_tiles=cap)
    assert float(a.std()) > 0.05
    torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_load_scene_treelet(monkeypatch):
    """``RT_BLOCK_LAYOUT=treelet`` builds the treelet grid in both
    packages' ``load_scene``, with the same planes."""
    import raytracinginonesemester_tpu as jrt
    from raytracinginonesemester_tpu_torch.scene.build import load_scene

    monkeypatch.setenv("RT_BLOCK_LAYOUT", "treelet")
    path = os.path.join(REPO, "tests/assets/scenes/gpu_spheres.json")
    js = jrt.load_scene(path)
    ts = load_scene(path, device="cpu")
    assert ts.accel.num_blocks == js.accel.num_blocks
    for name in ("tri_index", "obj", "tri", "aabb"):
        np.testing.assert_array_equal(getattr(ts.accel, name).numpy(),
                                      np.asarray(getattr(js.accel, name)),
                                      err_msg=name)
    assert (ts.accel.tri_index.numpy() < 0).any()


def test_bvh_export_bytes_match_jax(tmp_path):
    """The same boxes give the same OBJ bytes: raw boxes (one inverted),
    an LBVH (all nodes and internal only) and a treelet grid."""
    tris = random_tris(64, seed=2)
    jbvh = j_build(jnp.asarray(tris))
    tbvh = build_lbvh(torch.from_numpy(tris))
    amin = np.array([[0, 0, 0], [5, 5, 5], [2, 2, 2]], np.float32)
    amax = np.array([[1, 1, 1], [4, 4, 4], [3, 3, 3]], np.float32)
    g = frog_geometry()
    jg = j_treelet(g.vertices, g.num_triangles, block_size=512)
    tg = t_treelet(torch.from_numpy(np.array(g.vertices)), g.num_triangles,
                   block_size=512)
    cases = [
        ("boxes", lambda m, p: m.export_aabbs_to_obj(p, amin, amax), 2),
        ("lbvh", lambda m, p: m.export_lbvh_to_obj(
            p, jbvh if m is j_export else tbvh), 127),
        ("internal", lambda m, p: m.export_lbvh_to_obj(
            p, jbvh if m is j_export else tbvh, internal_only=True), 63),
        ("grid", lambda m, p: m.export_block_grid_to_obj(
            p, jg if m is j_export else tg), tg.num_blocks),
    ]
    for name, fn, count in cases:
        pj, pt = str(tmp_path / f"j_{name}.obj"), str(tmp_path / f"t_{name}.obj")
        assert fn(j_export, pj) == fn(t_export, pt) == count, name
        with open(pj, "rb") as a, open(pt, "rb") as b:
            assert a.read() == b.read(), name
