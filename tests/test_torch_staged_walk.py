"""Kernels E (the staged integrator's closest hit) and C (the overflow
resume) of the PyTorch port as the card runs them
(``csrc/megakernel.cu``), emulated on the CPU.

E runs in three launches.  A ray a thread: a ray whose slab test on
[tmin, FLT_MAX] passes no block misses (t = FLT_MAX, u = v = 0, id -1,
normal (0, 0, 1), visibility 0) and the others are listed.  A grid that
fills the card walks the list up to ``kRaysPerWarp`` rays a warp (fewer
when the list is short), a (ray, block) pair's triangles tested on the
warp's 32 lanes at the owner's window, a xor tree keeping the (t, id,
slot) minimum (``closest_coop``),
then shades the hits (the gpu shading normal) and lists the (ray, light)
entries that face their light and whose slab test passes some block on
[shadow_tmin, dist].  A third launch walks that list as emit's shadow
list is walked (``occluded_coop``, up to ``kListRays`` entries a warp)
and clears the visibility of the blocked ones.  Each entry's walk is its
own, so the grouping changes no result and the emulation walks every
entry at once.

C runs ``bounce_step``'s walks (``bounce<.., kWarp>``), ``kResumeRays``
rays a warp, its depth loop running while a ray of the warp is alive; a
lane whose ray is dead takes part in the others' walks and keeps its
state.

The emulations do the same with torch ops -- B's and A's walks of
``test_torch_megakernel`` (``_coop_closest``, ``_coop_occluded``) and
``_torch_parity.list_occluded``, in place of the plain walks -- and are
held bit for bit against ``block_closest_plain`` (normals and two
lights' shadows with ``shared_origin`` on and off, no normals, parked
rays, per-ray tmin) and ``resume_tiles_plain`` (gpu; cpuonly with an
area light and diffuse bounces).  The C constants the design relies on
are held to the emulations'.
"""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render.renderer import (
    _swizzled_grid as t_grid)

from _torch_parity import REPO, list_occluded, one_torch_thread  # noqa: F401
from test_torch_megakernel import _coop_closest, _coop_occluded

W, H = 48, 24
WARP = 32
RAYS_PER_WARP = 8  # kRaysPerWarp: the most rays a warp of E's walk takes
LIST_RAYS = 4  # kListRays: the most shadow-list entries a warp takes
RESUME_RAYS = 4  # kResumeRays: the rays of a warp of C
N_PARKED = 128
FOCAL_MM = 100.0


def _scene(dialect, monkeypatch, block_size=128):
    """Two-frog 48x24 at 128-triangle blocks through a 100 mm lens (the
    frame sees part of the frog, and bounce rays find shadow blockers),
    depth 3, diffuse bounces; cpuonly with an area light of radius 0.15
    and 2 disk samples.  At 128 the grid's last block is empty: its box
    (inf, -inf) passes every ray's slab test (the reference's NaN rule),
    so every ray walks it; at 256 no block is empty."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    monkeypatch.setenv("RT_BLOCK_SIZE", str(block_size))
    cfg = dataclasses.replace(
        two_frog_config(SceneConfig, SceneNodeConfig, Transform, width=W,
                        height=H, max_bounces=3, dialect=dialect),
        focal_length_mm=FOCAL_MM)
    if dialect == "cpuonly":
        cfg = dataclasses.replace(cfg, lights=[
            {**l, "radius": 0.15, "shadow_samples": 2} for l in cfg.lights])
    scene = build_scene(cfg, device="cpu")
    assert scene.accel.block_size == block_size
    return scene


def _rays(scene, kind, seed=11):
    """(origins, dirs, tmin) of E's cases, from numpy's seeded generator:
    jittered camera rays at tmin 1e-4, or bounce rays from the grid's box
    with the last N_PARKED parked at 1e30 (half of those with every
    direction component negative, so their slab tests pass and the
    triangles decide) and per-ray tmin in [0, 0.02)."""
    rng = np.random.default_rng(seed)
    r = W * H
    if kind == "camera":
        ys, xs = np.mgrid[0:H, 0:W]
        px = torch.from_numpy((xs.ravel() + rng.uniform(0, 1, r))
                              .astype(np.float32))
        py = torch.from_numpy((ys.ravel() + rng.uniform(0, 1, r))
                              .astype(np.float32))
        o, d = scene.camera.get_rays(px, py)
        return o.contiguous(), d.contiguous(), 1e-4
    box = scene.accel.aabb.numpy()
    lo, hi = box[:3].min(axis=1), box[3:].max(axis=1)
    bo = (lo + rng.uniform(0, 1, (r, 3)) * (hi - lo)).astype(np.float32)
    bd = rng.normal(size=(r, 3)).astype(np.float32)
    bd[-N_PARKED // 2:] = -np.abs(bd[-N_PARKED // 2:])
    bd = (bd / np.linalg.norm(bd, axis=1, keepdims=True)).astype(np.float32)
    bo[-N_PARKED:] = 1e30
    tmin = rng.uniform(0.0, 0.02, r).astype(np.float32)
    return (torch.from_numpy(bo), torch.from_numpy(bd),
            torch.from_numpy(tmin))


def _listed_closest(seen):
    """E's first two launches in place of ``_closest_plain``: the rays
    whose slab test on [tmin, FLT_MAX] passes some block are listed and
    walked by ``closest_coop``; the others keep the miss.  ``seen``
    receives (rays, listed) of each call."""

    def closest(rows, o, d, alive, det_eps, tmin):
        inv = tuple(1.0 / c for c in d)
        tmin_t = (tmin if torch.is_tensor(tmin)
                  else torch.full_like(d[0], tmin))
        slabs = tmk._slab(rows.aabb.T[:, None, :],
                          tuple(c[:, None] for c in o),
                          tuple(c[:, None] for c in inv), tmin_t[:, None],
                          torch.full_like(tmin_t, tmk.F32_MAX)[:, None])
        listed = slabs.any(dim=1) & alive
        seen.append((int(alive.sum()), int(listed.sum())))
        return _coop_closest(rows, o, d, listed, det_eps, tmin)

    return closest


def _fields(out):
    out = out if isinstance(out, tuple) else (out,)
    h = out[0]
    return (h.t, h.u, h.v, h.tri_idx, h.hit) + out[1:]


@pytest.mark.parametrize("rays,normals,shared,block_size", [
    ("camera", True, False, 128),
    ("camera", True, True, 128),
    ("bounce", True, False, 128),
    ("camera", False, False, 128),
    ("bounce", False, False, 128),
    ("bounce", True, False, 256),
])
def test_closest_walk_matches_the_plain_walk(rays, normals, shared,
                                             block_size, monkeypatch):
    """E's listed walk and its listed shadow walk give the plain
    version's t, u, v, ids, normals and both lights' visibility bit for
    bit; parked rays miss, and they and the rays to the sky are never
    listed, also beside an empty block (block size 128), whose box the
    slab test rejects."""
    scene = _scene("gpu", monkeypatch, block_size)
    empty = bool((scene.accel.aabb[0] > scene.accel.aabb[3]).any())
    assert empty == (block_size == 128)
    o, d, tmin = _rays(scene, rays)
    kw = dict(return_normal=normals, shared_origin=shared,
              shadow_lights=scene.lights.position if normals else None)
    want = bk.block_closest_plain(o, d, scene.accel, tmin, **kw)
    seen, walked = [], []

    def shadow(*a, **k):
        blocked, tests = list_occluded(*a, **k)
        walked.append(int(blocked.sum()))
        return blocked, tests

    monkeypatch.setattr(bk, "_closest_plain", _listed_closest(seen))
    monkeypatch.setattr(bk, "_occluded_plain", shadow)
    got = bk.block_closest_plain(o, d, scene.accel, tmin, **kw)
    for g, w in zip(_fields(got), _fields(want)):
        assert torch.equal(g, w)
    (n, listed), = seen
    hits = _fields(want)[4]
    assert 0 < int(hits.sum()) <= listed <= n
    assert listed < n  # parked rays are listed by no block, empty or not
    if rays == "bounce":
        assert torch.is_tensor(tmin) and not bool(hits[-N_PARKED:].any())
    if normals:
        vis = _fields(want)[6]
        assert len(walked) == 2 and sum(walked) > 0  # blockers found
        assert 0 < float(vis.sum()) < vis.numel()
    else:
        assert not walked


def _resume_emulated(rows, st, rng, max_bounces, sh):
    """``resume_kernel`` on sorted or unsorted state rows -> (r, g, b),
    each (nt, RAY_TILE), and the warp-depths run, with the walks already
    in place of the plain ones: depths 1..max-1 while a ray of the warp
    of ``RESUME_RAYS`` is alive, every ray of such a warp through the
    bounce (a dead one unchanged)."""
    nt, rt = st.shape[0] // 16, st.shape[1]
    flat = tmk._unpack(st, rng)
    warp_depths = 0
    for _ in range(1, int(max_bounces)):
        warps = (flat["alive"] > 0.0).reshape(-1, RESUME_RAYS).any(dim=1)
        if not bool(warps.any()):
            break
        warp_depths += int(warps.sum())
        lanes = warps.repeat_interleave(RESUME_RAYS).nonzero().squeeze(1)
        sub = {key: ([c[lanes] for c in v] if isinstance(v, list)
                     else v[lanes]) for key, v in flat.items()}
        tmk._bounce_plain(rows, sub, sh)
        for key, v in sub.items():
            if isinstance(v, list):
                flat[key] = [a.index_put((lanes,), b)
                             for a, b in zip(flat[key], v)]
            else:
                flat[key] = flat[key].index_put((lanes,), v)
    return tuple(c.reshape(nt, rt) for c in flat["rd"]), warp_depths


@pytest.mark.parametrize("dialect", ["gpu", "cpuonly"])
def test_resume_walk_matches_the_plain_walk(dialect, monkeypatch):
    """C's walks and its warp-uniform depth loop give the plain version's
    r, g, b bit for bit, from the depth-0 state of the emit pass (gpu;
    cpuonly with an area light and diffuse bounces)."""
    scene = _scene(dialect, monkeypatch)
    rows = tmk._scene_rows(scene, scene.accel)
    kw = tmk.megakernel_kwargs(scene, "wang")
    pkw = {k: v for k, v in kw.items() if k != "jitter"}
    xs, ys, _ = t_grid(W, H)
    st, rng = tmk.emit_tiles(scene, xs, ys, 0, **kw)
    alive = tmk._unpack(st, rng)["alive"] > 0.0
    assert 0 < int(alive.sum()) < alive.numel()
    want = tmk.resume_tiles_plain(rows, st, rng, scene.max_bounces,
                                  scene.diffuse_bounce, **pkw)
    sh = tmk._plain_shade(scene.diffuse_bounce, pkw.get("det_eps", 1e-8),
                          1e-4, pkw.get("shadow_eps", 1e-3),
                          pkw.get("shadow_tmin", 1e-4), dialect,
                          pkw.get("shadow_samples", 1))
    calls = {"closest": 0, "shadow": 0, "blocked": 0}

    def closest(*a, **k):
        calls["closest"] += 1
        return _coop_closest(*a, **k)

    def shadow(*a, **k):
        calls["shadow"] += 1
        blocked, tests = _coop_occluded(*a, **k)
        calls["blocked"] += int(blocked.sum())
        return blocked, tests

    monkeypatch.setattr(tmk, "_closest_plain", closest)
    monkeypatch.setattr(tmk, "_occluded_plain", shadow)
    got, warp_depths = _resume_emulated(rows, st, rng, scene.max_bounces, sh)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert warp_depths > 0 and calls["closest"] > 0
    assert calls["shadow"] > 0 and calls["blocked"] > 0
    assert 0.0 < float(want[0].max())


def test_staged_constants_match_the_kernel_source():
    """``csrc/megakernel.cu``: the rays a warp of E's walk and of C and
    the entries a warp takes of a shadow list are the emulations'; E's
    launches walk with ``closest_coop`` and ``walk_list``, C with
    ``bounce<.., kWarp>`` at ``kResumeRays`` rays a warp; the
    one-thread-a-ray walks are gone."""
    path = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc",
                        "megakernel.cu")
    with open(path) as f:
        text = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    assert const("kRaysPerWarp") == RAYS_PER_WARP
    assert const("kListRays") == LIST_RAYS
    assert const("kResumeRays") == RESUME_RAYS
    for n in (RAYS_PER_WARP, LIST_RAYS, RESUME_RAYS):
        assert WARP % n == 0

    def body(name):
        start = re.search(rf"\n(int )?{name}\(", text).start()
        return text[start:text.index("\n}\n", start)]

    walk = body("closest_walk_kernel")
    assert "take_groups(q, kRaysPerWarp," in walk and "closest_coop(" in walk
    assert "walk_list(" in body("closest_shadow_kernel")
    assert "list_append(" in body("closest_kernel")
    assert "bounce<CPU, false, kWarp>(" in body("resume_kernel")
    assert "constexpr int rays = kResumeRays;" in body("rt_resume")
    for gone in ("__device__ Hit closest(", "__device__ bool occluded(",
                 "kSolo"):
        assert gone not in text
