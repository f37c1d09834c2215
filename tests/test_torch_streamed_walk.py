"""Kernels G, I and H of the PyTorch port as the card runs them
(``csrc/block_stream.cu`` ``streamed_kernel``), emulated on the CPU.

A CTA walks one of the two halves of a 512-ray tile (rays p, p + 2, ...
for CTA p).  It first marks its candidates: the blocks of the tile's plan
row (G, I), or of the slabs the gate lets through for the tile's chunk,
in block order (H), whose slab test passes for one of its active lanes (a
nonzero direction, one of the real rays) on the lane's window at the
start.  It then takes them in order; before each it stops once the entry
exceeds every active lane's best t (G; H's closest hit has no exit) or
every active lane is blocked (I, H), its own lanes; otherwise the lanes
whose slab test passes on their window now are listed, and each (ray,
block) pair of the list is tested
by 32 lanes, lane l taking slots l, l + 32, ... at the owner's window:
G keeps a lane's first (t, id) minimum in ascending slot order, a xor
tree (16, 8, 4, 2, 1) keeps the lexicographic (t, id, slot) minimum,
and the owner takes it by the (t, id) take rule with u and v from the
winner's lane; I votes every 128 slots and the owner is blocked if a
vote finds a hit.
The emulation does the same with torch ops, every CTA at once, and is
held bit for bit against the plain versions (``block_closest_streamed_
plain``, ``block_occluded_streamed_plain`` and the ``blockmajor`` ones),
which walk the JAX kernels' schedule; the tests and tested blocks it
counts are held to the plain versions' ``walk_pairs`` and
``walk_tested_blocks`` (a CTA that stops has also copied the candidate
it stops at and the next one, which neither counts).  The C constants of
that design are held to their Python counterparts.
"""

import os
import re

import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu_torch.ops import block_kernels as bk
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.ops.accel import (
    SUPER, build_block_grid, tile_visit_plan_fast)
from raytracinginonesemester_tpu_torch.ops.megakernel import RAY_TILE

from _torch_parity import REPO, one_torch_thread  # noqa: F401

F32_MAX = tmk.F32_MAX
_BIG = torch.iinfo(torch.int64).max
_LANE = torch.arange(bk.STREAM_LANES)


def _key_less(t, i, j, t2, i2, j2):
    return (t < t2) | ((t == t2) & ((i < i2) | ((i == i2) & (j < j2))))


def _slab(box, o, inv, t0, t1):
    """Each CTA's (C, 8) box row against its lanes' (C, L) rays."""
    a = tuple(box[:, c, None] for c in range(6))
    return tmk._slab(a, o, inv, t0, t1)


def _pair_closest(o, d, tmin, win, tri, ids, det_eps):
    """G's pair test: P pairs (o, d (P,) each per axis, tmin, win (P,)),
    each against its block (tri: 9 x (P, B), ids (P, B)) -> the block's
    winner (t, u, v, id, slot) as the 32 lanes and the xor tree find it."""
    n, bs = ids.shape
    t, u, v = tmk._mt(tuple(c[:, None] for c in o),
                      tuple(c[:, None] for c in d), tri, det_eps,
                      tmin[:, None], win[:, None])
    lt = torch.full((n, bk.STREAM_LANES), F32_MAX)
    lu, lv = torch.zeros(n, bk.STREAM_LANES), torch.zeros(n, bk.STREAM_LANES)
    li = torch.full((n, bk.STREAM_LANES), _BIG)
    lj = torch.full((n, bk.STREAM_LANES), _BIG)
    for r in range(-(-bs // bk.STREAM_LANES)):  # a lane's slots, ascending
        j = r * bk.STREAM_LANES + _LANE
        ok = j < bs
        jj = torch.where(ok, j, 0)
        ti, ii = t[:, jj], ids[:, jj]
        take = ok[None, :] & (ii >= 0) & (ti < F32_MAX) & (
            (ti < lt) | ((ti == lt) & (ii < li)))
        lt = torch.where(take, ti, lt)
        lu = torch.where(take, u[:, jj], lu)
        lv = torch.where(take, v[:, jj], lv)
        li = torch.where(take, ii, li)
        lj = torch.where(take, jj[None, :].expand(n, -1), lj)
    for off in (16, 8, 4, 2, 1):
        x = _LANE ^ off
        sw = _key_less(lt[:, x], li[:, x], lj[:, x], lt, li, lj)
        lt = torch.where(sw, lt[:, x], lt)
        li = torch.where(sw, li[:, x], li)
        lj = torch.where(sw, lj[:, x], lj)
    assert (lt == lt[:, :1]).all() and (lj == lj[:, :1]).all()
    src = torch.where(lj[:, 0] == _BIG, 0, lj[:, 0] % bk.STREAM_LANES)
    rr = torch.arange(n)
    return lt[:, 0], lu[rr, src], lv[rr, src], li[:, 0], lj[:, 0]


def _pair_any(o, d, tmin, win, tri, ids, det_eps):
    """I's pair test -> (hit (P,), tests made: live slots up to the vote
    that finds the first hit)."""
    t, _, _ = tmk._mt(tuple(c[:, None] for c in o),
                      tuple(c[:, None] for c in d), tri, det_eps,
                      tmin[:, None], win[:, None])
    live = ids >= 0
    hit = live & (t < F32_MAX)
    done = torch.zeros(ids.shape[0], dtype=torch.bool)
    tests = 0
    for j0 in range(0, ids.shape[1], bk.STREAM_VOTE):
        tests += int(live[~done, j0:j0 + bk.STREAM_VOTE].sum())
        done |= hit[:, j0:j0 + bk.STREAM_VOTE].any(dim=1)
    return done, tests


def _emulate(origins, dirs, grid, tmin, tmax, det_eps, closest, gate=None):
    """``streamed_kernel`` on (R, 3) rays -> (outputs of the R rays: (t,
    u, v, id) or blocked, the ray-triangle tests, the tested blocks).
    ``gate``: None (G, I: the tiles' plan), or H's (chunk_tiles,
    slab_blocks)."""
    rows = bk.grid_rows(grid)
    nb = rows.num_blocks
    r = int(origins.shape[0])
    rays, rp = bk._prep_rays(origins, dirs, tmin, tmax)
    if gate is not None:
        chunk_tiles, slab_blocks = gate
        rays, rp = bk._pad_rays(rays, chunk_tiles * RAY_TILE)
    nt = rp // RAY_TILE
    o = tuple(rays[:, c] for c in range(3))
    d = tuple(rays[:, 3 + c] for c in range(3))
    inv = tuple(1.0 / c for c in d)
    t0, t1 = rays[:, 6], rays[:, 7]
    active = (rays[:, 3:6] != 0.0).any(dim=1) & (torch.arange(rp) < r)
    best_t = torch.full((rp,), F32_MAX)
    best_u, best_v = torch.zeros(rp), torch.zeros(rp)
    best_id = torch.full((rp,), -1, dtype=torch.int64)
    blocked = torch.zeros(rp, dtype=torch.bool)
    # CTA c = tile * S + p holds the tile's rays p, p + S, ...
    split = bk.STREAM_SPLIT
    lanes_all = torch.arange(rp).reshape(nt, RAY_TILE // split, split)
    lanes_all = lanes_all.transpose(1, 2).reshape(nt * split, -1)
    tile_of = torch.arange(nt * split) // split
    n_cta = nt * split
    if gate is None:
        order, entry, count = tile_visit_plan_fast(
            rays[:, 0:3], rays[:, 3:6], grid, t0, t1, RAY_TILE)
        order, entry = order[tile_of].long(), entry[tile_of]
        count = count[tile_of, 0]
        n_pos = int(order.shape[1]) * SUPER

        def block_at(p, ctas):  # -> (block, in the CTA's candidates)
            b = order[ctas, p // SUPER] * SUPER + p % SUPER
            return b, (p // SUPER < count[ctas]) & (b < nb)
    else:
        _, union, nj = bk._slab_aabbs(grid, slab_blocks)
        gated = bk._chunk_slab_gate(rays, chunk_tiles * RAY_TILE, union,
                                    nj)[tile_of // chunk_tiles] > 0
        n_pos = nb

        def block_at(p, ctas):
            return (torch.full_like(ctas, p),
                    gated[ctas, p // slab_blocks])

    def lane_rows(lanes, x):
        return tuple(c[lanes] for c in x)

    # 1. candidates on the starting windows
    cand = torch.zeros(n_cta, n_pos, dtype=torch.bool)
    start = torch.full_like(t0, F32_MAX) if closest else t1
    every = torch.arange(n_cta)
    for p in range(n_pos):
        b, ok = block_at(p, every)
        box = rows.aabb[b.clamp(max=nb - 1)]
        hit = _slab(box, lane_rows(lanes_all, o), lane_rows(lanes_all, inv),
                    t0[lanes_all], start[lanes_all]) & active[lanes_all]
        cand[:, p] = ok & hit.any(dim=1)

    # 2. the candidates in plan order
    walking = torch.ones(n_cta, dtype=torch.bool)
    tests = tested = 0
    for p in range(n_pos):
        tl = (walking & cand[:, p]).nonzero().squeeze(1)
        if tl.numel() == 0:
            continue
        lanes = lanes_all[tl]
        if not closest:
            stop = ~(active[lanes] & ~blocked[lanes]).any(dim=1)
        elif gate is None:
            m = torch.where(active[lanes], best_t[lanes],
                            -float("inf")).amax(dim=1)
            stop = ~(entry[tl, p // SUPER] <= m)
        else:
            stop = torch.zeros_like(tl, dtype=torch.bool)
        walking[tl[stop]] = False
        tl, lanes = tl[~stop], lanes[~stop]
        if tl.numel() == 0:
            continue
        tested += tl.numel()
        b = block_at(p, tl)[0]
        win = best_t[lanes] if closest else t1[lanes]
        passing = active[lanes] & _slab(rows.aabb[b], lane_rows(lanes, o),
                                        lane_rows(lanes, inv), t0[lanes], win)
        if not closest:
            passing &= ~blocked[lanes]
        own = lanes[passing]
        if own.numel() == 0:
            continue
        pb = b[:, None].expand_as(lanes)[passing]
        tri = tuple(rows.tri[q][pb] for q in range(9))
        ids = rows.ids[pb].to(torch.int64)
        args = (lane_rows(own, o), lane_rows(own, d), t0[own], win[passing],
                tri, ids, det_eps)
        if closest:
            wt, wu, wv, wi, _ = _pair_closest(*args)
            tests += int((ids >= 0).sum())
            old_key = torch.where(best_id[own] >= 0, best_id[own], _BIG)
            take = (wt < F32_MAX) & ((wt < best_t[own])
                                     | ((wt == best_t[own]) & (wi < old_key)))
            best_t[own] = torch.where(take, wt, best_t[own])
            best_u[own] = torch.where(take, wu, best_u[own])
            best_v[own] = torch.where(take, wv, best_v[own])
            best_id[own] = torch.where(take, wi, best_id[own])
        else:
            hit, n = _pair_any(*args)
            tests += n
            blocked[own] = hit
    if closest:
        out = (best_t[:r], best_u[:r], best_v[:r], best_id[:r].to(torch.int32))
    else:
        out = blocked[:r]
    return out, tests, tested


# --- the scenes and rays ------------------------------------------------


@pytest.fixture(scope="module")
def two_frog():
    """The two-frog scene at 64x32 (``RT_BLOCK_SIZE=128``, the tests'
    default) with its camera rays, and seeded bounce rays in its box (the
    last 512 parked at 1e30, as the integrator parks dead rays)."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    ts = build_scene(two_frog_config(SceneConfig, SceneNodeConfig, Transform,
                                     width=64, height=32), device="cpu")
    ys, xs = torch.meshgrid(torch.arange(32.0), torch.arange(64.0),
                            indexing="ij")
    co, cd = ts.camera.get_rays(xs.reshape(-1) + 0.5, ys.reshape(-1) + 0.5)
    rng = np.random.default_rng(3)
    box = ts.accel.aabb.numpy()
    lo, hi = box[:3].min(axis=1), box[3:].max(axis=1)
    n = co.shape[0]
    bo = (lo + rng.uniform(0, 1, (n, 3)) * (hi - lo)).astype(np.float32)
    bd = rng.normal(size=(n, 3)).astype(np.float32)
    bd /= np.linalg.norm(bd, axis=1, keepdims=True)
    bo[-512:] = 1e30
    return ts.accel, {"camera": (co.contiguous(), cd.contiguous()),
                      "bounce": (torch.from_numpy(bo), torch.from_numpy(bd))}


@pytest.fixture(scope="module")
def random_scene():
    """4096 seeded random triangles at 128 a block; 1000 rays from one
    point (not a whole number of tiles: the last tile is padded)."""
    rs = np.random.RandomState(7)
    tris = torch.from_numpy(rs.uniform(-1, 1, (4096, 3, 3)).astype(
        np.float32))
    grid = build_block_grid(tris, 4096, block_size=128)
    o = torch.tensor([[0.0, -3.0, 0.0]]).repeat(1000, 1)
    d = rs.uniform(-1, 1, (1000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return grid, {"camera": (o, torch.from_numpy(d))}


def _shadow_rays(grid, o, d, light):
    """Shadow rays from the closest hits toward ``light``, as the
    integrator spawns them: the missed rays' shade points parked at 1e30
    with a zero direction and an infinite distance; a few hits' rays get
    a zero direction too."""
    hits = bk.block_closest_streamed_plain(o, d, grid, 1e-4)
    p = torch.where(hits.hit[:, None], o + hits.t[:, None] * d, 1e30)
    to = torch.as_tensor(light, dtype=torch.float32) - p
    dist = torch.sqrt((to * to).sum(dim=1))
    sd = to / torch.clamp(dist, min=1e-20)[:, None]
    sd[hits.hit.nonzero().squeeze(1)[::7]] = 0.0
    assert bool((sd[~hits.hit] == 0.0).all()) and 0 < int(hits.hit.sum())
    return p, sd, torch.full_like(dist, 1e-4), dist


def _check(grid, o, d, tmin, tmax, closest, gate=None):
    stats = {}
    kw = {} if gate is None else dict(chunk_tiles=gate[0],
                                      slab_blocks=gate[1])
    if closest:
        plain = (bk.block_closest_streamed_plain if gate is None
                 else bk.block_closest_blockmajor_plain)
        want = plain(o, d, grid, tmin, stats=stats, **kw)
        want = (want.t, want.u, want.v, want.tri_idx)
    else:
        plain = (bk.block_occluded_streamed_plain if gate is None
                 else bk.block_occluded_blockmajor_plain)
        want = (plain(o, d, grid, tmin, tmax, stats=stats, **kw),)
    got, tests, tested = _emulate(o, d, grid, tmin, tmax, 1e-8, closest,
                                  gate)
    got = got if closest else (got,)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tests == stats["walk_pairs"] > 0
    assert tested == stats["walk_tested_blocks"] > 0
    if closest:  # the same (ray, block) pairs as the JAX kernel's walk
        assert stats["walk_pairs"] == stats["pairs"]
    return want


@pytest.mark.parametrize("case", ["two_frog camera", "two_frog bounce",
                                  "random camera"])
def test_streamed_walk_matches_the_plain_walk(case, two_frog, random_scene):
    """G on camera and bounce rays, then I on their shadow rays toward a
    light (parked and zero-direction lanes among them), bit for bit."""
    scene, rays = case.split()
    grid, sets = two_frog if scene == "two_frog" else random_scene
    o, d = sets[rays]
    hits = _check(grid, o, d, 1e-4, F32_MAX, True)
    assert 0 < int((hits[3] >= 0).sum()) < o.shape[0]
    light = (0.0, 4.0, 3.0) if scene == "two_frog" else (0.5, 3.0, 0.5)
    blocked = _check(grid, *_shadow_rays(grid, o, d, light), False)[0]
    assert 0 < int(blocked.sum())


@pytest.mark.parametrize("case,gate", [("two_frog camera", (1, 8)),
                                       ("two_frog bounce", (2, 16)),
                                       ("random camera", (1, 4))])
def test_blockmajor_walk_matches_the_plain_sweep(case, gate, two_frog,
                                                 random_scene):
    """H on camera and bounce rays, then on their shadow rays toward a
    light (parked and zero-direction lanes among them), bit for bit;
    chunks of 1 or 2 tiles and slabs of 4-16 blocks, so that the gate
    lets some slabs through and not others.  (The kernel's warps also
    skip a slab whose union box none of their lanes passes: a box inside
    it fails for those lanes too, so the candidates are the same.)"""
    scene, rays = case.split()
    grid, sets = two_frog if scene == "two_frog" else random_scene
    o, d = sets[rays]
    hits = _check(grid, o, d, 1e-4, F32_MAX, True, gate)
    assert 0 < int((hits[3] >= 0).sum()) < o.shape[0]
    light = (0.0, 4.0, 3.0) if scene == "two_frog" else (0.5, 3.0, 0.5)
    blocked = _check(grid, *_shadow_rays(grid, o, d, light), False, gate)[0]
    assert 0 < int(blocked.sum())
    rays, _ = bk._prep_rays(o, d, 1e-4, F32_MAX)
    rays, _ = bk._pad_rays(rays, gate[0] * RAY_TILE)
    _, union, nj = bk._slab_aabbs(grid, gate[1])
    g = bk._chunk_slab_gate(rays, gate[0] * RAY_TILE, union, nj)
    assert 0 < int(g.sum()) < g.numel()


def test_stream_constants_match_the_kernel_source():
    """``csrc/block_stream.cu``'s tile, superblock and pair constants are
    the ones the wrappers and the plain walks assume."""
    path = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc",
                        "block_stream.cu")
    with open(path) as f:
        text = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)
                   .group(1))

    assert const("kTile") == RAY_TILE
    assert const("kSuper") == SUPER
    assert const("kSplit") == bk.STREAM_SPLIT
    assert RAY_TILE % (32 * bk.STREAM_SPLIT) == 0
    assert const("kPairLanes") == bk.STREAM_LANES == 32
    assert const("kVote") == bk.STREAM_VOTE
    assert const("kBuffers") == bk.STREAM_BUFFERS
    assert bk.STREAM_VOTE % bk.STREAM_LANES == 0
