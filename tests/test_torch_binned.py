"""The port's binned camera plan (``ops/binned.py``) and its binned emit.

The plan is built on the device with torch ops; its tile metadata and
stream rows 0-10 (planes, global id, home row) must equal the JAX
package's host build exactly, and row 11 must hold each candidate's
grid slot.  The renderer's plans are ordered front to back: each tile's
candidates the same, sorted by a near bound (row 12) that no camera
ray's t of the candidate is below.  The binned emit must give the block walk's winners: alive
flags, radiance and every alive lane's state and rng bit for bit, and
the JAX binned emit (Pallas interpret mode) within the emit tolerance
of ``test_torch_megakernel.py`` (4 ulp or 5e-5, with alive and rng rows
exact).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracinginonesemester_tpu.ops import binned as jb
from raytracinginonesemester_tpu.ops import megakernel as jmk
from raytracinginonesemester_tpu.render.renderer import _swizzled_grid as j_grid
from raytracinginonesemester_tpu_torch.ops import binned as tb
from raytracinginonesemester_tpu_torch.ops import megakernel as tmk
from raytracinginonesemester_tpu_torch.render.renderer import _swizzled_grid as t_grid

from _torch_parity import (
    jax_two_frog, one_torch_thread, torch_from_jax, ulp_close)

W, H = 64, 32
EMIT_ATOL = 5e-5


@pytest.fixture(scope="module")
def scenes():
    js = jax_two_frog(width=W, height=H, max_bounces=3, diffuse_bounce=True)
    return js, torch_from_jax(js)


def _jax_plan(js, chunk, w=W, h=H):
    xs, ys, _ = j_grid(w, h)
    xs_p, ys_p, _, _ = jmk._pad_tiles(xs, ys)
    return jb.build_camera_candidate_plan(js.camera, xs_p, ys_p, js.accel,
                                          jmk.RAY_TILE, nq=1, chunk=chunk)


def _torch_stream(ts, w=W, h=H):
    xs, ys, _ = t_grid(w, h)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    return xs_p, ys_p


def _torch_plan(ts, chunk, w=W, h=H):
    xs_p, ys_p = _torch_stream(ts, w, h)
    return tb.build_camera_candidate_plan(ts.camera, xs_p, ys_p, ts.accel,
                                          tmk.RAY_TILE, chunk=chunk)


def _tile_lanes(plan):
    """Each tile's (lanes, CAND_ROWS) rows in walk order."""
    stream = plan.stream.reshape(plan.total_chunks, tb.CAND_ROWS, plan.chunk)
    return [stream[s:s + c].permute(0, 2, 1).reshape(-1, tb.CAND_ROWS)
            for s, c in plan.meta[:, :2].tolist()]


@pytest.mark.parametrize("chunk", [128, 256])
def test_front_to_back_order_keeps_each_tiles_candidates(scenes, chunk):
    """The ordered plan has the built plan's meta and chunk count; each
    tile holds the same rows 0-11 (as a multiset: live ids are unique and
    padding lanes equal); row 12 ascends within a tile, padding last at
    +inf, and is the distance from the camera's centre to the candidate's
    AABB less ``NEAR_MARGIN`` of it (0 in the built plan)."""
    _, ts = scenes
    built = _torch_plan(ts, chunk)
    ordered = tb.order_front_to_back(built, ts.camera)
    assert ordered.total_chunks == built.total_chunks
    assert torch.equal(ordered.meta, built.meta)
    assert ordered.camera == built.camera
    assert not built.stream.reshape(-1, tb.CAND_ROWS, chunk)[:, 12:].any()
    centre = ts.camera.center.to(torch.float64)
    tiles = 0
    for a, b in zip(_tile_lanes(built), _tile_lanes(ordered)):
        if not a.numel():
            continue
        tiles += 1
        by_id = lambda x: x[torch.sort(x[:, 9], stable=True).indices, :12]
        assert torch.equal(by_id(a), by_id(b))
        near = b[:, tb.NEAR_ROW]
        assert bool((near[1:] >= near[:-1]).all())
        live = b[:, 9] >= 0
        assert bool(torch.isinf(near[~live]).all())
        assert bool(live[:int(live.sum())].all())
        v = b[live, :9].to(torch.float64).reshape(-1, 3, 3)
        pts = torch.stack((v[:, 0], v[:, 0] + v[:, 1], v[:, 0] + v[:, 2]), 1)
        gap = torch.clamp(torch.maximum(pts.amin(1) - centre,
                                        centre - pts.amax(1)), min=0.0)
        want = gap.norm(dim=1) * (1.0 - tb.NEAR_MARGIN)
        torch.testing.assert_close(near[live].to(torch.float64), want,
                                   rtol=1e-5, atol=1e-7)
    assert tiles > 1


def _port_scene(name):
    """A scene of the port on the CPU at its own size: a JSON scene of
    ``tests/assets/scenes``, or the terminal frog at 1920x1080."""
    import os

    from raytracinginonesemester_tpu_torch.render import renderer as tr
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        load_scene_config)

    if name == "frog_1080p_terminal":
        return tr.frog_scene(1920, 1080, max_bounces=4, diffuse_bounce=False,
                             device="cpu")
    path = os.path.join(os.path.dirname(__file__), "assets", "scenes",
                        f"{name}.json")
    return build_scene(load_scene_config(path), scene_path=path,
                       device="cpu")


@pytest.mark.parametrize("scene", ["two_frog", "cpuonly_mirror",
                                   "gpu_cornell", "frog_1080p_terminal"])
def test_near_bound_is_conservative(scenes, scene):
    """For every (ray, candidate) pair of a tile, at the four extreme
    jitters of [-0.5, 0.5] and at the Wang jitter, the plain
    Moller-Trumbore t is at least the candidate's near bound, or a miss:
    on the two-frog scene, on the cpuonly mirror scene, on the Cornell box
    (walls of 550 units, seen at a slant, and the camera 800 units off)
    and on the terminal frog at 1920x1080, the benchmark's headline
    frame."""
    ts = scenes[1] if scene == "two_frog" else _port_scene(scene)
    w, h = int(ts.camera.width), int(ts.camera.height)
    plan = tb.order_front_to_back(_torch_plan(ts, 128, w, h), ts.camera)
    xs_p, ys_p = _torch_stream(ts, w, h)
    rows = tmk._scene_rows(ts, ts.accel)
    cam = rows.cam
    nt = int(plan.meta.shape[0])
    work = torch.ones(nt, dtype=torch.bool)
    dirs = [tmk._primary_state(rows, xs_p, ys_p, 0, "wang", work)["bd"]]
    for jx in (-0.5, 0.5):
        for jy in (-0.5, 0.5):
            px, py = xs_p.float() + jx, ys_p.float() + jy
            r = [(cam[3 + k] + px * cam[6 + k] + py * cam[9 + k]) - cam[k]
                 for k in range(3)]
            n = torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
            dirs.append([c / n for c in r])
    hits = 0
    for ti, lanes in enumerate(_tile_lanes(plan)):
        lanes = lanes[lanes[:, 9] >= 0]
        if not lanes.numel():
            continue
        tri = tuple(lanes[:, q][None] for q in range(9))
        near = lanes[:, tb.NEAR_ROW][None]
        rays = torch.arange(ti * tmk.RAY_TILE, (ti + 1) * tmk.RAY_TILE)
        for d in dirs:
            for ch in tmk._chunks(rays, lanes.shape[0]):
                o = tuple(cam[k].expand(ch.numel(), 1) for k in range(3))
                t, _, _ = tmk._mt(o, tuple(c[ch, None] for c in d), tri,
                                  1e-8, 0.0, tmk.F32_MAX)
                hit = t < tmk.F32_MAX
                hits += int(hit.sum())
                assert bool((t[hit] >= near.expand_as(t)[hit]).all()), (
                    f"tile {ti}: a hit in front of its bound")
    assert hits > 0


@pytest.mark.parametrize("chunk", [128, 256])
def test_plan_matches_jax(scenes, chunk):
    js, ts = scenes
    want = _jax_plan(js, chunk)
    got = _torch_plan(ts, chunk)
    assert got.chunk == want.chunk and got.total_chunks == want.total_chunks
    np.testing.assert_array_equal(got.meta.numpy(), np.asarray(want.meta))
    g = got.stream.numpy().reshape(-1, tb.CAND_ROWS, chunk)
    w = np.asarray(want.stream).reshape(-1, tb.CAND_ROWS, chunk)
    np.testing.assert_array_equal(g[:, :11], w[:, :11])
    # row 11: the grid slot of every live lane, whose id it holds
    ids = ts.accel.tri_index.reshape(-1).numpy()
    live = g[:, 9] >= 0
    slots = g[:, 11][live].astype(np.int64)
    np.testing.assert_array_equal(ids[slots], g[:, 9][live].astype(np.int64))
    np.testing.assert_array_equal(slots // ts.accel.block_size,
                                  g[:, 10][live].astype(np.int64))
    stats = tb.candidate_plan_stats(got, tmk.RAY_TILE)
    assert stats == jb.candidate_plan_stats(want, jmk.RAY_TILE)
    assert 0 < stats["nonempty_tiles"] < stats["tiles"]


def test_plan_is_conservative(scenes):
    """Every ray's flat-scan winner, at the four extreme jitters of
    [-0.5, 0.5] (the Wang range and the pixel center +0.5) and at the
    Wang jitter, is among its tile's candidates."""
    _, ts = scenes
    plan = _torch_plan(ts, 128)
    xs_p, ys_p = _torch_stream(ts)
    rows = tmk._scene_rows(ts, ts.accel)
    cam = rows.cam
    stream = plan.stream.reshape(plan.total_chunks, tb.CAND_ROWS, plan.chunk)
    meta = plan.meta.numpy()
    nt = meta.shape[0]
    cands = [set(stream[s:s + c, 9].reshape(-1).long().tolist()) - {-1}
             for s, c in meta[:, :2]]
    jitters = [(a, b) for a in (-0.5, 0.5) for b in (-0.5, 0.5)]
    work = torch.ones(nt, dtype=torch.bool)
    wang = tmk._primary_state(rows, xs_p, ys_p, 0, "wang", work)["bd"]
    winners = 0
    for jit in jitters + [None]:
        if jit is None:
            d = wang
        else:
            px = xs_p.float() + jit[0]
            py = ys_p.float() + jit[1]
            r = [(cam[3 + k] + px * cam[6 + k] + py * cam[9 + k]) - cam[k]
                 for k in range(3)]
            n = torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
            d = [c / n for c in r]
        o = [cam[k].expand(d[0].shape[0]) for k in range(3)]
        best = tmk._closest_plain(rows, o, d, torch.ones_like(d[0], dtype=bool),
                                  1e-8, 1e-4)
        ids = best.id.reshape(nt, tmk.RAY_TILE)
        for ti in range(nt):
            hit = set(ids[ti][ids[ti] >= 0].tolist())
            winners += len(hit)
            assert hit <= cands[ti], f"tile {ti} misses {hit - cands[ti]}"
    assert winners > 0


def test_refresh_stream_and_fingerprint(scenes):
    js, ts = scenes
    plan = _torch_plan(ts, 128)
    gids = tb.plan_candidate_gids(plan)
    torch.testing.assert_close(tb.refresh_stream(gids, ts.accel), plan.stream,
                               rtol=0, atol=0)
    jplan = _jax_plan(js, 128)
    jref = np.asarray(jb.refresh_stream(jb.plan_candidate_gids(jplan),
                                        js.accel, 1))
    np.testing.assert_array_equal(
        plan.stream.numpy().reshape(-1, tb.CAND_ROWS, 128)[:, :11],
        jref.reshape(-1, tb.CAND_ROWS, 128)[:, :11])
    # a gid the grid does not hold becomes a padding lane (never slot 0)
    bad = gids.clone()
    lane = int((bad[0] >= 0).nonzero()[0])
    bad[0, lane] = 10 ** 6
    rows = tb.refresh_stream(bad, ts.accel).reshape(-1, tb.CAND_ROWS, 128)
    assert float(rows[0, 9, lane]) == -1.0
    assert float(rows[0, :9, lane].abs().sum()) == 0.0
    # the fingerprint is exact: one moved vertex changes it, in a new
    # tensor or written in place
    key = tb.plan_fingerprint(ts.camera, ts.accel, tmk.RAY_TILE, 1, 128)
    assert key == tb.plan_fingerprint(ts.camera, ts.accel, tmk.RAY_TILE, 1,
                                      128)
    tri = ts.accel.tri.clone()
    tri[0, 0, 1] = torch.nextafter(tri[0, 0, 1], torch.tensor(1e9))
    moved = dataclasses.replace(ts.accel, tri=tri)
    moved_key = tb.plan_fingerprint(ts.camera, moved, tmk.RAY_TILE, 1, 128)
    assert moved_key != key
    tri[0, 0, 1] = torch.nextafter(tri[0, 0, 1], torch.tensor(1e9))
    assert tb.plan_fingerprint(ts.camera, moved, tmk.RAY_TILE, 1,
                               128) != moved_key


def test_plan_cache_is_keyed_exactly(scenes):
    """``resolve_candidate_plan`` returns the cached plan while the
    scene's camera and planes are the same tensors, unwritten; a new
    tensor or an in-place write builds a new plan."""
    from raytracinginonesemester_tpu_torch.render import renderer as tr

    _, ts = scenes
    plan = tr.resolve_candidate_plan(ts, "wang", 1)
    assert tr.resolve_candidate_plan(ts, "wang", 1) is plan
    assert tb.plan_matches_camera(plan, ts.camera)
    moved = dataclasses.replace(ts, accel=dataclasses.replace(
        ts.accel, tri=ts.accel.tri.clone()))
    other = tr.resolve_candidate_plan(moved, "wang", 1)
    assert other is not plan
    torch.testing.assert_close(other.stream, plan.stream, rtol=0, atol=0)
    assert tr.resolve_candidate_plan(moved, "wang", 1) is other
    moved.accel.tri.mul_(1.0)
    assert tr.resolve_candidate_plan(moved, "wang", 1) is not other


def test_binned_pair_count_is_live_lanes(scenes):
    """The binned walk's reported pairs are every live (id >= 0) lane of
    the tile's chunks, once per alive ray of the tile, as the kernels
    test them; padding lanes are not counted."""
    _, ts = scenes
    plan = _torch_plan(ts, 128)
    xs_p, ys_p = _torch_stream(ts)
    rows = tmk._scene_rows(ts, ts.accel)
    work = plan.meta[:, 1] > 0
    st = tmk._primary_state(rows, xs_p, ys_p, 0, "wang", work)
    alive = st["alive"] > 0.0
    best = tmk._closest_binned_plain(plan, st["bo"], st["bd"], alive, 1e-8,
                                     1e-4)
    stream = plan.stream.reshape(plan.total_chunks, tb.CAND_ROWS, plan.chunk)
    want = padded = 0
    for ti, (s, c) in enumerate(plan.meta[:, :2].tolist()):
        rays = int(alive[ti * tmk.RAY_TILE:(ti + 1) * tmk.RAY_TILE].sum())
        want += int((stream[s:s + c, 9] >= 0).sum()) * rays
        padded += c * plan.chunk * rays
    assert int(best.pairs) == want
    assert 0 < want < padded


def test_plan_of_another_camera_raises(scenes):
    _, ts = scenes
    plan = _torch_plan(ts, 128)
    cam = dataclasses.replace(ts.camera, center=ts.camera.center + 1e-3)
    other = dataclasses.replace(ts, camera=cam)
    xs, ys, _ = t_grid(W, H)
    with pytest.raises(ValueError, match="camera"):
        tmk.emit_tiles(other, xs, ys, 0, cand_plan=plan)
    wide = _torch_plan(ts, 128, 128, 64)  # 16 tiles, not 8
    with pytest.raises(ValueError, match="tile stream"):
        tmk.emit_tiles(ts, xs, ys, 0, cand_plan=wide)


def _state_views(st, rng):
    nt = st.shape[0] // 16
    return (np.asarray(st).reshape(nt, 16, -1),
            np.asarray(rng).reshape(nt, 8, -1)[:, 0])


@pytest.mark.parametrize("ranks", [1, 2, 4])
def test_pixel_stream_padding_matches_the_plan(scenes, ranks):
    """``pixel_stream`` for ``ranks`` data ranks holds one tile for each
    meta row of the plan resolved for as many ranks (whole groups for
    every rank): the frame's own swizzled pixels, then padding rays at
    pixel (0, 0); and that plan is the one built on this stream, ordered
    front to back."""
    from raytracinginonesemester_tpu_torch.render import renderer as tr

    _, ts = scenes
    xs, ys, n, (hp, wp) = tr.pixel_stream(W, H, ranks=ranks)
    plan = tr.resolve_candidate_plan(ts, "wang", 1, align_tiles=ranks)
    tiles = int(plan.meta.shape[0])
    group = tmk.GROUP_TILES * tmk.RAY_TILE * ranks
    assert xs.shape == ys.shape == (tiles * tmk.RAY_TILE,)
    assert xs.shape[0] == tmk.padded_rays(n, ranks)
    assert xs.shape[0] % group == 0 and 0 <= xs.shape[0] - n < group
    fx, fy, shape = t_grid(W, H)
    assert n == hp * wp == fx.shape[0] and (hp, wp) == shape
    assert torch.equal(xs[:n], fx) and torch.equal(ys[:n], fy)
    assert not xs[n:].any() and not ys[n:].any()
    want = tb.order_front_to_back(tb.build_camera_candidate_plan(
        ts.camera, xs, ys, ts.accel, tmk.RAY_TILE, chunk=tb.CHUNK), ts.camera)
    assert torch.equal(plan.meta, want.meta)
    assert torch.equal(plan.stream, want.stream)


@pytest.mark.parametrize("chunk", [128, 256])
def test_binned_emit_matches_flat_emit(scenes, chunk):
    """Alive flags and radiance everywhere, and the whole state and rng
    of every alive lane, equal the block walk's bit for bit (dead lanes
    of an empty-plan tile carry the canonical dead state)."""
    _, ts = scenes
    xs, ys, _ = t_grid(W, H)
    flat = _state_views(*tmk.emit_tiles(ts, xs, ys, 0))
    binned = _state_views(*tmk.emit_tiles(ts, xs, ys, 0,
                                          cand_plan=_torch_plan(ts, chunk)))
    (s0, r0), (s1, r1) = flat, binned
    np.testing.assert_array_equal(s0[:, 12], s1[:, 12])
    for row in (9, 10, 11):
        np.testing.assert_array_equal(s0[:, row], s1[:, row])
    alive = s0[:, 12] > 0.0
    assert alive.any()
    for row in range(13):
        np.testing.assert_array_equal(np.where(alive, s0[:, row], 0.0),
                                      np.where(alive, s1[:, row], 0.0))
    np.testing.assert_array_equal(np.where(alive, r0, 0), np.where(alive, r1, 0))


def test_binned_emit_matches_jax(scenes):
    js, ts = scenes
    jxs, jys, _ = j_grid(W, H)
    want_st, want_rng = jmk.emit_tiles(js, jxs, jys, 0, interpret=True,
                                       cand_plan=_jax_plan(js, 128))
    xs, ys, _ = t_grid(W, H)
    st, rng = tmk.emit_tiles(ts, xs, ys, 0, cand_plan=_torch_plan(ts, 128))
    a, ra = _state_views(st, rng)
    b, rb = _state_views(np.asarray(want_st), np.asarray(want_rng))
    np.testing.assert_array_equal(a[:, 12], b[:, 12])
    np.testing.assert_array_equal(rng.numpy(), np.asarray(want_rng))
    for row in range(16):
        ok = ulp_close(a[:, row], b[:, row], ulps=4, atol=EMIT_ATOL)
        assert ok.all(), (f"row {row}: {(~ok).sum()} elements, max diff "
                          f"{np.abs(a[:, row] - b[:, row]).max()}")


# --- on the card: the binned emit kernel against its plain version ----


@pytest.fixture
def cuda_scene(scenes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch_from_jax(scenes[0], device="cuda")


@pytest.mark.cuda
def test_cuda_binned_emit_matches_plain(cuda_scene):
    """Kernel and plain version share their op order: exact states."""
    ts = cuda_scene
    xs, ys, _ = t_grid(W, H, device="cuda")
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    plan = tb.build_camera_candidate_plan(ts.camera, xs_p, ys_p, ts.accel,
                                          tmk.RAY_TILE, chunk=128)
    rows = tmk._scene_rows(ts, ts.accel)
    tmk.reset_launch_counts()
    st, rng = tmk.emit_tiles(ts, xs_p, ys_p, 0, cand_plan=plan, rows=rows)
    pst, prng = tmk.emit_tiles_plain(rows, xs_p, ys_p, plan.meta[:, 1] > 0, 0,
                                     True, cand_plan=plan)
    torch.testing.assert_close(st, pst, rtol=0, atol=0)
    torch.testing.assert_close(rng, prng, rtol=0, atol=0)
    assert tmk.launch_counts()["emit"] == 1
