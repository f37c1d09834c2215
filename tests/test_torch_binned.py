"""The port's binned camera plan (``ops/binned.py``) and its binned emit.

The plan is built on the device with torch ops; its tile metadata and
stream rows 0-10 (planes, global id, home row) must equal the JAX
package's host build exactly, and row 11 must hold each candidate's
grid slot.  The binned emit must give the block walk's winners: alive
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


def test_plan_cache_is_keyed_exactly(scenes, monkeypatch):
    """``resolve_candidate_plan`` returns the cached plan while the
    scene's camera and planes are the same tensors, unwritten; a new
    tensor or an in-place write builds a new plan."""
    from raytracinginonesemester_tpu_torch.render import renderer as tr

    monkeypatch.setenv("RT_BINNED_CHUNK", "128")
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
