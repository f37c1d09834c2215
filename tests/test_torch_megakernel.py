"""Parity of the port's wavefront kernels (plain versions on the CPU)
with the JAX package's Pallas kernels in interpret mode, and of the CUDA
kernels with their plain versions on the card.

Tolerances.  Alive flags and rng rows must match exactly: they carry
every branch decision.  Float rows agree within 4 ulp or an absolute
1e-5, except the emit pass's, which agree within 4 ulp or 5e-5: XLA:CPU
evaluates the JAX kernels with FMA contraction, and the Moller-Trumbore
barycentrics of a hit are ill-conditioned (products of small cross-
product terms), so a last-ulp difference there moves u, v and the
interpolated normal by up to ~1e-5 relative, which the diffuse
throughput (albedo * 2 N.L) carries into the tp rows (measured max
2.5e-5 on this scene).  The later stages are fed the JAX emit state, so
their rows stay within the 1e-5 bound.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raytracinginonesemester_tpu.ops import megakernel as jmk
from raytracinginonesemester_tpu.ops.wavefront import bounce_tile_plan
from raytracinginonesemester_tpu.render.renderer import _swizzled_grid as j_grid
from raytracinginonesemester_tpu_torch.core import rng as rnglib
from raytracinginonesemester_tpu_torch.ops import binned
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


@pytest.fixture(scope="module")
def jax_emit(scenes):
    js, _ = scenes
    xs, ys, _ = j_grid(W, H)
    xs_p, ys_p, _, _ = jmk._pad_tiles(xs, ys)
    st, rng = jmk.emit_tiles(js, xs_p, ys_p, 0, interpret=True)
    return np.asarray(st), np.asarray(rng)


def _assert_state_close(got_st, got_rng, want_st, want_rng, atol):
    nt = want_st.shape[0] // 16
    a = np.asarray(got_st).reshape(nt, 16, -1)
    b = np.asarray(want_st).reshape(nt, 16, -1)
    np.testing.assert_array_equal(a[:, 12], b[:, 12])  # alive
    np.testing.assert_array_equal(np.asarray(got_rng), np.asarray(want_rng))
    for r in range(16):
        ok = ulp_close(a[:, r], b[:, r], ulps=4, atol=atol)
        assert ok.all(), (f"row {r}: {(~ok).sum()} elements, max diff "
                          f"{np.abs(a[:, r] - b[:, r]).max()}")


def test_emit_matches_jax(scenes, jax_emit):
    _, ts = scenes
    xs, ys, _ = t_grid(W, H)
    st, rng = tmk.emit_tiles(ts, xs, ys, 0)
    want_st, want_rng = jax_emit
    assert st.shape == want_st.shape and rng.shape == want_rng.shape
    _assert_state_close(st, rng, want_st, want_rng, EMIT_ATOL)
    alive = want_st.reshape(-1, 16, tmk.RAY_TILE)[:, 12]
    assert 0 < alive.sum() < alive.size  # the test frame bounces and dies


def test_emit_has_work_matches_jax_plan(scenes):
    js, ts = scenes
    xs, ys, _ = j_grid(128, 64)
    xs_p, ys_p, _, _ = jmk._pad_tiles(xs, ys)
    _, j_entry = jmk.camera_tile_plan(js.camera, xs_p, ys_p, js.accel,
                                      jmk.RAY_TILE)
    txs, tys, _ = t_grid(128, 64)
    txs_p, tys_p, _, _ = tmk._pad_tiles(txs, tys)
    _, t_entry = tmk.camera_tile_plan(ts.camera, txs_p, tys_p, ts.accel)
    j_work = np.isfinite(np.asarray(j_entry)[:, 0])
    np.testing.assert_array_equal(torch.isfinite(t_entry[:, 0]).numpy(), j_work)
    assert not j_work.all()  # the frame has sky-only tiles


def test_bounce_step_cross_fed_from_jax_emit(scenes, jax_emit):
    js, ts = scenes
    st, rng = jax_emit
    order, entry = bounce_tile_plan(jnp.asarray(st), js.accel)
    want = jmk.bounce_step_tiles(js, jnp.asarray(st), jnp.asarray(rng),
                                 order, entry, interpret=True)
    got = tmk.bounce_step_tiles(ts, torch.from_numpy(st), torch.from_numpy(rng))
    _assert_state_close(got[0], got[1], want[0], want[1], 1e-5)


def test_resume_cross_fed_from_jax_emit(scenes, jax_emit):
    js, ts = scenes
    st, rng = jax_emit
    want = jmk.resume_tiles(js, jnp.asarray(st), jnp.asarray(rng),
                            interpret=True)
    got = tmk.resume_tiles(ts, torch.from_numpy(st), torch.from_numpy(rng))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert ulp_close(g.numpy(), np.asarray(w), ulps=4, atol=1e-5).all()


def test_cpu_tensors_take_the_plain_version(scenes, jax_emit):
    """On the CPU a wrapper calls its plain version and counts no launch."""
    _, ts = scenes
    st, rng = (torch.from_numpy(a) for a in jax_emit)
    tmk.reset_launch_counts()
    got = tmk.bounce_step_tiles(ts, st, rng)
    rows = tmk._scene_rows(ts, ts.accel)
    plain = tmk.bounce_step_tiles_plain(rows, st, rng, ts.diffuse_bounce)
    torch.testing.assert_close(got[0], plain[0], rtol=0, atol=0)
    assert tmk.launch_counts() == {"emit": 0, "bounce_step": 0, "resume": 0,
                                   "render": 0}


def test_wrappers_check_their_inputs(scenes, jax_emit):
    _, ts = scenes
    st, rng = (torch.from_numpy(a) for a in jax_emit)
    with pytest.raises(ValueError):
        tmk.bounce_step_tiles(ts, st.double(), rng)
    with pytest.raises(ValueError):
        tmk.resume_tiles(ts, st, rng[:8])
    with pytest.raises(ValueError, match="dialect"):
        tmk.bounce_step_tiles(ts, st, rng, dialect="cpuonly")


def test_plain_pair_counts_follow_the_kernel_walk(scenes):
    """The pairs a plain version reports are the Moller-Trumbore tests
    the CUDA kernels make: live lanes of every block a ray's slab test
    passes, and a shadow walk that stops at its first hit (emulated here
    ray by ray, lane by lane in block order)."""
    _, ts = scenes
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = t_grid(W, H)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    work = torch.ones(xs_p.numel() // tmk.RAY_TILE, dtype=torch.bool)
    st = tmk._primary_state(rows, xs_p, ys_p, 0, "wang", work)
    alive = st["alive"] > 0.0
    best = tmk._closest_plain(rows, st["bo"], st["bd"], alive, 1e-8, 1e-4)
    hit = (best.t < tmk.F32_MAX).nonzero().squeeze(1)[::7][:64]
    p = tuple(o[hit] + 0.999 * best.t[hit] * d[hit]
              for o, d in zip(st["bo"], st["bd"]))
    to = [rows.lights[0, k] - p[k] for k in range(3)]
    dist = torch.sqrt(to[0] * to[0] + to[1] * to[1] + to[2] * to[2])
    ld = tuple(c / dist for c in to)
    facing = torch.ones_like(dist, dtype=torch.bool)
    blocked, pairs = tmk._occluded_plain(rows, p, ld, dist, facing, 1e-8,
                                         1e-4)

    want_pairs, want_blocked, full = 0, [], 0
    for i in range(hit.numel()):
        pi = tuple(c[i:i + 1] for c in p)
        di = tuple(c[i:i + 1] for c in ld)
        inv = tuple(1.0 / c for c in di)
        tmin = torch.full((1,), 1e-4)
        stop = False
        for b in range(rows.num_blocks):
            if not bool(tmk._slab(rows.aabb[b], pi, inv, tmin, dist[i:i + 1])):
                continue
            tri = tuple(rows.tri[k, b][None, :] for k in range(9))
            t, _, _ = tmk._mt(tuple(c[:, None] for c in pi),
                              tuple(c[:, None] for c in di), tri, 1e-8, 1e-4,
                              dist[i:i + 1, None])
            live = (rows.ids[b] >= 0).numpy()
            full += int(live.sum())
            for j in np.flatnonzero(live):
                want_pairs += 1
                if float(t[0, j]) < tmk.F32_MAX:
                    stop = True
                    break
            if stop:
                break
        want_blocked.append(stop)
    assert blocked.tolist() == want_blocked
    assert 0 < sum(want_blocked) < len(want_blocked)
    assert int(pairs) == want_pairs < full

    # closest hit: every live lane of each block whose slab test passes
    # against the ray's running best t
    sub = torch.arange(0, alive.numel(), 97)
    o = tuple(c[sub] for c in st["bo"])
    d = tuple(c[sub] for c in st["bd"])
    got = tmk._closest_plain(rows, o, d, alive[sub], 1e-8, 1e-4)
    want = 0
    for i in range(sub.numel()):
        oi = tuple(c[i:i + 1] for c in o)
        di = tuple(c[i:i + 1] for c in d)
        inv = tuple(1.0 / c for c in di)
        best_t = torch.full((1,), tmk.F32_MAX)
        for b in range(rows.num_blocks):
            if not bool(tmk._slab(rows.aabb[b], oi, inv,
                                  torch.full((1,), 1e-4), best_t)):
                continue
            live = rows.ids[b][None, :] >= 0
            want += int(live.sum())
            tri = tuple(rows.tri[k, b][None, :] for k in range(9))
            t, _, _ = tmk._mt(tuple(c[:, None] for c in oi),
                              tuple(c[:, None] for c in di), tri, 1e-8, 1e-4,
                              best_t[:, None])
            best_t = torch.minimum(best_t,
                                   torch.where(live, t, tmk.F32_MAX).amin())
    assert bool(alive[sub].all())
    assert int(got.pairs) == want > 0


# --- kernel B's warp-cooperative walks, emulated on the CPU -----------

_LANES = 32


def _key_less(t, i, j, t2, i2, j2):
    return (t < t2) | ((t == t2) & ((i < i2) | ((i == i2) & (j < j2))))


def _coop_closest(rows, o, d, alive, det_eps, tmin):
    """``closest_coop`` of ``csrc/megakernel.cu``, emulated for every ray
    at once: each ray gates the blocks in order 0..L-1 against its
    running best t; a passing block's triangles are all tested at the
    block-start best t, lane l taking slots l, l + 32, ... with a
    sequential take in ascending slot, the xor tree (16, 8, 4, 2, 1)
    keeps the lexicographic (t, id, slot) minimum on every lane, and the
    ray takes it by the take rule, u and v from the winner's lane.
    ``tmin``: a float or a per-ray (R,) tensor."""
    r, dev, bs = d[0].shape[0], d[0].device, rows.block_size
    inv = tuple(1.0 / c for c in d)
    best = tmk._Best(r, dev)
    tmin_t = tmin if torch.is_tensor(tmin) else torch.full((r,), tmin)
    big = torch.iinfo(torch.int64).max
    rounds = -(-bs // _LANES)
    lane = torch.arange(_LANES)
    for b in range(rows.num_blocks):
        sub = (tmk._slab(rows.aabb[b], o, inv, tmin_t, best.t)
               & alive).nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        n = sub.numel()
        ids = rows.ids[b].to(torch.int64)
        t, u, v = tmk._mt(tuple(c[sub, None] for c in o),
                          tuple(c[sub, None] for c in d),
                          tuple(rows.tri[k, b][None, :] for k in range(9)),
                          det_eps,
                          tmin_t[sub, None] if torch.is_tensor(tmin) else tmin,
                          best.t[sub, None])
        lt = torch.full((n, _LANES), tmk.F32_MAX)
        lu, lv = torch.zeros(n, _LANES), torch.zeros(n, _LANES)
        li = torch.full((n, _LANES), big)
        lj = torch.full((n, _LANES), big)
        for i in range(rounds):  # each lane's slots in ascending order
            j = i * _LANES + lane
            ok = j < bs
            jj = torch.where(ok, j, 0)
            ti, ii = t[:, jj], ids[jj][None, :].expand(n, -1)
            take = ok[None, :] & (ii >= 0) & (ti < tmk.F32_MAX) & (
                (ti < lt) | ((ti == lt) & (ii < li)))
            lt = torch.where(take, ti, lt)
            lu = torch.where(take, u[:, jj], lu)
            lv = torch.where(take, v[:, jj], lv)
            li = torch.where(take, ii, li)
            lj = torch.where(take, jj[None, :].expand(n, -1), lj)
        for off in (16, 8, 4, 2, 1):  # every lane keeps the smaller key
            x = lane ^ off
            sw = _key_less(lt[:, x], li[:, x], lj[:, x], lt, li, lj)
            lt = torch.where(sw, lt[:, x], lt)
            li = torch.where(sw, li[:, x], li)
            lj = torch.where(sw, lj[:, x], lj)
        assert (lt == lt[:, :1]).all() and (lj == lj[:, :1]).all()
        wt, wi, wj = lt[:, 0], li[:, 0], lj[:, 0]
        src = torch.where(wj == big, 0, wj % _LANES)
        rr = torch.arange(n)
        old_t, old_id = best.t[sub], best.id[sub]
        old_key = torch.where(old_id >= 0, old_id, tmk._INT_MAX)
        take = (wt < tmk.F32_MAX) & ((wt < old_t) | ((wt == old_t)
                                                     & (wi < old_key)))
        best.t[sub] = torch.where(take, wt, old_t)
        best.u[sub] = torch.where(take, lu[rr, src], best.u[sub])
        best.v[sub] = torch.where(take, lv[rr, src], best.v[sub])
        best.id[sub] = torch.where(take, wi, old_id)
        best.slot[sub] = torch.where(take, b * bs + wj, best.slot[sub])
    return best


def _coop_occluded(rows, p, ld, dist, facing, det_eps, shadow_tmin,
                   tmax=None):
    """``occluded_coop``, emulated: each facing ray gates the blocks in
    order on [shadow_tmin, dist]; the warp tests a passing block 128
    triangles (4 a lane) between votes and the ray leaves the walk at
    the first block holding a blocker.  -> (blocked, tests made)."""
    tmax = dist if tmax is None else tmax
    inv = tuple(1.0 / c for c in ld)
    bs = rows.block_size
    tmin_t = (shadow_tmin if torch.is_tensor(shadow_tmin)
              else torch.full_like(dist, shadow_tmin))
    blocked = torch.zeros_like(facing)
    tests = 0
    for b in range(rows.num_blocks):
        sub = (tmk._slab(rows.aabb[b], p, inv, tmin_t, dist)
               & facing & ~blocked).nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        t, _, _ = tmk._mt(tuple(c[sub, None] for c in p),
                          tuple(c[sub, None] for c in ld),
                          tuple(rows.tri[k, b][None, :] for k in range(9)),
                          det_eps, tmin_t[sub, None], tmax[sub, None])
        hit = (rows.ids[b] >= 0)[None, :] & (t < tmk.F32_MAX)
        done = torch.zeros(sub.numel(), dtype=torch.bool)
        for j0 in range(0, bs, 4 * _LANES):  # a vote every 128 slots
            live = ~done
            tests += int(live.sum()) * min(4 * _LANES, bs - j0)
            done = done | hit[:, j0:j0 + 4 * _LANES].any(dim=1)
        blocked[sub] = done
    return blocked, torch.tensor(tests)


@pytest.mark.parametrize("dialect", ["gpu", "cpuonly"])
@pytest.mark.parametrize("block_size", [128, 512])
def test_cooperative_walk_matches_the_plain_walk(block_size, dialect,
                                                 monkeypatch):
    """Kernel B's warp-cooperative walks give the winners, t, u, v, the
    shadow flags, and so every state, rng and oracle row of the plain
    version's sequential walk, bit for bit: two-frog 64x32 after a
    diffuse bounce (the emit state), at 128- and 512-triangle blocks."""
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    monkeypatch.setenv("RT_BLOCK_SIZE", str(block_size))
    ts = build_scene(two_frog_config(SceneConfig, SceneNodeConfig, Transform,
                                     width=W, height=H, dialect=dialect),
                     device="cpu")
    kw = tmk.megakernel_kwargs(ts, "wang")
    pkw = {k: v for k, v in kw.items() if k != "jitter"}
    rows = tmk._scene_rows(ts, ts.accel)
    assert rows.block_size == block_size
    xs, ys, _ = t_grid(W, H)
    st, rng = tmk.emit_tiles(ts, xs, ys, 0, **kw)
    gpu = dialect == "gpu"

    flat = tmk._unpack(st, rng)
    alive = flat["alive"] > 0.0
    o = tuple(torch.where(alive, c, torch.tensor(1e30)) for c in flat["bo"])
    eps = pkw.get("det_eps", 1e-8)
    want = tmk._closest_plain(rows, o, flat["bd"], alive, eps, 1e-4)
    got = _coop_closest(rows, o, flat["bd"], alive, eps, 1e-4)
    for k in ("t", "u", "v", "id", "slot"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    assert 0 < int((want.t < tmk.F32_MAX).sum()) < int(alive.sum())

    def step():
        return tmk.bounce_step_tiles_plain(rows, st, rng, ts.diffuse_bounce,
                                           diff_out=gpu, **pkw)

    want = step()
    blocked = []
    real_occ = tmk._occluded_plain

    def coop_occ(*a, **k):
        b, tests = _coop_occluded(*a, **k)
        assert torch.equal(b, real_occ(*a, **k)[0])
        blocked.append(int(b.sum()))
        return b, tests

    monkeypatch.setattr(tmk, "_closest_plain", _coop_closest)
    monkeypatch.setattr(tmk, "_occluded_plain", coop_occ)
    got = step()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sum(blocked) > 0  # the shadow walks found blockers


# --- kernel A's walks, emulated on the CPU ----------------------------


_SPLIT = 4  # kEmitSplit: the threads of a ray in emit's closest walk


def _cta_closest_binned(cand_plan, o, d, alive, det_eps, tmin, chunks=None,
                        split=_SPLIT):
    """``closest_binned_cta<split>`` of ``csrc/megakernel.cu``, emulated
    for every tile at once: the tile's chunks in order, each chunk's
    candidates four at a time (a width that is not a multiple of 4 ends
    one at a time), group g to the ray's thread g % split, which tests it
    at the window its own running best t had before it and takes it in
    order by the (t, id) rule (a take in order keeps the group's first
    (t, id) minimum, which is what is taken here); the ray's threads then
    keep the first (t, id) minimum in walk order.  A warp (32 // split
    rays) skips a chunk when each of its rays' best t (the least of its
    threads') is below the chunk's near bound (row 12 of lane 0);
    ``chunks`` grows by the warp-chunks scheduled and tested, as
    ``_torch_parity.warp_chunk_counts`` counts them."""
    r, dev = d[0].shape[0], d[0].device
    best = tmk._Best(r, dev)
    c = cand_plan.chunk
    stream = cand_plan.stream.reshape(cand_plan.total_chunks, tmk.CAND_ROWS, c)
    meta = cand_plan.meta[:, :2].to(torch.int64)
    nt = meta.shape[0]
    tiles = [t for t in range(nt)
             if meta[t, 1] > 0 and bool(alive[t * tmk.RAY_TILE:(t + 1)
                                              * tmk.RAY_TILE].any())]
    rays = torch.cat([t * tmk.RAY_TILE + alive[t * tmk.RAY_TILE:(t + 1)
                                               * tmk.RAY_TILE].nonzero()
                      .squeeze(1) for t in tiles])
    tile_of = rays // tmk.RAY_TILE
    oc = tuple(x[rays, None] for x in o)
    dc = tuple(x[rays, None] for x in d)
    warp_rays = _LANES // split
    warps = tmk.RAY_TILE // warp_rays  # a tile's
    counts = torch.zeros(2, dtype=torch.int64)
    quads = c // 4 * 4
    groups = [(j, 4, (j // 4) % split) for j in range(0, quads, 4)]
    groups += [(j, 1, (j - quads) % split) for j in range(quads, c)]
    n = rays.numel()
    bt = torch.full((split, n), tmk.F32_MAX)
    bu, bv = torch.zeros(split, n), torch.zeros(split, n)
    bi = torch.full((split, n), -1, dtype=torch.int64)
    bs = torch.zeros(split, n, dtype=torch.int64)
    bp = torch.full((split, n), tmk._INT_MAX, dtype=torch.int64)
    for k in range(int(meta[tiles, 1].max())):
        on = (k < meta[tile_of, 1]).nonzero().squeeze(1)  # a k-th chunk
        # the warps' votes: a warp skips the chunk when each of its rays
        # (a dead ray's best t is F32_MAX) has a best t below its bound
        bound = stream[meta[tile_of[on], 0] + k, binned.NEAR_ROW, 0]
        front = (bt[:, on].amin(dim=0) < bound).to(torch.int64)
        warp = rays[on] // warp_rays
        behind = torch.zeros(r // warp_rays, dtype=torch.int64).index_add_(
            0, warp, front) == warp_rays
        walked = [t for t in tiles if k < meta[t, 1]]
        counts[0] += len(walked) * warps
        counts[1] += len(walked) * warps - int(behind.sum())
        on = on[~behind[warp]]
        rows = stream[meta[tile_of[on], 0] + k]  # (n, 16, c)
        # t, u, v do not depend on the window: test the chunk once
        # without one, then apply each group's window to t
        t, u, v = tmk._mt(tuple(x[on] for x in oc), tuple(x[on] for x in dc),
                          tuple(rows[:, q] for q in range(9)), det_eps, tmin,
                          float("inf"))
        ids = torch.round(rows[:, 9]).to(torch.int64)
        slots = torch.round(rows[:, 11]).to(torch.int64)
        ok = (ids >= 0) & (t < tmk.F32_MAX)
        rr = torch.arange(on.numel())
        for j, m, sb in groups:
            g = slice(j, j + m)
            old_t, old_i = bt[sb, on], bi[sb, on]
            tq = torch.where(ok[:, g] & (t[:, g] <= old_t[:, None]), t[:, g],
                             tmk.F32_MAX)
            tm = tq.amin(dim=1)
            idk = torch.where((tq == tm[:, None]) & (tq < tmk.F32_MAX),
                              ids[:, g], tmk._INT_MAX)
            wid, q = idk.min(dim=1)
            q = q + j
            key = torch.where(old_i >= 0, old_i, tmk._INT_MAX)
            take = (tm < tmk.F32_MAX) & ((tm < old_t) | ((tm == old_t)
                                                         & (wid < key)))
            bt[sb, on] = torch.where(take, tm, old_t)
            bu[sb, on] = torch.where(take, u[rr, q], bu[sb, on])
            bv[sb, on] = torch.where(take, v[rr, q], bv[sb, on])
            bi[sb, on] = torch.where(take, wid, old_i)
            bs[sb, on] = torch.where(take, slots[rr, q], bs[sb, on])
            bp[sb, on] = torch.where(take, k * c + q, bp[sb, on])
    # the ray's threads' first (t, id, place) minimum
    w = torch.zeros(n, dtype=torch.int64)
    for sb in range(1, split):
        cur = (bt[w, torch.arange(n)], bi[w, torch.arange(n)],
               bp[w, torch.arange(n)])
        ki = lambda i: torch.where(i >= 0, i, tmk._INT_MAX)
        less = _key_less(bt[sb], ki(bi[sb]), bp[sb], cur[0], ki(cur[1]),
                         cur[2])
        w = torch.where(less, sb, w)
    ar = torch.arange(n)
    best.t[rays], best.u[rays], best.v[rays] = bt[w, ar], bu[w, ar], bv[w, ar]
    best.id[rays], best.slot[rays] = bi[w, ar], bs[w, ar]
    if chunks is not None:
        chunks += counts
    return best


@pytest.mark.parametrize("dialect", ["gpu", "cpuonly"])
@pytest.mark.parametrize("block_size,chunk", [(128, None), (512, 126)])
def test_emit_walks_match_the_plain_walk(block_size, chunk, dialect,
                                             monkeypatch):
    """Kernel A's walks give every state and rng row of the plain
    version's sequential walk, bit for bit: at 512-triangle blocks the
    binned walk of staged chunks split over a ray's four threads (four
    candidates a window; a chunk width of 126 ends with two one at a
    time) on a plan ordered front to back, its warps skipping the chunks
    behind their rays' hits (the warp-chunks it schedules and tests are
    the plain count's, and some are skipped), at 128 the flat walk
    (``closest_coop``), and at both the shadow rays listed and the list
    walked 8 rays to a warp by ``occluded_coop``.  Two-frog 48x24 through a
    135 mm lens (a tile sees part of the frog: ~12k candidates, not the
    whole mesh); cpuonly with an area light of radius 0.15 and 2 disk
    samples, so each sample's rays are a list of their own."""
    import dataclasses

    from raytracinginonesemester_tpu_torch.ops import binned
    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import (counting_binned_walk, list_occluded,
                               two_frog_config)

    monkeypatch.setenv("RT_BLOCK_SIZE", str(block_size))
    cfg = dataclasses.replace(
        two_frog_config(SceneConfig, SceneNodeConfig, Transform, width=48,
                        height=24, dialect=dialect), focal_length_mm=135.0)
    samples = 2 if dialect == "cpuonly" else 1
    if dialect == "cpuonly":
        cfg = dataclasses.replace(cfg, lights=[
            {**l, "radius": 0.15, "shadow_samples": samples}
            for l in cfg.lights])
    ts = build_scene(cfg, device="cpu")
    rows = tmk._scene_rows(ts, ts.accel)
    assert rows.block_size == block_size
    xs, ys, _ = t_grid(48, 24)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    pkw = {k: v for k, v in tmk.megakernel_kwargs(ts, "wang").items()
           if k != "jitter"}
    plan = chunk and binned.order_front_to_back(
        binned.build_camera_candidate_plan(ts.camera, xs_p, ys_p, ts.accel,
                                           tmk.RAY_TILE, chunk=chunk),
        ts.camera)
    sh = tmk._Shade(ts.diffuse_bounce, dialect=dialect,
                    shadow_samples=samples)
    work = tmk._has_work(ts, xs_p, ys_p, sh, None, plan)

    def emit():
        return tmk.emit_tiles_plain(rows, xs_p, ys_p, work, 0,
                                    ts.diffuse_bounce, cand_plan=plan, **pkw)

    counts = [torch.zeros(2, dtype=torch.int64) for _ in range(2)]

    shadows = []
    real_occ = tmk._occluded_plain

    def walk(*a, **k):
        got = list_occluded(*a, **k)
        assert torch.equal(got[0], real_occ(*a, **k)[0])
        shadows.append((int(a[4].sum()), int(got[0].sum())))
        return got

    monkeypatch.setattr(tmk, "_closest_binned_plain", counting_binned_walk(
        tmk._closest_binned_plain, counts[0]))
    want = emit()
    monkeypatch.setattr(tmk, "_closest_binned_plain",
                        lambda *a: _cta_closest_binned(*a, chunks=counts[1]))
    monkeypatch.setattr(tmk, "_closest_plain", _coop_closest)
    monkeypatch.setattr(tmk, "_occluded_plain", walk)
    got = emit()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert len(shadows) == samples * rows.lights.shape[0]
    assert all(f > 0 for f, _ in shadows) and sum(b for _, b in shadows) > 0
    assert torch.equal(counts[0], counts[1])
    if plan:
        assert 0 < int(counts[0][1]) < int(counts[0][0])


# --- kernel A's soft groups, emulated on the CPU --------------------


def _group_vote():
    """``kGroupVote`` of ``csrc/megakernel.cu``: the triangles a lane of
    a group walk tests between the warp's votes."""
    import re

    from _torch_parity import REPO

    path = os.path.join(REPO, "raytracinginonesemester_tpu_torch", "csrc",
                        "megakernel.cu")
    with open(path) as f:
        text = f.read()
    return int(re.search(r"constexpr int kGroupVote = (\d+);", text)
               .group(1))


def _mt_from(p, d, tri, det_eps, tmin, tmax):
    """``tri_from`` and ``mt_from``, emulated: Moller-Trumbore's origin
    terms (tvec, qvec, e2 . qvec) of (G,) points against (B,) triangles
    made once, then each of the (G, S) directions tested against them on
    [tmin, tmax] -> (G, S, B) hits."""
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    tvx = p[0][:, None] - v0x
    tvy = p[1][:, None] - v0y
    tvz = p[2][:, None] - v0z
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    tq = e2x * qvx + e2y * qvy + e2z * qvz
    tvx, tvy, tvz, qvx, qvy, qvz, tq = (x[:, None, :] for x in (
        tvx, tvy, tvz, qvx, qvy, qvz, tq))
    dx, dy, dz = (d[..., c, None] for c in range(3))
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det.abs() < det_eps, 1.0, det)
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = tq * inv_det
    return ((det.abs() >= det_eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
            & (u + v <= 1.0) & (t >= tmin) & (t <= tmax[..., None]))


def _group_walk(rows, sh, p, rays, facing, listed=None, seen=None):
    """``list_group`` and ``walk_groups`` of ``csrc/megakernel.cu``,
    emulated with the signature of ``megakernel._soft_walks_plain`` ->
    (blocked a sample, tests made).

    The listing: each sample's slab tests on [shadow_tmin, d_s] against
    every block, for the facing rays; a ray some of whose samples pass is
    one group, those samples its walks (``listed`` receives a mask a
    sample).  The walk: a group's samples 32 at a time (a sample a
    lane), drawn once in draw order (``rays``); the union of the blocks
    their slab tests pass in ascending order, a sample entering a block
    where its own test passes and it is not blocked yet; in a block the
    triangles' origin terms made once and tested against every entering
    sample (``_mt_from``; a tmax of F32_MAX and above tests below it,
    ``group_tmax``), kGroupVote * 32 triangles between votes, a sample
    blocked at a vote leaving the walk.  ``seen`` receives the groups,
    walks, blocked samples and passes of each call."""
    n_s, n_b, bs = len(rays), rows.num_blocks, rows.block_size
    vote = 32 * _group_vote()
    tmin = torch.full_like(rays[0][1], sh.shadow_tmin)
    slabs = torch.stack([
        tmk._slab(rows.aabb.T[:, None, :], tuple(c[:, None] for c in p),
                  tuple((1.0 / c)[:, None] for c in sd), tmin[:, None],
                  d_s[:, None]) & facing[:, None]
        for sd, d_s, _ in rays], dim=1)  # (R, S, L)
    walks = slabs.any(dim=2)
    if listed is not None:
        listed.extend(walks.unbind(1))
    g = walks.any(dim=1).nonzero().squeeze(1)
    pg = tuple(c[g] for c in p)
    d = torch.stack([torch.stack(sd, dim=1) for sd, _, _ in rays], 1)[g]
    tmax = torch.stack([tm for _, _, tm in rays], dim=1)[g]
    below = torch.nextafter(torch.tensor(tmk.F32_MAX), torch.tensor(0.0))
    tmax = torch.where(tmax >= tmk.F32_MAX, below, tmax)
    blocked = torch.zeros(walks.shape, dtype=torch.bool)
    tests, passes = 0, 0
    for k0 in range(0, n_s, 32):  # a sample a lane
        passes += 1
        ks = slice(k0, min(k0 + 32, n_s))
        live = torch.ones(g.numel(), ks.stop - k0, dtype=torch.bool)
        for b in range(n_b):
            enter = live & slabs[g, ks, b]
            sub = enter.any(dim=1).nonzero().squeeze(1)
            if sub.numel() == 0:
                continue
            hit = _mt_from(tuple(c[sub] for c in pg), d[sub, ks],
                           tuple(rows.tri[k, b] for k in range(9)),
                           sh.det_eps, sh.shadow_tmin, tmax[sub, ks])
            # the split changes no bit: mt's hits, pair for pair
            t, _, _ = tmk._mt(tuple(c[sub, None, None] for c in pg),
                              tuple(d[sub, ks, c, None] for c in range(3)),
                              tuple(rows.tri[k, b] for k in range(9)),
                              sh.det_eps, sh.shadow_tmin,
                              tmax[sub, ks, None])
            assert torch.equal(hit, t < tmk.F32_MAX)
            hit = hit & (rows.ids[b] >= 0)
            into = enter[sub]
            for j0 in range(0, bs, vote):  # the votes
                tests += int(into.sum()) * min(vote, bs - j0)
                into = into & ~hit[:, :, j0:j0 + vote].any(dim=2)
            live[sub] = live[sub] & ~(enter[sub] & ~into)
        blocked[g, ks] = ~live & walks[g, ks]
    if seen is not None:
        seen.append(dict(groups=g.numel(), walks=int(walks.sum()),
                         blocked=int(blocked.sum()), passes=passes))
    return list(blocked.unbind(1)), torch.tensor(tests)


def _soft_two_frog(samples, point, block_size, monkeypatch):
    """Two-frog 48x24 through a 135 mm lens, cpuonly, its two lights of
    radius 0.15 with ``samples`` disk samples (or the second a point
    light) -> (scene, rows, padded xs, ys, the plain kwargs, has_work)."""
    import dataclasses

    from raytracinginonesemester_tpu_torch.scene.build import build_scene
    from raytracinginonesemester_tpu_torch.scene.config import (
        SceneConfig, SceneNodeConfig)
    from raytracinginonesemester_tpu_torch.scene.transform import Transform

    from _torch_parity import two_frog_config

    monkeypatch.setenv("RT_BLOCK_SIZE", str(block_size))
    cfg = dataclasses.replace(
        two_frog_config(SceneConfig, SceneNodeConfig, Transform, width=48,
                        height=24, dialect="cpuonly"), focal_length_mm=135.0)
    radii = (0.15, 0.0 if point else 0.15)
    cfg = dataclasses.replace(cfg, lights=[
        {**l, "radius": r, "shadow_samples": samples}
        for l, r in zip(cfg.lights, radii)])
    ts = build_scene(cfg, device="cpu")
    rows = tmk._scene_rows(ts, ts.accel)
    assert rows.block_size == block_size
    xs, ys, _ = t_grid(48, 24)
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    pkw = {k: v for k, v in tmk.megakernel_kwargs(ts, "wang").items()
           if k != "jitter"}
    assert pkw["shadow_samples"] == samples
    sh = tmk._Shade(ts.diffuse_bounce, dialect="cpuonly",
                    shadow_samples=samples)
    work = tmk._has_work(ts, xs_p, ys_p, sh, None, None)
    return ts, rows, xs_p, ys_p, pkw, work


@pytest.mark.parametrize("samples,point,block_size", [
    (17, False, 512), (32, False, 128), (40, False, 512), (32, True, 512)])
def test_emit_groups_match_the_plain_walk(samples, point, block_size,
                                          monkeypatch):
    """Kernel A's soft groups (an area light's disk samples of a hit
    listed as one entry and walked together, lanes over the triangles)
    give every state and rng row of the plain version's walks, one sample
    at a time, bit for bit, and list the same walks and groups
    (``stats``): two-frog 48x24 through a 135 mm lens, cpuonly, its two
    lights of radius 0.15 with 17, 32 or 40 disk samples (40: each group
    walks in two passes of 32), or an area light and a point light
    together, whose walks are listed one at a time and walked as
    ``list_occluded`` walks them."""
    from _torch_parity import list_occluded

    ts, rows, xs_p, ys_p, pkw, work = _soft_two_frog(samples, point,
                                                     block_size, monkeypatch)
    radii = (0.15, 0.0 if point else 0.15)

    def emit(stats):
        return tmk.emit_tiles_plain(rows, xs_p, ys_p, work, 0,
                                    ts.diffuse_bounce, stats=stats, **pkw)

    want_stats = {}
    want = emit(want_stats)
    seen, singles = [], []
    real_occ = tmk._occluded_plain

    def groups(rows_, sh_, p, rays, facing, listed=None):
        got = _group_walk(rows_, sh_, p, rays, facing, listed, seen)
        for a, (sd, d_s, tmax) in zip(got[0], rays):  # a sample alone
            assert torch.equal(a, real_occ(rows_, p, sd, d_s, facing,
                                           sh_.det_eps, sh_.shadow_tmin,
                                           tmax)[0])
        return got

    def single(*a, **k):
        got = list_occluded(*a, **{x: y for x, y in k.items()
                                   if x != "listed"})
        assert torch.equal(got[0], real_occ(*a, **k)[0])  # lists it
        singles.append(int(got[0].sum()))
        return got

    monkeypatch.setattr(tmk, "_soft_walks_plain", groups)
    monkeypatch.setattr(tmk, "_occluded_plain", single)
    got_stats = {}
    got = emit(got_stats)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert [got_stats[k] for k in ("walks", "groups")] == [
        want_stats[k] for k in ("walks", "groups")]
    assert len(seen) == len(radii) - point and len(singles) == point
    assert sum(x["groups"] for x in seen) == want_stats["groups"] > 0
    assert sum(x["walks"] for x in seen) <= want_stats["walks"]
    assert sum(x["blocked"] for x in seen) > 0
    assert all(x["passes"] == -(-samples // 32) for x in seen)
    # a group is at most its samples' walks, and lists at least one
    assert (want_stats["groups"] <= sum(x["walks"] for x in seen)
            <= samples * want_stats["groups"])


@pytest.mark.parametrize("samples,point", [
    (17, False), (32, False), (64, False), (32, True)])
def test_bounce_groups_match_the_plain_walk(samples, point, monkeypatch):
    """Kernels B's and C's soft groups (``group_visibility``: an area
    light's disk samples of a hit walked together, lanes over the
    triangles, A's group walk) give every state and rng row of the plain
    versions' walks, one sample at a time, bit for bit, and count the
    same walks and groups (``stats``): B and C on the state that
    ``emit_tiles_plain`` leaves, two-frog 48x24, cpuonly, two area lights
    of 17, 32 or 64 disk samples (64: two passes of 32 a group), or an
    area light and a point light, whose walks stay one at a time."""
    ts, rows, xs_p, ys_p, pkw, work = _soft_two_frog(samples, point, 512,
                                                     monkeypatch)
    st, rng = tmk.emit_tiles_plain(rows, xs_p, ys_p, work, 0,
                                   ts.diffuse_bounce, **pkw)

    def bounce(stats):
        return tmk.bounce_step_tiles_plain(rows, st, rng, ts.diffuse_bounce,
                                           stats=stats, **pkw)

    def resume(stats):
        return tmk.resume_tiles_plain(rows, st, rng, ts.max_bounces,
                                      ts.diffuse_bounce, stats=stats, **pkw)

    want = [{}, {}]
    want_out = [bounce(want[0]), resume(want[1])]
    seen = []

    def groups(rows_, sh_, p, rays, facing, listed=None):
        return _group_walk(rows_, sh_, p, rays, facing, listed, seen)

    monkeypatch.setattr(tmk, "_soft_walks_plain", groups)
    got = [{}, {}]
    got_out = [bounce(got[0]), resume(got[1])]
    for g_out, w_out in zip(got_out, want_out):
        for g, w in zip(g_out, w_out):
            assert torch.equal(g, w)
    keys = ("walks", "groups", "group_walks")
    for g, w in zip(got, want):
        assert [g[k] for k in keys] == [w[k] for k in keys]
    lights = 2 - point
    assert len(seen) >= 2 * lights  # B's lights, then C's, depth by depth
    assert sum(x["groups"] for x in seen) == (want[0]["groups"]
                                             + want[1]["groups"]) > 0
    assert sum(x["blocked"] for x in seen) > 0
    assert all(x["passes"] == -(-samples // 32) for x in seen)
    for w in want:  # a group walks from 1 to all of its samples
        assert w["groups"] <= w["group_walks"] <= samples * w["groups"]
        assert (w["group_walks"] == w["walks"]) == (not point)


_M32 = 0xFFFFFFFF


def _lcg_jump(n):
    """``lcg_jump`` of ``csrc/megakernel.cu``: (a, c) of n lcg steps."""
    a, c, pa, pc = 1, 0, 1664525, 1013904223
    while n:
        if n & 1:
            a, c = (pa * a) & _M32, (pa * c + pc) & _M32
        pc, pa = ((pa + 1) * pc) & _M32, (pa * pa) & _M32
        n >>= 1
    return a, c


def _mul32(a, b):
    """a * b mod 2^32 of uint32 values in int64 tensors (no overflow)."""
    return (((((a >> 16) * b) & 0xFFFF) << 16) + (a & 0xFFFF) * b) & _M32


def _unit(s):
    """2 * wang_float(s) - 1 in float32, as disk_sample makes it."""
    return 2.0 * rnglib.wang_hash_float(s) - 1.0


def _disk_accept(x, y):
    r2 = x * x + y * y
    return (r2 > 1e-10) & (r2 <= 1.0)


def _draw_disks(st, n, accept=_disk_accept):
    """``draw_disks`` of ``csrc/megakernel.cu``, emulated for (R,) rays at
    once: windows of 32 attempts, lane l's the steps 2l + 1 and 2l + 2
    past the window's state (``_lcg_jump``), the ballot of the attempts
    that end a draw (accepted, or a draw's 64th) ordering the samples ->
    (the states after the n-th draw, (R, n, 2) samples)."""
    jump = torch.tensor([_lcg_jump(2 * l + 1) for l in range(32)])
    lanes = torch.arange(32)
    r = st.shape[0]
    out = torch.zeros(r, n, 2)
    got = torch.zeros(r, dtype=torch.int64)
    run = torch.zeros(r, dtype=torch.int64)
    while bool((got < n).any()):
        on = got < n
        s1 = (_mul32(jump[:, 0][None], st[:, None]) + jump[:, 1]) & _M32
        s2 = (s1 * 1664525 + 1013904223) & _M32
        x, y = _unit(s1), _unit(s2)
        acc = accept(x, y)
        cap = (63 - run).clamp(0, 31)
        force = (run >= 32) & ~(acc & (lanes[None] <= cap[:, None])).any(1)
        ends = acc | (force[:, None] & (lanes[None] == cap[:, None]))
        k = got[:, None] + ends.cumsum(1) - ends.long()
        put = ends & (k < n) & on[:, None]
        pts = torch.stack([torch.where(acc, x, 0.0), torch.where(acc, y, 0.0)],
                          -1)
        rr, ll = put.nonzero(as_tuple=True)
        out[rr, k[rr, ll]] = pts[rr, ll]
        made = ends.sum(1)
        fin = on & (got + made >= n)
        last = (ends & (k == n - 1)).long().argmax(1)
        last_end = 31 - ends.long().flip(1).argmax(1)
        st = torch.where(fin, s2.gather(1, last[:, None])[:, 0],
                         torch.where(on, s2[:, 31], st))
        run = torch.where(on & ~fin, torch.where(made > 0, 31 - last_end,
                                                 run + 32), run)
        got = torch.where(fin, n, torch.where(on, got + made, got))
    return st, out


def _disk_serial(st, n, accept):
    """disk_sample's draws one after another (``raytracer.h:77-85``, at
    most 64 rounds a draw, (0, 0) if never accepted) with the acceptance
    ``accept``, a ray at a time."""
    states, out = [], torch.zeros(st.shape[0], n, 2)
    for r, s in enumerate(st.tolist()):
        for k in range(n):
            for _ in range(64):
                s1 = (s * 1664525 + 1013904223) & _M32
                s2 = (s1 * 1664525 + 1013904223) & _M32
                s = s2
                x, y = _unit(torch.tensor(s1)), _unit(torch.tensor(s2))
                if bool(accept(x, y)):
                    out[r, k] = torch.stack([x, y])
                    break
        states.append(s)
    return torch.tensor(states), out


def test_the_warp_disk_draws_match_the_draws_one_after_another():
    """``draw_disks`` (a ray's disk samples drawn by a warp, 32 attempts a
    window) gives the samples and the final rng state of the draws one
    after another: with the disk's acceptance against
    ``rnglib.random_in_unit_disk`` called n times (1 to 32 samples, 64
    rays), and with an acceptance of about 1 in 50, under which draws run
    past 32 rejections into the next window and reach the 64-round cap,
    against the scalar loop."""
    s = torch.randint(0, 2 ** 32, (64,), generator=torch.Generator()
                      .manual_seed(23))
    for n in (1, 31, 32):
        got_st, got = _draw_disks(s, n)
        st, pts = s, []
        for _ in range(n):
            st, v = rnglib.random_in_unit_disk(st)
            pts.append(v)
        assert torch.equal(got_st, st)
        assert torch.equal(got, torch.stack(pts, 1))

    def rare(x, y):
        return ((x * 1e4).floor() % 50 == 0) & _disk_accept(x, y)

    got_st, got = _draw_disks(s[:16], 32, rare)
    want_st, want = _disk_serial(s[:16], 32, rare)
    assert torch.equal(got_st, want_st)
    assert torch.equal(got, want)
    capped = (want == 0).all(-1)
    assert 0 < int(capped.sum()) < capped.numel()  # the cap is reached


# --- on the card: each CUDA kernel against its plain version ---------


@pytest.fixture
def cuda_scene(scenes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    js, _ = scenes
    return torch_from_jax(js, device="cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda_scene):
    """Kernel and plain version share their op order (no FMA contraction,
    IEEE div/sqrt), so states match exactly; the same tolerance as the
    CPU parity is allowed for library sqrt/pow differences."""
    ts = cuda_scene
    rows = tmk._scene_rows(ts, ts.accel)
    xs, ys, _ = t_grid(W, H, device="cuda")
    xs_p, ys_p, _, _ = tmk._pad_tiles(xs, ys)
    plan = tmk.camera_tile_plan(ts.camera, xs_p, ys_p, ts.accel)
    has_work = plan[1][:, 0] < float("inf")
    tmk.reset_launch_counts()
    st, rng = tmk.emit_tiles(ts, xs_p, ys_p, 0, plan=plan, rows=rows)
    pst, prng = tmk.emit_tiles_plain(rows, xs_p, ys_p, has_work, 0, True)
    _assert_state_close(st.cpu(), rng.cpu(), pst.cpu(), prng.cpu(), 1e-5)
    b = tmk.bounce_step_tiles(ts, st, rng, rows=rows)
    pb = tmk.bounce_step_tiles_plain(rows, st, rng, True)
    _assert_state_close(b[0].cpu(), b[1].cpu(), pb[0].cpu(), pb[1].cpu(), 1e-5)
    r = tmk.resume_tiles(ts, st, rng, rows=rows)
    pr = tmk.resume_tiles_plain(rows, st, rng, ts.max_bounces, True)
    for g, w in zip(r, pr):
        assert ulp_close(g.cpu().numpy(), w.cpu().numpy()).all()
    assert tmk.launch_counts() == {"emit": 1, "bounce_step": 1, "resume": 1,
                                   "render": 0}
