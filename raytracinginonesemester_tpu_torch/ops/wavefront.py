"""Wavefront bounce scheduling: sort-compacted bounce wavefronts.

PyTorch port of ``raytracinginonesemester_tpu.ops.wavefront`` (the
stream-compaction design of Laine et al. 2013, "Megakernels Considered
Harmful"; the reference's ``TraceRayIterative`` is the megakernel form,
``query.h:156-220``):

1. ``emit_tiles`` runs depth 0 and writes per-ray bounce state;
2. the tiles holding survivors are gathered (at most ``cap`` of them)
   and sorted by (alive, direction octant, origin Morton), which packs
   alive rays to the front in coherent tiles;
3. one ``bounce_step_tiles`` per bounce, each followed by a re-sort,
   on a capacity that shrinks to cap/8 once the wavefront has decayed;
4. a sort by pixel key brings radiance back, and the subset is
   scattered over the emit pass's radiance.

Per-ray math never depends on where a ray sits, so the images do not
depend on the sort order, the capacity or the tile a ray lands in.  The
loop decisions the JAX package takes in-graph (``lax.cond`` on overflow,
``while_loop`` on "any ray alive") are taken on the host here, from one
small device-to-host copy each.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Optional

import torch

from .lbvh import _bit_expand
from .megakernel import (
    _ST_ALIVE_ROW,
    _ST_LIVE_ROWS,
    _ST_ROWS,
    RAY_TILE,
    _pad_tiles,
    _scene_rows,
    bounce_step_tiles,
    camera_tile_plan,
    emit_tiles,
    resume_tiles,
)

__all__ = ["render_tiles_wavefront", "render_tiles_wavefront_frames",
           "sort_bounce_state", "auto_capacity_tiles"]

_I32_MAX = 2 ** 31 - 1


def _sort_key(bo, bd, alive, lo, span):
    """(direction octant << 24) | 24-bit origin Morton; dead rays get
    INT32_MAX so they pack to the tail (``bitExpansion``, bvh.h:131-140)."""
    oct_ = ((bd[0] < 0.0).to(torch.int64) * 4
            | (bd[1] < 0.0).to(torch.int64) * 2
            | (bd[2] < 0.0).to(torch.int64))
    q = [torch.clamp((bo[c] - lo[c]) / span[c] * 256.0, 0.0, 255.0)
         .to(torch.int64) for c in range(3)]
    morton = (_bit_expand(q[0]) | (_bit_expand(q[1]) << 1)
              | (_bit_expand(q[2]) << 2))
    key = (oct_ << 24) | morton
    return torch.where(alive, key, _I32_MAX)


def sort_bounce_state(state, rng_state, pix, lo, span):
    """Sort per-ray state by the compaction key -> (state, rng, pix).

    The sort need not be stable: per-ray math does not depend on a ray's
    placement and the pixel keys used to undo it are unique."""
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    nr = nt * rt
    planes = state.reshape(nt, _ST_ROWS, rt)[:, :_ST_LIVE_ROWS].permute(
        1, 0, 2).reshape(_ST_LIVE_ROWS, nr)
    rng_flat = rng_state.reshape(nt, 8, rt)[:, 0].reshape(nr)
    key = _sort_key(planes[0:3], planes[3:6], planes[_ST_ALIVE_ROW] > 0.0,
                    lo, span)
    perm = torch.sort(key).indices
    planes = planes[:, perm]
    st = torch.zeros(nt, _ST_ROWS, rt, dtype=state.dtype, device=state.device)
    st[:, :_ST_LIVE_ROWS] = planes.reshape(_ST_LIVE_ROWS, nt, rt).permute(1, 0, 2)
    rng = torch.zeros(nt, 8, rt, dtype=rng_state.dtype, device=state.device)
    rng[:, 0] = rng_flat[perm].reshape(nt, rt)
    return (st.reshape(nt * _ST_ROWS, rt), rng.reshape(nt * 8, rt),
            pix[perm])


def _any_alive(st, tiles=None) -> bool:
    stv = st.reshape(-1, _ST_ROWS, st.shape[1])
    if tiles is not None:
        stv = stv[tiles]
    return bool((stv[:, _ST_ALIVE_ROW] > 0.0).any())


def _staged_ladder(scene, h_st, h_rng, h_pix, cap, lo, span, mb, kw):
    """One bounce kernel + re-sort per depth on packed tiles, with the
    capacity shrinking to cap/8 after the first bounce when the alive
    wavefront fits; radiance rides in the state's rd rows."""

    def one_bounce(st, rng, pix):
        st, rng = bounce_step_tiles(scene, st, rng, **kw)
        return sort_bounce_state(st, rng, pix, lo, span)

    def while_bounces(st, rng, pix, d0):
        d = d0
        while d < mb and _any_alive(st):
            st, rng, pix = one_bounce(st, rng, pix)
            d += 1
        return st, pix

    cap2 = max(8, cap // 8)
    if mb <= 2 or cap2 >= cap:
        return while_bounces(h_st, h_rng, h_pix, 1)
    if _any_alive(h_st):
        h_st, h_rng, h_pix = one_bounce(h_st, h_rng, h_pix)
    if _any_alive(h_st, slice(cap2, None)):
        return while_bounces(h_st, h_rng, h_pix, 2)
    p_st, p_pix = while_bounces(h_st[:cap2 * _ST_ROWS], h_rng[:cap2 * 8],
                                h_pix[:cap2 * RAY_TILE], 2)
    return (torch.cat([p_st, h_st[cap2 * _ST_ROWS:]]),
            torch.cat([p_pix, h_pix[cap2 * RAY_TILE:]]))


def _unsort_radiance(pix, r, g, b):
    """Radiance back into ascending pixel-key order (keys are unique)."""
    order = torch.argsort(pix)
    return r.reshape(-1)[order], g.reshape(-1)[order], b.reshape(-1)[order]


def _resume_all(scene, st, rng, pix, lo, span, kw):
    """Single-sort path: every tile sorted, one multi-bounce resume, the
    radiance unsorted back to pixel order."""
    st_s, rng_s, pix_s = sort_bounce_state(st, rng, pix, lo, span)
    return _unsort_radiance(pix_s, *resume_tiles(scene, st_s, rng_s, **kw))


def _render_group(scene, xs_p, ys_p, plan, lo, span, cap, group, s0,
                  jitter, kw, cand_plan=None):
    """Render ``group`` consecutive samples with one merged bounce phase.

    Phase A: each sample's emit, and a gather of its alive tiles (at most
    ``cap``).  A sample with more alive tiles than ``cap`` finishes at
    full width in ``resume_tiles`` and rides through phase B dead.
    Phase B: one compaction sort of all subsets together, one staged
    ladder, one unsort by pixel key.  Returns (r, g, b), each
    ``(group, np_rays)``: per-sample final radiance, unclipped."""
    np_rays = int(xs_p.shape[0])
    nt = np_rays // RAY_TILE
    dev = xs_p.device
    mb = int(scene.max_bounces)
    pix = torch.arange(np_rays, dtype=torch.int64, device=dev)
    lane = torch.arange(RAY_TILE, dtype=torch.int64, device=dev)
    iota_t = torch.arange(nt, dtype=torch.int64, device=dev)

    idxs, st_gs, rng_gs, pix_gs, frames = [], [], [], [], []
    for j in range(group):
        st, rng = emit_tiles(scene, xs_p, ys_p, s0 + j, jitter=jitter,
                             plan=plan, cand_plan=cand_plan, **kw)
        stv = st.reshape(nt, _ST_ROWS, RAY_TILE)
        alive_t = (stv[:, _ST_ALIVE_ROW] > 0.0).any(dim=1)
        key_t = torch.where(alive_t, iota_t, iota_t + nt)
        idx = torch.sort(torch.argsort(key_t)[:cap]).values
        st_g = stv[idx]
        base = [stv[:, row].reshape(np_rays) for row in (9, 10, 11)]
        if int(alive_t.sum()) > cap:
            # capacity overflow: finish this sample at full width and
            # park its subset (final radiance, dead) for phase B
            base = list(_resume_all(scene, st, rng, pix, lo, span, kw))
            st_g = st_g.clone()
            for row, fr in zip((9, 10, 11), base):
                st_g[:, row] = fr.reshape(nt, RAY_TILE)[idx]
            st_g[:, _ST_ALIVE_ROW] = 0.0
        idxs.append(idx)
        st_gs.append(st_g.reshape(cap * _ST_ROWS, RAY_TILE))
        rng_gs.append(rng.reshape(nt, 8, RAY_TILE)[idx].reshape(cap * 8, RAY_TILE))
        pix_gs.append((idx[:, None] * RAY_TILE + lane[None, :]).reshape(-1)
                      + j * np_rays)
        frames.append(base)

    cap_g = cap * group
    h_st, h_rng, h_pix = sort_bounce_state(
        torch.cat(st_gs), torch.cat(rng_gs), torch.cat(pix_gs), lo, span)
    h_st, h_pix = _staged_ladder(scene, h_st, h_rng, h_pix, cap_g, lo, span,
                                 mb, kw)
    fv = h_st.reshape(cap_g, _ST_ROWS, RAY_TILE)
    subs = _unsort_radiance(h_pix, fv[:, 9], fv[:, 10], fv[:, 11])
    # sample j's keys are exactly the cap*RAY_TILE keys in
    # [j*np_rays, (j+1)*np_rays), so after the unsort they are rows
    # [j*cap*RAY_TILE, (j+1)*cap*RAY_TILE), in gathered-tile order
    out = []
    for c in range(3):
        chans = []
        for j in range(group):
            frame = frames[j][c].reshape(nt, RAY_TILE).clone()
            frame[idxs[j]] = subs[c][j * cap * RAY_TILE:(j + 1) * cap * RAY_TILE
                                     ].reshape(cap, RAY_TILE)
            chans.append(frame.reshape(np_rays))
        out.append(torch.stack(chans))
    return tuple(out)


def _setup(scene, xs, ys, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
           shadow_samples, cand_plan):
    """Padded stream, Morton bounds, the camera plan (unless binned) and
    the kernels' shared keyword arguments of one render call."""
    grid = scene.accel
    xs_p, ys_p, n, np_rays = _pad_tiles(xs, ys)
    lo = [grid.aabb[c].amin() for c in range(3)]
    span = [torch.clamp(grid.aabb[3 + c].amax() - lo[c], min=1e-20)
            for c in range(3)]
    plan = (None if cand_plan is not None
            else camera_tile_plan(scene.camera, xs_p, ys_p, grid, RAY_TILE))
    kw = dict(det_eps=det_eps, tmin=tmin, shadow_eps=shadow_eps,
              shadow_tmin=shadow_tmin, dialect=dialect,
              shadow_samples=shadow_samples, rows=_scene_rows(scene, grid))
    return xs_p, ys_p, n, np_rays, lo, span, plan, kw


def _clip(dialect):
    # per-sample clamp (query.h:219); cpuonly has none (clamped at PNG
    # quantization, CPUOnly/src/render.cpp:157-160)
    if dialect == "cpuonly":
        return lambda c: c
    return lambda c: torch.clamp(c, 0.0, 1.0)


def render_tiles_wavefront_frames(scene, xs, ys, frames: int,
                                  sample_offset: int = 0, *, spp: int = 1,
                                  det_eps: float = 1e-8, tmin: float = 1e-4,
                                  shadow_eps: float = 1e-3,
                                  shadow_tmin: float = 1e-4,
                                  dialect: str = "gpu", jitter: str = "wang",
                                  shadow_samples: int = 1,
                                  capacity_tiles: Optional[int] = None,
                                  cand_plan=None):
    """``frames`` spp-1 frames with one merged bounce phase -> (frames,
    N, 3) per-frame radiance, clipped per sample in the gpu dialect;
    frame f renders sample ``sample_offset + f``.  Requires a calibrated
    ``capacity_tiles`` (``auto_capacity_tiles``); ``cand_plan``: the
    binned plan of this stream, threaded to every emit."""
    if spp != 1:
        raise NotImplementedError("batched frames are spp-1 per frame")
    if capacity_tiles is None:
        raise ValueError("render_tiles_wavefront_frames requires a "
                         "calibrated capacity_tiles")
    xs_p, ys_p, n, np_rays, lo, span, plan, kw = _setup(
        scene, xs, ys, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
        shadow_samples, cand_plan)
    cap = min(int(capacity_tiles), np_rays // RAY_TILE)
    r3 = _render_group(scene, xs_p, ys_p, plan, lo, span, cap, int(frames),
                       int(sample_offset), jitter, kw, cand_plan)
    clip = _clip(dialect)
    return torch.stack([clip(c[:, :n]) for c in r3], dim=2)


def render_tiles_wavefront(scene, xs, ys, spp: int, sample_offset: int = 0,
                           *, det_eps: float = 1e-8, tmin: float = 1e-4,
                           shadow_eps: float = 1e-3,
                           shadow_tmin: float = 1e-4, dialect: str = "gpu",
                           jitter: str = "wang", shadow_samples: int = 1,
                           capacity_tiles: Optional[int] = None,
                           sample_group: Optional[int] = None,
                           cand_plan=None):
    """Wavefront render of one frame -> (N, 3) radiance SUM over ``spp``
    samples, the same sums as ``megakernel.render_tiles`` for scenes
    that bounce.

    ``capacity_tiles`` (below the tile count, depth > 1) stages the
    bounces on the gathered alive tiles, ``sample_group`` samples
    (``RT_SAMPLE_GROUP``, default 8, cut to a divisor of ``spp``) per
    merged ladder; otherwise each sample sorts every tile and finishes
    in one ``resume_tiles``.  Samples accumulate in order, clipped per
    sample in the gpu dialect."""
    if sample_group is None:
        sample_group = int(os.environ.get("RT_SAMPLE_GROUP", "8"))
    xs_p, ys_p, n, np_rays, lo, span, plan, kw = _setup(
        scene, xs, ys, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
        shadow_samples, cand_plan)
    nt = np_rays // RAY_TILE
    off = int(sample_offset)
    staged = (capacity_tiles is not None and capacity_tiles < nt
              and int(scene.max_bounces) > 1)
    clip = _clip(dialect)
    acc = [torch.zeros(np_rays, device=xs_p.device) for _ in range(3)]
    if not staged:
        pix = torch.arange(np_rays, dtype=torch.int64, device=xs_p.device)
        for s in range(int(spp)):
            st, rng = emit_tiles(scene, xs_p, ys_p, off + s, jitter=jitter,
                                 plan=plan, cand_plan=cand_plan, **kw)
            r3 = _resume_all(scene, st, rng, pix, lo, span, kw)
            acc = [a + clip(c) for a, c in zip(acc, r3)]
    else:
        group = max(1, min(int(sample_group), int(spp)))
        while spp % group:
            group -= 1
        for g0 in range(0, int(spp), group):
            r3 = _render_group(scene, xs_p, ys_p, plan, lo, span,
                               int(capacity_tiles), group, off + g0, jitter,
                               kw, cand_plan)
            for j in range(group):
                acc = [a + clip(c[j]) for a, c in zip(acc, r3)]
    return torch.stack([a[:n] for a in acc], dim=1)


def _emit_alive_tiles(scene, xs_p, ys_p, **kw) -> int:
    st, _ = emit_tiles(scene, xs_p, ys_p, 0, **kw)
    stv = st.reshape(-1, _ST_ROWS, RAY_TILE)
    return int((stv[:, _ST_ALIVE_ROW] > 0.0).any(dim=1).sum())


# in-process capacity per static scene key, in front of the disk cache: a
# render then skips the fingerprint's device->host copy and the file read
_CAP_CACHE: dict = {}


def _cache_dir() -> str:
    # the port's own directory: a JAX calibration must not feed the port
    return os.environ.get("RT_TORCH_CAP_CACHE", os.path.join(
        tempfile.gettempdir(), "rt_capacity_cache_torch"))


def _disk_cache_load(key: str):
    try:
        with open(os.path.join(_cache_dir(), f"{key}.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return ()


def _disk_cache_store(key: str, value) -> None:
    try:
        os.makedirs(_cache_dir(), exist_ok=True)
        path = os.path.join(_cache_dir(), f"{key}.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(value, f)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache only saves a calibration emit


def _scene_fingerprint(scene, key) -> str:
    h = hashlib.sha1(repr(key).encode())
    h.update(scene.accel.aabb.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def auto_capacity_tiles(scene, margin: float = 1.2, **kw) -> Optional[int]:
    """Calibrate the staged scheduler's alive-wavefront capacity.

    One emit counts the tiles holding depth-0 survivors; the capacity is
    that count with ``margin`` headroom, rounded up to a power of two.
    Returns None when staging cannot help (the alive wavefront is about
    the whole frame, or the scene never bounces).  Cached in memory per
    static key and on disk per scene fingerprint; a wrong capacity only
    costs the overflow branch."""
    if scene.accel is None or int(scene.max_bounces) <= 1:
        return None
    key = (int(scene.camera.width), int(scene.camera.height),
           int(scene.geometry.padded_triangles), int(scene.max_bounces),
           int(scene.spp), scene.dialect, str(scene.device.type))
    if key in _CAP_CACHE:
        return _CAP_CACHE[key]
    fp = _scene_fingerprint(scene, key)
    cached = _disk_cache_load(fp)
    if cached != ():
        _CAP_CACHE[key] = cached
        return cached
    from ..render.renderer import _swizzled_grid

    xs, ys, _ = _swizzled_grid(int(scene.camera.width),
                               int(scene.camera.height), device=scene.device)
    xs_p, ys_p, _, np_rays = _pad_tiles(xs, ys)
    nt = np_rays // RAY_TILE
    tiles = int(_emit_alive_tiles(scene, xs_p, ys_p, **kw) * margin)
    cap = 8
    while cap < tiles:
        cap *= 2
    result = None if cap * 2 >= nt else cap
    _CAP_CACHE[key] = result
    _disk_cache_store(fp, result)
    return result
