"""Wavefront kernels: emit (depth 0), one bounce step, and resume.

PyTorch/CUDA port of the three wavefront kernels of
``raytracinginonesemester_tpu.ops.megakernel``:

- ``emit_tiles``: camera rays with Wang jitter, closest hit, shading
  normal, per-light shadow walk, Lambert + Blinn-Phong, and the
  Russian-roulette bounce decision with its cosine-hemisphere sample
  (``query.h:156-220`` at depth 0);
- ``bounce_step_tiles``: one such bounce on packed per-ray state;
- ``resume_tiles``: bounces 1..max-1 in one launch.

Each wrapper launches the hand-written CUDA kernel of
``csrc/megakernel.cu`` for CUDA tensors and calls its plain PyTorch
version (``*_plain`` below) for CPU tensors; there is no other path.

The per-ray state keeps the JAX layout, so a stage of either package can
feed the other: state ``(nt*16, RAY_TILE)`` float32 with rows [bo xyz,
bd xyz, tp rgb, rd rgb, alive, 0 x3] per tile, rng ``(nt*8, RAY_TILE)``
int32 with row 0 live.

Closest hit is the flat block scan for any block count: blocks 0..L-1 in
order, a per-ray slab test against the running best t before each block,
and the lexicographic (t, global triangle id) take rule, which does not
depend on visit order.  The JAX package's superblock walk, binned plan,
chunk/quarter gating and MXU one-hot selection are TPU scheduling
choices with the same results and are not ported; winner attributes are
read by the winner's (block, lane).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core import rng as rnglib
from .accel import BlockGrid, super_aabbs

__all__ = ["RAY_TILE", "SceneRows", "megakernel_eligible",
           "megakernel_ineligible_reason",
           "camera_tile_plan", "emit_tiles", "bounce_step_tiles",
           "resume_tiles", "emit_tiles_plain", "bounce_step_tiles_plain",
           "resume_tiles_plain", "launch_counts", "reset_launch_counts"]

RAY_TILE = 512
_ST_ROWS = 16  # rows: bo xyz, bd xyz, tp rgb, rd rgb, alive, pad x3
_ST_LIVE_ROWS = 13
_ST_ALIVE_ROW = 12

F32_MAX = float(np.finfo(np.float32).max)
_INT_MAX = 2 ** 31 - 1
_INV_PI = 0.31830988618
_INV_2PI = 0.15915494309
# rays per dense (rays, block) Moller-Trumbore chunk of the plain
# versions: bounds each temporary at 4M elements
_PLAIN_PAIRS = 1 << 22


def megakernel_ineligible_reason(scene, jitter_mode: str):
    """Why the port cannot render a scene through its kernels (None = it
    can).  Callers raise ``NotImplementedError`` with this reason."""
    if scene.accel is None:
        return "no block-grid accel (accel=None)"
    if getattr(scene, "differentiable", False):
        return "differentiable scene (the differentiable path is not ported)"
    if scene.dialect == "gpu":
        if jitter_mode != "wang":
            return f"gpu dialect with jitter_mode={jitter_mode!r} (needs 'wang')"
        return None
    if scene.dialect == "cpuonly":
        return "cpuonly dialect (not ported yet)"
    return f"unknown dialect {scene.dialect!r}"


def megakernel_eligible(scene, jitter_mode: str) -> bool:
    # counterpart of the JAX package's predicate; the renderer raises with
    # ``megakernel_ineligible_reason`` instead
    return megakernel_ineligible_reason(scene, jitter_mode) is None


def _check_dialect(dialect: str, jitter: str = "wang") -> None:
    if dialect != "gpu":
        raise NotImplementedError(
            f"{dialect} dialect: only the gpu dialect is ported")
    if jitter != "wang":
        raise NotImplementedError(f"jitter={jitter!r}: only 'wang' is ported")


@dataclasses.dataclass(frozen=True)
class SceneRows:
    """Kernel operands of a scene (``_scene_rows``): ``cam`` (16,)
    [center, pixel00, du, dv, miss rgb, 0]; ``lights`` (NL, 8) [pos,
    color*intensity, radius, 0]; ``mats`` (NO, 16) [albedo, kd, specular,
    ks, shininess, kr, emission, 0 x3]; the grid planes as built; and
    ``aabb`` (L, 8) [min xyz, max xyz, 0, 0]."""

    cam: torch.Tensor
    lights: torch.Tensor
    mats: torch.Tensor
    tri: torch.Tensor
    norm: torch.Tensor
    ids: torch.Tensor
    obj: torch.Tensor
    aabb: torch.Tensor

    @property
    def num_blocks(self) -> int:
        return int(self.ids.shape[0])

    @property
    def block_size(self) -> int:
        return int(self.ids.shape[1])


def _scene_rows(scene, grid: BlockGrid) -> SceneRows:
    cam = scene.camera
    dev = cam.device
    cam_row = torch.cat([
        cam.center, cam.pixel00_loc, cam.pixel_delta_u, cam.pixel_delta_v,
        scene.miss_color.to(torch.float32).reshape(3),
        torch.zeros(1, device=dev)])
    lights = scene.lights
    nl = lights.num_lights
    lights_rows = torch.cat([
        lights.position, lights.color * lights.intensity[:, None],
        lights.radius.reshape(nl, 1), torch.zeros(nl, 1, device=dev)], dim=1)
    mats = scene.materials
    no = int(mats.kd.shape[0])
    mats_rows = torch.cat([
        mats.albedo, mats.kd[:, None], mats.specular_color, mats.ks[:, None],
        mats.shininess[:, None], mats.kr[:, None], mats.emission,
        torch.zeros(no, 3, device=dev)], dim=1)
    l = grid.num_blocks
    aabb_rows = torch.cat([grid.aabb.T, torch.zeros(l, 2, device=dev)], dim=1)
    return SceneRows(
        cam=cam_row.contiguous(), lights=lights_rows.contiguous(),
        mats=mats_rows.contiguous(), tri=grid.tri.contiguous(),
        norm=grid.norm.contiguous(),
        ids=grid.tri_index.to(torch.int32).contiguous(),
        obj=grid.obj.to(torch.int32).contiguous(),
        aabb=aabb_rows.contiguous())


def _pad_tiles(xs: torch.Tensor, ys: torch.Tensor):
    """Pad the swizzled pixel stream to whole 8-tile groups, as the JAX
    package does, so both packages see the same tile count."""
    n = int(xs.shape[0])
    pad = (-n) % (8 * RAY_TILE)
    if pad:
        xs = torch.cat([xs, xs.new_zeros(pad)])
        ys = torch.cat([ys, ys.new_zeros(pad)])
    return xs, ys, n, n + pad


def camera_tile_plan(camera, xs: torch.Tensor, ys: torch.Tensor,
                     grid: BlockGrid, ray_tile: int = RAY_TILE):
    """Sample-independent superblock plan from pixel-tile ray hulls.

    Interval slab test of (camera center, the jitter-inflated direction
    hull of each ``ray_tile`` pixels) against superblock AABBs.  Returns
    (order (NT, LS) int64, sorted_entry (NT, LS) f32); ``entry[:, 0] <
    inf`` says whether any ray of the tile can hit anything, which is
    the emit kernel's ``has_work`` test."""
    r = int(xs.shape[0])
    if r % ray_tile:
        raise ValueError("ray count must be a multiple of ray_tile")
    nt = r // ray_tile
    saabb = super_aabbs(grid)
    xs_t = xs.reshape(nt, ray_tile).to(torch.float32)
    ys_t = ys.reshape(nt, ray_tile).to(torch.float32)
    px_lo = xs_t.amin(dim=1) - 0.5
    px_hi = xs_t.amax(dim=1) + 0.5
    py_lo = ys_t.amin(dim=1) - 0.5
    py_hi = ys_t.amax(dim=1) + 0.5

    base = camera.pixel00_loc - camera.center
    du, dv = camera.pixel_delta_u, camera.pixel_delta_v
    cs = torch.stack([base[None, :] + a[:, None] * du[None, :]
                      + b[:, None] * dv[None, :]
                      for a in (px_lo, px_hi) for b in (py_lo, py_hi)])
    d_lo = cs.amin(dim=0)
    d_hi = cs.amax(dim=0)
    same_sign = (d_lo > 0.0) | (d_hi < 0.0)
    axis_floor = torch.where(same_sign,
                             torch.minimum(d_lo.abs(), d_hi.abs()),
                             torch.zeros_like(d_lo))
    dnorm_lb = axis_floor.amax(dim=1)

    inf = float("inf")
    near_all = torch.zeros(nt, 1, device=xs.device)
    far_all = torch.full((nt, 1), inf, device=xs.device)
    c = camera.center
    for axis in range(3):
        blo = saabb[axis][None, :]
        bhi = saabb[axis + 3][None, :]
        dlo = d_lo[:, axis:axis + 1]
        dhi = d_hi[:, axis:axis + 1]
        spans0 = (dlo <= 0.0) & (dhi >= 0.0)
        inv_a, inv_b = 1.0 / dhi, 1.0 / dlo
        ca = blo - c[axis]
        cb = bhi - c[axis]
        cands = [ca * inv_a, ca * inv_b, cb * inv_a, cb * inv_b]
        near = torch.minimum(torch.minimum(cands[0], cands[1]),
                             torch.minimum(cands[2], cands[3]))
        far = torch.maximum(torch.maximum(cands[0], cands[1]),
                            torch.maximum(cands[2], cands[3]))
        near = near - near.abs() * 4e-7  # rounding slack, conservative
        far = far + far.abs() * 4e-7
        bad = spans0 | near.isnan() | far.isnan()
        near_all = torch.maximum(near_all, torch.where(bad, -inf, near))
        far_all = torch.minimum(far_all, torch.where(bad, inf, far))

    valid_box = (saabb[0] <= saabb[3])[None, :]
    hit = (near_all <= far_all) & (far_all >= 0.0) & valid_box
    entry = torch.clamp(near_all, min=0.0) * dnorm_lb[:, None]
    entry = torch.where(hit, entry, inf)
    sorted_entry, order = torch.sort(entry, dim=1, stable=True)
    return order, sorted_entry


# --- plain versions: vectorised torch over rays ------------------------
#
# Every expression keeps the JAX kernel's op order (and the CUDA
# kernel keeps it too, built without FMA contraction), so the three
# agree to the last ulp wherever the libraries' sqrt/div/pow do.


def _slab(a, o, inv, t0, t1):
    """Per-ray slab test against one block AABB row ``a`` (8,), with
    the robust far-plane stretch (Ize 2013) of ``_tile_slab``."""
    for axis in range(3):
        lo = (a[axis] - o[axis]) * inv[axis]
        hi = (a[axis + 3] - o[axis]) * inv[axis]
        near = torch.minimum(lo, hi)
        far = torch.maximum(lo, hi)
        near = torch.where(near.isnan(), float("-inf"), near)
        far = torch.where(far.isnan(), float("inf"), far * 1.0000004)
        t0 = torch.maximum(t0, near)
        t1 = torch.minimum(t1, far)
    return t0 <= t1


def _mt(o, d, tri, det_eps, tmin, tmax):
    """(R, 1) rays vs (1, B) triangle planes: Moller-Trumbore
    (``query.h:72-132``) -> (t, u, v), misses at F32_MAX."""
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tri
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / torch.where(det.abs() < det_eps, 1.0, det)
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    ok = ((det.abs() >= det_eps) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t >= tmin) & (t <= tmax))
    return torch.where(ok, t, F32_MAX), u, v


def _chunks(idx: torch.Tensor, block_size: int):
    step = max(1, _PLAIN_PAIRS // block_size)
    return idx.split(step)


def _closest_plain(rows: SceneRows, o, d, alive, det_eps, tmin):
    """Closest hit by the flat block scan -> (t, u, v, id, block, lane)."""
    r = d[0].shape[0]
    dev = d[0].device
    inv = tuple(1.0 / c for c in d)
    best_t = torch.full((r,), F32_MAX, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)
    best_id = torch.full((r,), -1, dtype=torch.int64, device=dev)
    best_blk = torch.zeros(r, dtype=torch.int64, device=dev)
    best_lane = torch.zeros(r, dtype=torch.int64, device=dev)
    tmin_t = torch.full((r,), tmin, device=dev)
    for b in range(rows.num_blocks):
        boxed = _slab(rows.aabb[b], o, inv, tmin_t, best_t) & alive
        sub = boxed.nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        tri = tuple(rows.tri[k, b][None, :] for k in range(9))
        ids = rows.ids[b].to(torch.int64)[None, :]
        for ch in _chunks(sub, rows.block_size):
            oc = tuple(c[ch, None] for c in o)
            dc = tuple(c[ch, None] for c in d)
            old_t = best_t[ch]
            t, u, v = _mt(oc, dc, tri, det_eps, tmin, old_t[:, None])
            t = torch.where(ids >= 0, t, F32_MAX)
            min_t = t.amin(dim=1)
            at_min = t == min_t[:, None]
            id_key = torch.where(at_min & (ids >= 0), ids, _INT_MAX)
            win_id, lane = id_key.min(dim=1)
            old_id = best_id[ch]
            old_key = torch.where(old_id >= 0, old_id, _INT_MAX)
            take = (min_t < F32_MAX) & (
                (min_t < old_t) | ((min_t == old_t) & (win_id < old_key)))
            rr = torch.arange(ch.numel(), device=dev)
            best_t[ch] = torch.where(take, min_t, old_t)
            best_u[ch] = torch.where(take, u[rr, lane], best_u[ch])
            best_v[ch] = torch.where(take, v[rr, lane], best_v[ch])
            best_id[ch] = torch.where(take, win_id, old_id)
            best_blk[ch] = torch.where(take, b, best_blk[ch])
            best_lane[ch] = torch.where(take, lane, best_lane[ch])
    return best_t, best_u, best_v, best_id, best_blk, best_lane


def _shading_normal(rows: SceneRows, d, u, v, blk, lane):
    """gpu-dialect shading normal of the winner (``query.h:113-126``):
    geometric sidedness, zero-length interpolation fallback, hemisphere
    alignment."""
    nrm = rows.norm[:, blk, lane]  # (12, R)
    n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z, gx, gy, gz = nrm
    w = 1.0 - u - v
    snx = w * n0x + u * n1x + v * n2x
    sny = w * n0y + u * n1y + v * n2y
    snz = w * n0z + u * n1z + v * n2z
    dx, dy, dz = d
    dg = dx * gx + dy * gy + dz * gz
    gsign = torch.where(dg < 0.0, 1.0, -1.0)
    len_sq = snx * snx + sny * sny + snz * snz
    ogx, ogy, ogz = gx * gsign, gy * gsign, gz * gsign
    inv_len = 1.0 / torch.sqrt(torch.clamp(len_sq, min=1e-38))
    use_geom = len_sq < 1e-12
    snx = torch.where(use_geom, ogx, snx * inv_len)
    sny = torch.where(use_geom, ogy, sny * inv_len)
    snz = torch.where(use_geom, ogz, snz * inv_len)
    fsign = torch.where((snx * ogx + sny * ogy + snz * ogz) < 0.0, -1.0, 1.0)
    return snx * fsign, sny * fsign, snz * fsign


def _occluded_plain(rows: SceneRows, p, ld, dist, facing, det_eps,
                    shadow_tmin):
    """Any hit on [shadow_tmin, dist] toward each light, for ``facing``
    rays; a ray leaves the walk at its first hit."""
    inv = tuple(1.0 / c for c in ld)
    blocked = torch.zeros_like(facing)
    tmin_t = torch.full_like(dist, shadow_tmin)
    for b in range(rows.num_blocks):
        cand = facing & ~blocked
        if not bool(cand.any()):
            break
        boxed = _slab(rows.aabb[b], p, inv, tmin_t, dist) & cand
        sub = boxed.nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        tri = tuple(rows.tri[k, b][None, :] for k in range(9))
        ids = rows.ids[b][None, :]
        for ch in _chunks(sub, rows.block_size):
            t, _, _ = _mt(tuple(c[ch, None] for c in p),
                          tuple(c[ch, None] for c in ld), tri, det_eps,
                          shadow_tmin, dist[ch, None])
            t = torch.where(ids >= 0, t, F32_MAX)
            blocked[ch] = blocked[ch] | (t.amin(dim=1) < F32_MAX)
    return blocked


def _hemisphere_plain(state, n):
    """``random_on_hemisphere`` (``query.h:66-71``) per ray."""
    state, vec = rnglib.random_unit_vector(state)
    hx, hy, hz = vec.unbind(-1)
    dot = hx * n[0] + hy * n[1] + hz * n[2]
    fs = torch.where(dot > 0.0, 1.0, -1.0)
    return state, (hx * fs, hy * fs, hz * fs)


def _bounce_plain(rows: SceneRows, st: dict, diffuse_bounce, det_eps, tmin,
                  shadow_eps, shadow_tmin):
    """One closest hit + shade + RR step (the loop body of
    ``TraceRayIterative``, ``query.h:165-216``) on the flat per-ray
    state ``st``, updated in place.  Dead rays pass through unchanged."""
    alive = st["alive"] > 0.0
    dev = alive.device
    big = torch.tensor(1e30, device=dev)
    o = tuple(torch.where(alive, c, big) for c in st["bo"])
    d = st["bd"]
    t_hit, u, v, wid, blk, lane = _closest_plain(rows, o, d, alive, det_eps,
                                                 tmin)
    hit = t_hit < F32_MAX
    snx, sny, snz = _shading_normal(rows, d, u, v, blk, lane)
    one = torch.ones_like(t_hit)
    zero = torch.zeros_like(t_hit)
    nx = torch.where(hit, snx, zero)
    ny = torch.where(hit, sny, zero)
    nz = torch.where(hit, snz, one)
    obj = torch.where(hit, rows.obj[blk, lane].to(torch.int64), 0)
    m = rows.mats[obj]  # (R, 16): the winner's material (object 0 on a miss)

    # --- direct light (ShadeDirect, shader.h:65-110) ---
    px = torch.where(hit, o[0] + t_hit * d[0] + nx * shadow_eps, big)
    py = torch.where(hit, o[1] + t_hit * d[1] + ny * shadow_eps, big)
    pz = torch.where(hit, o[2] + t_hit * d[2] + nz * shadow_eps, big)
    vx, vy, vz = -d[0], -d[1], -d[2]
    ndotv = torch.clamp(nx * vx + ny * vy + nz * vz, min=0.0)
    lo = [m[:, 0] * 0.05 + m[:, 10], m[:, 1] * 0.05 + m[:, 11],
          m[:, 2] * 0.05 + m[:, 12]]
    for li in range(int(rows.lights.shape[0])):
        lrow = rows.lights[li]
        tox, toy, toz = lrow[0] - px, lrow[1] - py, lrow[2] - pz
        dist = torch.sqrt(torch.clamp(tox * tox + toy * toy + toz * toz,
                                      min=1e-38))
        inv_dist = 1.0 / dist
        ldx, ldy, ldz = tox * inv_dist, toy * inv_dist, toz * inv_dist
        ndotl = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
        facing = hit & (ndotl > 0.0) & (ndotv > 0.0)
        blocked = _occluded_plain(rows, (px, py, pz), (ldx, ldy, ldz), dist,
                                  facing, det_eps, shadow_tmin)
        vis = torch.where(facing & ~blocked, 1.0, 0.0)
        hx, hy, hz = ldx + vx, ldy + vy, ldz + vz
        hlen = torch.sqrt(torch.clamp(hx * hx + hy * hy + hz * hz, min=1e-38))
        ndoth = torch.clamp((nx * hx + ny * hy + nz * hz) / hlen, min=0.0)
        lit = torch.where((ndotl > 0.0) & (ndotv > 0.0), 1.0, 0.0)
        scale = ndotl * vis * lit
        shin = m[:, 8]
        lobe = torch.pow(ndoth, shin) * ((shin + 2.0) * _INV_2PI * m[:, 7])
        fd = m[:, 3] * _INV_PI
        for c in range(3):
            lo[c] = lo[c] + scale * lrow[3 + c] * (m[:, c] * fd
                                                   + m[:, 4 + c] * lobe)

    # --- radiance and the Russian-roulette split (query.h:188-212) ---
    found_f = torch.where(hit & alive, 1.0, 0.0)
    missed_f = torch.where(alive & ~hit, 1.0, 0.0)
    miss = rows.cam[12:15]
    rd = [st["rd"][c] + st["tp"][c] * (missed_f * miss[c] + found_f * lo[c])
          for c in range(3)]
    kd, kr = m[:, 3], m[:, 9]
    total = kd + kr
    can_bounce = hit & alive & (total > 0.0)
    rng0 = st["rng"]
    s_xi, xi = rnglib.rng_next(rng0)
    rng1 = torch.where(can_bounce, s_xi, rng0)
    ratio = kd / torch.where(total > 0.0, total, 1.0)
    if diffuse_bounce:
        take_diff = can_bounce & (xi < ratio)
    else:
        take_diff = torch.zeros_like(can_bounce)
    take_mirror = can_bounce & ~take_diff
    hx = torch.zeros_like(t_hit)
    hy = torch.zeros_like(t_hit)
    hz = torch.zeros_like(t_hit)
    sel = take_diff.nonzero().squeeze(1)
    if sel.numel():
        s_h, (fx, fy, fz) = _hemisphere_plain(
            rng1[sel], (nx[sel], ny[sel], nz[sel]))
        rng1 = rng1.index_put((sel,), s_h)
        hx = hx.index_put((sel,), fx)
        hy = hy.index_put((sel,), fy)
        hz = hz.index_put((sel,), fz)
    dtp = 2.0 * torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
    ddn = d[0] * nx + d[1] * ny + d[2] * nz
    rf = (d[0] - 2.0 * ddn * nx, d[1] - 2.0 * ddn * ny,
          d[2] - 2.0 * ddn * nz)
    td_f = torch.where(take_diff, 1.0, 0.0)
    bounced = take_diff | take_mirror
    b_f = torch.where(bounced, 1.0, 0.0)
    hm = (hx, hy, hz)
    p = (px, py, pz)
    bo = [torch.where(bounced, p[c], st["bo"][c]) for c in range(3)]
    bd = [b_f * (td_f * hm[c] + (1.0 - td_f) * rf[c]) + (1.0 - b_f) * d[c]
          for c in range(3)]
    tp = []
    for c in range(3):
        tsc = td_f * (m[:, c] * dtp) + (1.0 - td_f) * (m[:, 4 + c] * kr)
        tp.append(b_f * (st["tp"][c] * tsc) + (1.0 - b_f) * st["tp"][c])
    tiny = (tp[0] < 1e-4) & (tp[1] < 1e-4) & (tp[2] < 1e-4)
    new_alive = torch.where(bounced & ~tiny, 1.0, 0.0)

    st["bo"] = [torch.where(alive, a, b_) for a, b_ in zip(bo, st["bo"])]
    st["bd"] = [torch.where(alive, a, b_) for a, b_ in zip(bd, st["bd"])]
    st["tp"] = [torch.where(alive, a, b_) for a, b_ in zip(tp, st["tp"])]
    st["rd"] = [torch.where(alive, a, b_) for a, b_ in zip(rd, st["rd"])]
    st["alive"] = torch.where(alive, new_alive, st["alive"])
    st["rng"] = torch.where(alive, rng1, rng0)


def _unpack(state: torch.Tensor, rng_state: torch.Tensor) -> dict:
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    rows = state.reshape(nt, _ST_ROWS, rt).permute(1, 0, 2).reshape(
        _ST_ROWS, nt * rt)
    return dict(bo=list(rows[0:3]), bd=list(rows[3:6]), tp=list(rows[6:9]),
                rd=list(rows[9:12]), alive=rows[12],
                rng=rnglib.to_u32(rng_state.reshape(nt, 8, rt)[:, 0]
                                  .reshape(nt * rt)))


def _pack(st: dict, nt: int, rt: int):
    planes = st["bo"] + st["bd"] + st["tp"] + st["rd"] + [st["alive"]]
    zeros = torch.zeros_like(st["alive"])
    planes += [zeros] * (_ST_ROWS - _ST_LIVE_ROWS)
    state = torch.stack([pl.reshape(nt, rt) for pl in planes], dim=1)
    rng0 = rnglib.to_i32(st["rng"]).reshape(nt, 1, rt)
    rng = torch.cat([rng0, rng0.new_zeros(nt, 7, rt)], dim=1)
    return (state.reshape(nt * _ST_ROWS, rt).contiguous(),
            rng.reshape(nt * 8, rt).contiguous())


def emit_tiles_plain(rows: SceneRows, xs_p, ys_p, has_work, sample_offset,
                     diffuse_bounce, det_eps=1e-8, tmin=1e-4,
                     shadow_eps=1e-3, shadow_tmin=1e-4):
    """Plain version of the emit kernel on a padded pixel stream;
    ``has_work`` (nt,) bool from ``camera_tile_plan``."""
    np_rays = int(xs_p.shape[0])
    nt = np_rays // RAY_TILE
    x = xs_p.to(torch.int64)
    y = ys_p.to(torch.int64)
    h = rnglib.make_rng_seed(x, y, int(sample_offset))
    jx, jy = rnglib.pixel_jitter(x, y, int(sample_offset))
    pxf = x.to(torch.float32) + jx
    pyf = y.to(torch.float32) + jy
    cam = rows.cam
    c = cam[0:3]
    r = [(cam[3 + k] + pxf * cam[6 + k] + pyf * cam[9 + k]) - c[k]
         for k in range(3)]
    rlen = torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    work = has_work.repeat_interleave(RAY_TILE)
    ones = torch.ones(np_rays, device=xs_p.device)
    st = dict(bo=[c[k].expand(np_rays) for k in range(3)],
              bd=[r[k] / rlen for k in range(3)],
              tp=[ones, ones, ones], rd=[ones * 0.0] * 3,
              alive=torch.where(work, 1.0, 0.0), rng=h)
    _bounce_plain(rows, st, diffuse_bounce, det_eps, tmin, shadow_eps,
                  shadow_tmin)
    # tiles no ray of which can hit anything: dead state with a unit
    # direction (a zero one poisons later 1/d) and the miss radiance
    zeros = torch.zeros(np_rays, device=xs_p.device)
    dead = dict(bo=[zeros] * 3, bd=[zeros, zeros, ones], tp=[zeros] * 3,
                rd=[cam[12 + k].expand(np_rays) for k in range(3)],
                alive=zeros, rng=torch.zeros_like(h))
    for key in ("bo", "bd", "tp", "rd"):
        st[key] = [torch.where(work, a, b_) for a, b_ in zip(st[key], dead[key])]
    st["alive"] = torch.where(work, st["alive"], zeros)
    st["rng"] = torch.where(work, st["rng"], dead["rng"])
    return _pack(st, nt, RAY_TILE)


def bounce_step_tiles_plain(rows: SceneRows, state, rng_state,
                            diffuse_bounce, det_eps=1e-8, tmin=1e-4,
                            shadow_eps=1e-3, shadow_tmin=1e-4):
    """Plain version of the bounce-step kernel."""
    nt = state.shape[0] // _ST_ROWS
    st = _unpack(state, rng_state)
    _bounce_plain(rows, st, diffuse_bounce, det_eps, tmin, shadow_eps,
                  shadow_tmin)
    return _pack(st, nt, state.shape[1])


def resume_tiles_plain(rows: SceneRows, state, rng_state, max_bounces,
                       diffuse_bounce, det_eps=1e-8, tmin=1e-4,
                       shadow_eps=1e-3, shadow_tmin=1e-4):
    """Plain version of the resume kernel: bounces 1..max_bounces-1."""
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    st = _unpack(state, rng_state)
    for _ in range(1, int(max_bounces)):
        if not bool((st["alive"] > 0.0).any()):
            break
        _bounce_plain(rows, st, diffuse_bounce, det_eps, tmin, shadow_eps,
                      shadow_tmin)
    return tuple(c.reshape(nt, rt) for c in st["rd"])


# --- kernel wrappers ---------------------------------------------------

def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _scene_args(rows: SceneRows, diffuse_bounce, det_eps, tmin, shadow_eps,
                shadow_tmin):
    from ._native import SceneArgs

    for name in ("cam", "lights", "mats", "tri", "norm", "aabb"):
        t = getattr(rows, name)
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"scene operand {name}: need contiguous CUDA float32")
    for name in ("ids", "obj"):
        t = getattr(rows, name)
        if t.dtype != torch.int32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"scene operand {name}: need contiguous CUDA int32")
    return SceneArgs(
        cam=rows.cam.data_ptr(), lights=rows.lights.data_ptr(),
        mats=rows.mats.data_ptr(), tri=rows.tri.data_ptr(),
        norm=rows.norm.data_ptr(), ids=rows.ids.data_ptr(),
        obj=rows.obj.data_ptr(), aabb=rows.aabb.data_ptr(),
        n_lights=int(rows.lights.shape[0]), n_objects=int(rows.mats.shape[0]),
        num_blocks=rows.num_blocks, block_size=rows.block_size,
        diffuse_bounce=int(bool(diffuse_bounce)), det_eps=det_eps, tmin=tmin,
        shadow_eps=shadow_eps, shadow_tmin=shadow_tmin)


def _check_rows(state, rng_state):
    if state.dtype != torch.float32 or rng_state.dtype != torch.int32:
        raise ValueError("state must be float32 and rng_state int32")
    if state.shape[0] % _ST_ROWS or rng_state.shape[0] != state.shape[0] // 2 \
            or rng_state.shape[1] != state.shape[1]:
        raise ValueError(f"bad state/rng shapes {tuple(state.shape)}, "
                         f"{tuple(rng_state.shape)}")
    if state.device != rng_state.device:
        raise ValueError("state and rng_state on different devices")


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.rt_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def emit_tiles(scene, xs, ys, sample_offset=0, *, det_eps: float = 1e-8,
               tmin: float = 1e-4, shadow_eps: float = 1e-3,
               shadow_tmin: float = 1e-4, dialect: str = "gpu",
               jitter: str = "wang", plan=None, rows: SceneRows = None):
    """Depth-0 pass: camera rays + direct light + the RR bounce decision.

    Returns (state (nt*16, RAY_TILE) f32, rng (nt*8, RAY_TILE) i32).
    ``plan``: optional ``camera_tile_plan`` result for the padded stream
    (sample-independent, so frame loops build it once); ``rows``:
    optional prebuilt ``_scene_rows``."""
    _check_dialect(dialect, jitter)
    xs, ys, _, np_rays = _pad_tiles(xs, ys)
    if plan is None:
        plan = camera_tile_plan(scene.camera, xs, ys, scene.accel, RAY_TILE)
    has_work = plan[1][:, 0] < float("inf")
    rows = _scene_rows(scene, scene.accel) if rows is None else rows
    if _device_kind(xs) == "cpu":
        return emit_tiles_plain(rows, xs, ys, has_work, int(sample_offset),
                                scene.diffuse_bounce, det_eps, tmin,
                                shadow_eps, shadow_tmin)
    from ._native import load

    lib = load()
    nt = np_rays // RAY_TILE
    xs_c = xs.to(torch.int32).contiguous()
    ys_c = ys.to(torch.int32).contiguous()
    hw = has_work.to(torch.int32).contiguous()
    st = torch.empty(nt * _ST_ROWS, RAY_TILE, dtype=torch.float32,
                     device=xs.device)
    rng = torch.empty(nt * 8, RAY_TILE, dtype=torch.int32, device=xs.device)
    args = _scene_args(rows, scene.diffuse_bounce, det_eps, tmin, shadow_eps,
                       shadow_tmin)
    err = lib.rt_emit(ctypes.byref(args), _ptr(xs_c), _ptr(ys_c), _ptr(hw),
                      np_rays, RAY_TILE, int(sample_offset), _ptr(st),
                      _ptr(rng), _stream())
    _raise_on(lib, err, "emit")
    emit_tiles.launches += 1
    return st, rng


def bounce_step_tiles(scene, state, rng_state, *, det_eps: float = 1e-8,
                      tmin: float = 1e-4, shadow_eps: float = 1e-3,
                      shadow_tmin: float = 1e-4, dialect: str = "gpu",
                      rows: SceneRows = None):
    """One bounce over packed state tiles -> (state', rng').  The JAX
    version's ``order``/``entry`` plan operands are not taken: the port
    always runs the flat scan, which needs no plan."""
    _check_dialect(dialect)
    _check_rows(state, rng_state)
    rows = _scene_rows(scene, scene.accel) if rows is None else rows
    if _device_kind(state) == "cpu":
        return bounce_step_tiles_plain(rows, state, rng_state,
                                       scene.diffuse_bounce, det_eps, tmin,
                                       shadow_eps, shadow_tmin)
    from ._native import load

    lib = load()
    state = state.contiguous()
    rng_state = rng_state.contiguous()
    st_out = torch.empty_like(state)
    rng_out = torch.empty_like(rng_state)
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    args = _scene_args(rows, scene.diffuse_bounce, det_eps, tmin, shadow_eps,
                       shadow_tmin)
    err = lib.rt_bounce_step(ctypes.byref(args), _ptr(state), _ptr(rng_state),
                             nt * rt, rt, _ptr(st_out), _ptr(rng_out),
                             _stream())
    _raise_on(lib, err, "bounce_step")
    bounce_step_tiles.launches += 1
    return st_out, rng_out


def resume_tiles(scene, state, rng_state, *, det_eps: float = 1e-8,
                 tmin: float = 1e-4, shadow_eps: float = 1e-3,
                 shadow_tmin: float = 1e-4, dialect: str = "gpu",
                 rows: SceneRows = None):
    """Bounce depths 1..max_bounces-1 -> per-ray radiance (r, g, b), each
    (nt, RAY_TILE), in the state's ray order."""
    _check_dialect(dialect)
    _check_rows(state, rng_state)
    rows = _scene_rows(scene, scene.accel) if rows is None else rows
    if _device_kind(state) == "cpu":
        return resume_tiles_plain(rows, state, rng_state, scene.max_bounces,
                                  scene.diffuse_bounce, det_eps, tmin,
                                  shadow_eps, shadow_tmin)
    from ._native import load

    lib = load()
    state = state.contiguous()
    rng_state = rng_state.contiguous()
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    outs = [torch.empty(nt, rt, dtype=torch.float32, device=state.device)
            for _ in range(3)]
    args = _scene_args(rows, scene.diffuse_bounce, det_eps, tmin, shadow_eps,
                       shadow_tmin)
    err = lib.rt_resume(ctypes.byref(args), _ptr(state), _ptr(rng_state),
                        nt * rt, rt, int(scene.max_bounces), *map(_ptr, outs),
                        _stream())
    _raise_on(lib, err, "resume")
    resume_tiles.launches += 1
    return tuple(outs)


# launch counters: each wrapper adds one where it launches its kernel
_WRAPPERS = {"emit": emit_tiles, "bounce_step": bounce_step_tiles,
             "resume": resume_tiles}
for _fn in _WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
