"""Fused path-tracing kernels: emit (depth 0), one bounce step, resume,
and the monolithic render.

PyTorch/CUDA port of the four fused kernels of
``raytracinginonesemester_tpu.ops.megakernel``:

- ``emit_tiles``: camera rays (Wang or pixel-center jitter), closest
  hit, shading normal, direct light with shadows, and the
  Russian-roulette bounce decision with its hemisphere sample
  (``query.h:156-220`` at depth 0);
- ``bounce_step_tiles``: one such bounce on packed per-ray state;
- ``resume_tiles``: bounces 1..max-1 in one launch;
- ``render_tiles``: the whole spp loop per pixel (``_render_kernel``):
  the sky-tile shortcut, the terminal pass (primary hit + direct light)
  or the full bounce loop, per-sample clamp (gpu) or none (cpuonly).

Both reference dialects: "gpu" (``TraceRayIterative`` + ``IsInShadow``)
and "cpuonly" (``TraceRay``: sky-gradient misses, disk-sampled soft
shadows, the (kd + kr)-weighted throughput rules, no per-sample clamp).

Each wrapper launches the hand-written CUDA kernel of
``csrc/megakernel.cu`` for CUDA tensors and calls its plain PyTorch
version (``*_plain`` below) for CPU tensors; there is no other path.

The per-ray state keeps the JAX layout, so a stage of either package can
feed the other: state ``(nt*16, RAY_TILE)`` float32 with rows [bo xyz,
bd xyz, tp rgb, rd rgb, alive, 0 x3] per tile, rng ``(nt*8, RAY_TILE)``
int32 with row 0 live.

Closest hit at depth 0 either walks the tile's binned candidate chunks
(``ops.binned``, when a plan is given) or runs the flat block scan:
blocks 0..L-1 in order, a per-ray slab test against the running best t
before each block.  Bounces always take the flat scan.  The
lexicographic (t, global triangle id) take rule does not depend on
visit order, so both give the same winners; winner attributes are read
by the winner's (block, lane).  The JAX package's superblock walk,
chunk/quarter gating and MXU one-hot selection are TPU scheduling
choices with the same results and are not ported.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..core import rng as rnglib
from .accel import BlockGrid, super_aabbs
from .binned import CAND_ROWS, plan_matches_camera

__all__ = ["RAY_TILE", "SceneRows", "megakernel_ineligible_reason",
           "megakernel_kwargs",
           "camera_tile_plan", "emit_tiles", "bounce_step_tiles",
           "resume_tiles", "render_tiles", "emit_tiles_plain",
           "bounce_step_tiles_plain", "resume_tiles_plain",
           "render_tiles_plain", "launch_counts", "variant_launch_counts",
           "reset_launch_counts", "DIFF_ROWS"]

RAY_TILE = 512
_ST_ROWS = 16  # rows: bo xyz, bd xyz, tp rgb, rd rgb, alive, pad x3
_ST_LIVE_ROWS = 13
_ST_ALIVE_ROW = 12
# the oracle rows of bounce_step_tiles(diff_out=True), rows 6 and 7 zero
DIFF_ROWS = ("t", "u", "v", "id", "vis", "dec")

F32_MAX = float(np.finfo(np.float32).max)
_INT_MAX = 2 ** 31 - 1
_INV_PI = 0.31830988618
_INV_2PI = 0.15915494309
# the cpuonly dialect's eps family: std::numeric_limits<float>::epsilon()
# (JAX ``ops/intersect.py:31``) and CPUOnly's RT_EPS (``ops/shading.py:31``)
FLT_EPSILON = 1.1920929e-7
RT_EPS_CPUONLY = 1e-4
# the soft-shadow loop bound of the kernels (per area light)
MAX_SHADOW_SAMPLES = 16
# rays per dense (rays, candidates) Moller-Trumbore chunk of the plain
# versions: bounds each temporary at 4M elements
_PLAIN_PAIRS = 1 << 22


def megakernel_kwargs(scene, jitter_mode: str) -> dict:
    """The dialect-specific kwargs of the kernel wrappers: one definition
    for every dispatch site."""
    if scene.dialect != "cpuonly":
        return {}
    return dict(dialect="cpuonly", jitter=jitter_mode,
                shadow_samples=max(scene.lights.shadow_samples),
                det_eps=FLT_EPSILON, shadow_eps=RT_EPS_CPUONLY,
                shadow_tmin=RT_EPS_CPUONLY)


def megakernel_ineligible_reason(scene, jitter_mode: str):
    """Why the fused kernels do not take a scene (None = they do), in
    the JAX package's words; the renderer then takes the staged
    integrator and warns once with this reason."""
    from .block_kernels import fits_vmem

    if scene.accel is None:
        return "no block-grid accel (accel=None)"
    if not fits_vmem(scene.accel):
        # the plane-budget rule: a dispatch rule on the card
        return "triangle planes exceed the kernel VMEM budget"
    if getattr(scene, "differentiable", False):
        return "differentiable scene (staged integrator only)"
    if scene.dialect == "gpu":
        if jitter_mode != "wang":
            return f"gpu dialect with jitter_mode={jitter_mode!r} (needs 'wang')"
        return None
    if scene.dialect == "cpuonly":
        if jitter_mode not in ("wang", "center"):
            return (f"cpuonly dialect with jitter_mode={jitter_mode!r} "
                    "(needs 'wang'/'center')")
        ss = max(scene.lights.shadow_samples)
        if ss > MAX_SHADOW_SAMPLES:
            return (f"shadow_samples={ss} > {MAX_SHADOW_SAMPLES} "
                    "(static soft-shadow unroll bound)")
        return None
    return f"unknown dialect {scene.dialect!r}"


@dataclasses.dataclass(frozen=True)
class _Shade:
    """Static shading parameters of one kernel call."""

    diffuse_bounce: bool
    det_eps: float = 1e-8
    tmin: float = 1e-4
    shadow_eps: float = 1e-3
    shadow_tmin: float = 1e-4
    dialect: str = "gpu"
    shadow_samples: int = 1

    def __post_init__(self):
        if self.dialect not in ("gpu", "cpuonly"):
            raise NotImplementedError(f"unknown dialect {self.dialect!r}")
        if not 1 <= int(self.shadow_samples) <= MAX_SHADOW_SAMPLES:
            raise NotImplementedError(
                f"shadow_samples={self.shadow_samples} outside "
                f"1..{MAX_SHADOW_SAMPLES} (static soft-shadow unroll bound)")

    @property
    def cpuonly(self) -> bool:
        return self.dialect == "cpuonly"


def _check_jitter(jitter: str, dialect: str) -> None:
    allowed = ("wang", "center") if dialect == "cpuonly" else ("wang",)
    if jitter not in allowed:
        raise NotImplementedError(
            f"{dialect} dialect with jitter={jitter!r} (needs {allowed})")


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
    the gpu dialect's ``has_work`` test on the flat path."""
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


def _check_cand_plan(cand_plan, camera, nt: int) -> None:
    """A plan drives winners: it must be the one built for this tile
    stream and this camera (a plan of another camera at the same
    resolution would silently drop hits)."""
    if int(cand_plan.meta.shape[0]) != nt:
        raise ValueError("candidate plan built for a different tile stream "
                         f"({int(cand_plan.meta.shape[0])} tiles, not {nt})")
    if not plan_matches_camera(cand_plan, camera):
        raise ValueError("candidate plan built for a different camera")


def _has_work(scene, xs_p, ys_p, sh: _Shade, plan, cand_plan):
    """(nt,) bool: tiles that take the full path.  cpuonly has no sky
    shortcut (its miss radiance is the jittered sky gradient); gpu sky
    tiles are those no ray of which can hit anything."""
    nt = int(xs_p.shape[0]) // RAY_TILE
    if sh.cpuonly:
        return torch.ones(nt, dtype=torch.bool, device=xs_p.device)
    if cand_plan is not None:
        return cand_plan.meta[:, 1] > 0
    if plan is None:
        plan = camera_tile_plan(scene.camera, xs_p, ys_p, scene.accel)
    return plan[1][:, 0] < float("inf")


# --- plain versions: vectorised torch over rays ------------------------
#
# Every expression keeps the JAX kernel's op order (and the CUDA
# kernel keeps it too, built without FMA contraction), so the three
# agree to the last ulp wherever the libraries' sqrt/div/pow do.


def _slab(a, o, inv, t0, t1):
    """Per-ray slab test against one block AABB row ``a`` (8,) (or rows
    broadcast against the rays), with the robust far-plane stretch (Ize
    2013) of ``_tile_slab``."""
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


def _chunks(idx: torch.Tensor, width: int):
    step = max(1, _PLAIN_PAIRS // width)
    return idx.split(step)


class _Best:
    """Running closest-hit winners of a ray batch: (t, u, v, id, slot),
    and ``pairs``: the ray-triangle tests the kernels make for the same
    walk (live lanes only; padding lanes are skipped)."""

    def __init__(self, r, dev):
        self.t = torch.full((r,), F32_MAX, device=dev)
        self.u = torch.zeros(r, device=dev)
        self.v = torch.zeros(r, device=dev)
        self.id = torch.full((r,), -1, dtype=torch.int64, device=dev)
        self.slot = torch.zeros(r, dtype=torch.int64, device=dev)
        self.pairs = torch.zeros((), dtype=torch.int64, device=dev)

    def visit(self, ch, o, d, tri, ids, slots, det_eps, tmin):
        """Dense test of rays ``ch`` against candidates (planes ``tri``,
        global ``ids``, grid ``slots``, each (1, W) shared by the rays or
        (len(ch), W) one row per ray) with the (t, id) take rule;
        ``tmin`` a float or a per-ray (R,) tensor."""
        oc = tuple(c[ch, None] for c in o)
        dc = tuple(c[ch, None] for c in d)
        old_t = self.t[ch]
        tm = tmin[ch, None] if torch.is_tensor(tmin) else tmin
        t, u, v = _mt(oc, dc, tri, det_eps, tm, old_t[:, None])
        t = torch.where(ids >= 0, t, F32_MAX)
        min_t = t.amin(dim=1)
        at_min = t == min_t[:, None]
        id_key = torch.where(at_min & (ids >= 0), ids, _INT_MAX)
        win_id, lane = id_key.min(dim=1)
        old_id = self.id[ch]
        old_key = torch.where(old_id >= 0, old_id, _INT_MAX)
        take = (min_t < F32_MAX) & (
            (min_t < old_t) | ((min_t == old_t) & (win_id < old_key)))
        n = ch.numel()
        rr = torch.arange(n, device=ch.device)
        self.pairs += (ids >= 0).sum() * (n // ids.shape[0])
        self.t[ch] = torch.where(take, min_t, old_t)
        self.u[ch] = torch.where(take, u[rr, lane], self.u[ch])
        self.v[ch] = torch.where(take, v[rr, lane], self.v[ch])
        self.id[ch] = torch.where(take, win_id, old_id)
        self.slot[ch] = torch.where(take, slots.expand(n, -1)[rr, lane],
                                    self.slot[ch])


def _closest_plain(rows: SceneRows, o, d, alive, det_eps, tmin):
    """Closest hit by the flat block scan -> ``_Best``; ``tmin`` a float
    or a per-ray (R,) tensor."""
    r = d[0].shape[0]
    dev = d[0].device
    bs = rows.block_size
    inv = tuple(1.0 / c for c in d)
    best = _Best(r, dev)
    tmin_t = tmin if torch.is_tensor(tmin) else torch.full((r,), tmin,
                                                             device=dev)
    for b in range(rows.num_blocks):
        boxed = _slab(rows.aabb[b], o, inv, tmin_t, best.t) & alive
        sub = boxed.nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        tri = tuple(rows.tri[k, b][None, :] for k in range(9))
        ids = rows.ids[b].to(torch.int64)[None, :]
        slots = b * bs + torch.arange(bs, device=dev)[None, :]
        for ch in _chunks(sub, bs):
            best.visit(ch, o, d, tri, ids, slots, det_eps, tmin)
    return best


def _closest_binned_plain(cand_plan, o, d, alive, det_eps, tmin):
    """Closest hit of rays in tile order (ray i in tile i // RAY_TILE)
    over each tile's binned candidate chunks -> ``_Best``."""
    r = d[0].shape[0]
    dev = d[0].device
    best = _Best(r, dev)
    c = cand_plan.chunk
    stream = cand_plan.stream.reshape(cand_plan.total_chunks, CAND_ROWS, c)
    meta = cand_plan.meta[:, :2].cpu().tolist()
    alive_t = alive.reshape(-1, RAY_TILE).any(dim=1).cpu().tolist()
    for ti, ((start, cnt), live) in enumerate(zip(meta, alive_t)):
        if cnt == 0 or not live:
            continue
        ch_rows = stream[start:start + cnt]  # (cnt, 16, C)
        tri = tuple(ch_rows[:, k].reshape(1, cnt * c) for k in range(9))
        ids = torch.round(ch_rows[:, 9]).to(torch.int64).reshape(1, cnt * c)
        slots = torch.round(ch_rows[:, 11]).to(torch.int64).reshape(1, cnt * c)
        sub = ti * RAY_TILE + alive[ti * RAY_TILE:(ti + 1) * RAY_TILE
                                    ].nonzero().squeeze(1)
        for ch in _chunks(sub, cnt * c):
            best.visit(ch, o, d, tri, ids, slots, det_eps, tmin)
    return best


def _shading_normal(rows: SceneRows, d, best: _Best, cpuonly: bool):
    """Shading normal of the winner (``_finish_shading_normal``).

    - gpu: geometric sidedness, zero-length interpolation fallback,
      hemisphere alignment (``query.h:113-126``);
    - cpuonly: the normalised interpolation flipped to the side the face
      normal picks (``CPUOnly/include/ray.h:76-92``)."""
    bs = rows.block_size
    nrm = rows.norm[:, best.slot // bs, best.slot % bs]  # (12, R)
    n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z, gx, gy, gz = nrm
    u, v = best.u, best.v
    w = 1.0 - u - v
    snx = w * n0x + u * n1x + v * n2x
    sny = w * n0y + u * n1y + v * n2y
    snz = w * n0z + u * n1z + v * n2z
    dx, dy, dz = d
    dg = dx * gx + dy * gy + dz * gz
    gsign = torch.where(dg < 0.0, 1.0, -1.0)
    len_sq = snx * snx + sny * sny + snz * snz
    if cpuonly:
        s = (1.0 / torch.sqrt(torch.clamp(len_sq, min=1e-24))) * gsign
        return snx * s, sny * s, snz * s
    ogx, ogy, ogz = gx * gsign, gy * gsign, gz * gsign
    inv_len = 1.0 / torch.sqrt(torch.clamp(len_sq, min=1e-38))
    use_geom = len_sq < 1e-12
    snx = torch.where(use_geom, ogx, snx * inv_len)
    sny = torch.where(use_geom, ogy, sny * inv_len)
    snz = torch.where(use_geom, ogz, snz * inv_len)
    fsign = torch.where((snx * ogx + sny * ogy + snz * ogz) < 0.0, -1.0, 1.0)
    return snx * fsign, sny * fsign, snz * fsign


def _occluded_plain(rows: SceneRows, p, ld, dist, facing, det_eps,
                    shadow_tmin, tmax=None):
    """Any hit toward each light for ``facing`` rays: blocks are culled
    by a slab test on [shadow_tmin, dist] and triangles tested on
    [shadow_tmin, tmax] (``tmax`` defaults to ``dist``; ``shadow_tmin``
    a float or a per-ray tensor); a ray leaves the walk at its first
    hit.  -> (blocked, pairs): ``pairs`` counts the tests the kernels
    make, which stop at that hit (the dense test here runs the whole
    block)."""
    tmax = dist if tmax is None else tmax
    inv = tuple(1.0 / c for c in ld)
    blocked = torch.zeros_like(facing)
    pairs = torch.zeros((), dtype=torch.int64, device=dist.device)
    tmin_t = (shadow_tmin if torch.is_tensor(shadow_tmin)
              else torch.full_like(dist, shadow_tmin))
    # every block's slab test at once: its window does not change
    slabs = _slab(rows.aabb.T[:, None, :], tuple(c[:, None] for c in p),
                  tuple(c[:, None] for c in inv), tmin_t[:, None],
                  dist[:, None])  # (R, L)
    for b in range(rows.num_blocks):
        cand = facing & ~blocked
        if not bool(cand.any()):
            break
        boxed = slabs[:, b] & cand
        sub = boxed.nonzero().squeeze(1)
        if sub.numel() == 0:
            continue
        tri = tuple(rows.tri[k, b][None, :] for k in range(9))
        live = rows.ids[b][None, :] >= 0
        # live lanes up to and including each lane: a ray blocked in this
        # block was tested against those up to its first hit
        upto = live.cumsum(dim=1)[0]
        for ch in _chunks(sub, rows.block_size):
            t, _, _ = _mt(tuple(c[ch, None] for c in p),
                          tuple(c[ch, None] for c in ld), tri, det_eps,
                          tmin_t[ch, None], tmax[ch, None])
            hits = live & (t < F32_MAX)
            hit = hits.any(dim=1)
            first = hits.to(torch.int32).argmax(dim=1)
            pairs += torch.where(hit, upto[first], upto[-1]).sum()
            blocked[ch] = blocked[ch] | hit
    return blocked, pairs


def _hemisphere_plain(state, n):
    """``random_on_hemisphere`` (``query.h:66-71``) per ray."""
    state, vec = rnglib.random_unit_vector(state)
    hx, hy, hz = vec.unbind(-1)
    dot = hx * n[0] + hy * n[1] + hz * n[2]
    fs = torch.where(dot > 0.0, 1.0, -1.0)
    return state, (hx * fs, hy * fs, hz * fs)


def _visibility_plain(rows, sh: _Shade, li, radius, p, to, ld, dist,
                      facing, hit, rng):
    """Light ``li``'s visibility for every ray -> (vis, rng, pairs).

    gpu: one hard-shadow walk.  cpuonly (``ShadowVisibility``,
    ``CPUOnly/raytracer.h:121-168``): ``shadow_samples`` walks toward
    disk samples of an area light, one toward a point light's center;
    the disk draws advance the rng of hit rays only."""
    pairs = []

    def walk(sd, d_s, tmax):
        blocked, n = _occluded_plain(rows, p, sd, d_s, facing, sh.det_eps,
                                     sh.shadow_tmin, tmax)
        pairs.append(n)
        return blocked

    if not sh.cpuonly:
        vis = torch.where(facing & ~walk(ld, dist, None), 1.0, 0.0)
        return vis, rng, sum(pairs)

    def toward(st):
        d_s = torch.sqrt(torch.clamp(st[0] * st[0] + st[1] * st[1]
                                     + st[2] * st[2], min=1e-24))
        inv_s = 1.0 / d_s
        blocked = walk(tuple(c * inv_s for c in st), d_s, d_s - sh.shadow_eps)
        return torch.where(blocked, 0.0, 1.0)

    if radius <= 0.0:
        return toward(to) / 1.0, rng, sum(pairs)
    # disk basis around w = (p - light) / |p - light| (raytracer.h:88-93)
    wx, wy, wz = -ld[0], -ld[1], -ld[2]
    use_y = wx.abs() > 0.9
    a0 = torch.where(use_y, 0.0, 1.0)
    a1 = torch.where(use_y, 1.0, 0.0)
    tx = a1 * wz
    ty = -a0 * wz
    tz = a0 * wy - a1 * wx
    t_inv = 1.0 / torch.sqrt(tx * tx + ty * ty + tz * tz)
    tx, ty, tz = tx * t_inv, ty * t_inv, tz * t_inv
    bx = wy * tz - wz * ty
    by = wz * tx - wx * tz
    bz = wx * ty - wy * tx
    lpos = rows.lights[li, 0:3]
    sel = hit.nonzero().squeeze(1)
    unocc = torch.zeros_like(dist)
    for _ in range(sh.shadow_samples):
        s_d, disk = rnglib.random_in_unit_disk(rng[sel])
        rng = rng.index_put((sel,), s_d)
        dxs = torch.zeros_like(dist).index_put((sel,), disk[:, 0])
        dys = torch.zeros_like(dist).index_put((sel,), disk[:, 1])
        spos = [lpos[0] + (tx * dxs + bx * dys) * radius,
                lpos[1] + (ty * dxs + by * dys) * radius,
                lpos[2] + (tz * dxs + bz * dys) * radius]
        unocc = unocc + toward([spos[k] - p[k] for k in range(3)])
    return unocc / float(sh.shadow_samples), rng, sum(pairs)


def _bounce_plain(rows: SceneRows, st: dict, sh: _Shade, cand_plan=None,
                  capture=None):
    """One closest hit + shade + RR step (the loop body of
    ``TraceRayIterative``, ``query.h:165-216``, or of CPUOnly's
    ``TraceRay``) on the flat per-ray state ``st``, updated in place.
    Dead rays pass through unchanged.  ``cand_plan``: walk the binned
    candidates (depth 0, rays in tile order) instead of the blocks.
    ``capture``: a dict that receives the oracle rows of the gpu dialect
    (``DIFF_ROWS``), dead rays at their defaults.  Returns the
    ray-triangle pairs the kernels test for this step (a 0-d tensor)."""
    alive = st["alive"] > 0.0
    dev = alive.device
    big = torch.tensor(1e30, device=dev)
    o = tuple(torch.where(alive, c, big) for c in st["bo"])
    d = st["bd"]
    if cand_plan is not None:
        best = _closest_binned_plain(cand_plan, o, d, alive, sh.det_eps,
                                     sh.tmin)
    else:
        best = _closest_plain(rows, o, d, alive, sh.det_eps, sh.tmin)
    t_hit = best.t
    hit = t_hit < F32_MAX
    snx, sny, snz = _shading_normal(rows, d, best, sh.cpuonly)
    one = torch.ones_like(t_hit)
    zero = torch.zeros_like(t_hit)
    nx = torch.where(hit, snx, zero)
    ny = torch.where(hit, sny, zero)
    nz = torch.where(hit, snz, one)
    bs = rows.block_size
    obj = torch.where(hit, rows.obj[best.slot // bs, best.slot % bs]
                      .to(torch.int64), 0)
    m = rows.mats[obj]  # (R, 16): the winner's material (object 0 on a miss)

    # --- direct light (ShadeDirect, shader.h:65-110) ---
    px = torch.where(hit, o[0] + t_hit * d[0] + nx * sh.shadow_eps, big)
    py = torch.where(hit, o[1] + t_hit * d[1] + ny * sh.shadow_eps, big)
    pz = torch.where(hit, o[2] + t_hit * d[2] + nz * sh.shadow_eps, big)
    vx, vy, vz = -d[0], -d[1], -d[2]
    ndotv = torch.clamp(nx * vx + ny * vy + nz * vz, min=0.0)
    lo = [m[:, 0] * 0.05 + m[:, 10], m[:, 1] * 0.05 + m[:, 11],
          m[:, 2] * 0.05 + m[:, 12]]
    rng0 = st["rng"]
    rng_s = rng0
    pairs = best.pairs
    dist_floor = 1e-24 if sh.cpuonly else 1e-38
    vis_bits = torch.zeros(t_hit.shape, dtype=torch.int64, device=dev)
    radii = rows.lights[:, 6].cpu().tolist()
    for li, radius in enumerate(radii):
        lrow = rows.lights[li]
        tox, toy, toz = lrow[0] - px, lrow[1] - py, lrow[2] - pz
        dist = torch.sqrt(torch.clamp(tox * tox + toy * toy + toz * toz,
                                      min=dist_floor))
        inv_dist = 1.0 / dist
        ldx, ldy, ldz = tox * inv_dist, toy * inv_dist, toz * inv_dist
        ndotl = torch.clamp(nx * ldx + ny * ldy + nz * ldz, min=0.0)
        facing = hit & (ndotl > 0.0) & (ndotv > 0.0)
        vis, rng_s, n = _visibility_plain(
            rows, sh, li, radius, (px, py, pz), (tox, toy, toz),
            (ldx, ldy, ldz), dist, facing, hit & alive, rng_s)
        pairs = pairs + n
        vis_bits = vis_bits | torch.where(vis > 0.0, 1 << li, 0)
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
    if sh.cpuonly:
        # miss shader: the sky gradient on the unit direction
        # (CPUOnly/raytracer.h:226-229)
        skyt = 0.5 * (d[2] + 1.0)
        miss = [(1.0 - skyt) + skyt * 0.5, (1.0 - skyt) + skyt * 0.7,
                (1.0 - skyt) + skyt * 1.0]
    else:
        miss = rows.cam[12:15]
    rd = [st["rd"][c] + st["tp"][c] * (missed_f * miss[c] + found_f * lo[c])
          for c in range(3)]
    kd, kr = m[:, 3], m[:, 9]
    total = kd + kr
    can_bounce = hit & alive & (total > 0.0)
    s_xi, xi = rnglib.rng_next(rng_s)
    rng1 = torch.where(can_bounce, s_xi, rng_s)
    ratio = kd / torch.where(total > 0.0, total, 1.0)
    if sh.diffuse_bounce:
        take_diff = can_bounce & (xi < ratio)
    else:
        take_diff = torch.zeros_like(can_bounce)
    take_mirror = can_bounce & ~take_diff
    if sh.cpuonly:
        # CPUOnly mirrors only when kr > 0 (raytracer.h:249)
        take_mirror = take_mirror & (kr > 0.0)
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
    ndotl_h = torch.clamp(nx * hx + ny * hy + nz * hz, min=0.0)
    # diffuse throughput: albedo * 2 N.L (query.h:195-199), with CPUOnly's
    # extra (kd + kr) factor (raytracer.h:240-248)
    dtp = total * (2.0 * ndotl_h) if sh.cpuonly else 2.0 * ndotl_h
    # mirror: GPU scales by kr (query.h:202-205); CPUOnly by
    # (diffuse_bounce ? kd + kr : kr) (raytracer.h:249-255)
    mirror_scale = total if (sh.cpuonly and sh.diffuse_bounce) else kr
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
        tsc = td_f * (m[:, c] * dtp) + (1.0 - td_f) * (m[:, 4 + c]
                                                       * mirror_scale)
        tp.append(b_f * (st["tp"][c] * tsc) + (1.0 - b_f) * st["tp"][c])
    tiny = (tp[0] < 1e-4) & (tp[1] < 1e-4) & (tp[2] < 1e-4)
    new_alive = torch.where(bounced & ~tiny, 1.0, 0.0)

    st["bo"] = [torch.where(alive, a, b_) for a, b_ in zip(bo, st["bo"])]
    st["bd"] = [torch.where(alive, a, b_) for a, b_ in zip(bd, st["bd"])]
    st["tp"] = [torch.where(alive, a, b_) for a, b_ in zip(tp, st["tp"])]
    st["rd"] = [torch.where(alive, a, b_) for a, b_ in zip(rd, st["rd"])]
    st["alive"] = torch.where(alive, new_alive, st["alive"])
    # the disk draws advanced hit rays only, the RR draw bouncing ones
    st["rng"] = torch.where(alive, rng1, rng0)
    if capture is not None:
        dec = (torch.where(hit & alive, 1, 0) | torch.where(take_diff, 2, 0)
               | torch.where(take_mirror, 4, 0)
               | torch.where(st["alive"] > 0.0, 8, 0))
        capture.update(t=t_hit, u=best.u, v=best.v, id=best.id,
                       vis=vis_bits, dec=dec)
    return pairs


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


def _primary_state(rows: SceneRows, xs_p, ys_p, sample, jitter, work):
    """Camera rays of sample index ``sample`` (offset included): Wang
    jitter (``query.cu:36-43``) or pixel centers (``render.cpp:127-128``),
    rng seeded ``make_rng_seed(x, y, sample)``; rays outside ``work``
    tiles start dead."""
    np_rays = int(xs_p.shape[0])
    x = xs_p.to(torch.int64)
    y = ys_p.to(torch.int64)
    h = rnglib.make_rng_seed(x, y, int(sample))
    if jitter == "center":
        jx = jy = 0.5
    else:
        jx, jy = rnglib.pixel_jitter(x, y, int(sample))
    pxf = x.to(torch.float32) + jx
    pyf = y.to(torch.float32) + jy
    cam = rows.cam
    c = cam[0:3]
    r = [(cam[3 + k] + pxf * cam[6 + k] + pyf * cam[9 + k]) - c[k]
         for k in range(3)]
    rlen = torch.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2])
    ones = torch.ones(np_rays, device=xs_p.device)
    alive = torch.where(work.repeat_interleave(RAY_TILE), 1.0, 0.0)
    return dict(bo=[c[k].expand(np_rays) for k in range(3)],
                bd=[r[k] / rlen for k in range(3)],
                tp=[ones, ones, ones], rd=[ones * 0.0] * 3,
                alive=alive, rng=h)


def _tally(stats, pairs) -> None:
    """Add a plain call's ray-triangle pairs to ``stats["pairs"]``."""
    if stats is not None:
        stats["pairs"] = stats.get("pairs", 0) + int(pairs)


def _plain_shade(diffuse_bounce, det_eps, tmin, shadow_eps, shadow_tmin,
                 dialect, shadow_samples, jitter=None):
    if jitter is not None:
        _check_jitter(jitter, dialect)
    return _Shade(bool(diffuse_bounce), det_eps, tmin, shadow_eps,
                  shadow_tmin, dialect, int(shadow_samples))


def emit_tiles_plain(rows: SceneRows, xs_p, ys_p, has_work, sample_offset,
                     diffuse_bounce, det_eps=1e-8, tmin=1e-4,
                     shadow_eps=1e-3, shadow_tmin=1e-4, *, dialect="gpu",
                     jitter="wang", shadow_samples=1, cand_plan=None,
                     stats=None):
    """Plain version of the emit kernel on a padded pixel stream;
    ``has_work`` (nt,) bool (``_has_work``).  ``stats``: optional dict
    whose ``"pairs"`` entry grows by the ray-triangle pairs the kernel
    tests on these inputs (as for every plain version below)."""
    sh = _plain_shade(diffuse_bounce, det_eps, tmin, shadow_eps,
                      shadow_tmin, dialect, shadow_samples, jitter)
    np_rays = int(xs_p.shape[0])
    nt = np_rays // RAY_TILE
    st = _primary_state(rows, xs_p, ys_p, sample_offset, jitter, has_work)
    _tally(stats, _bounce_plain(rows, st, sh, cand_plan))
    # tiles no ray of which can hit anything: dead state with a unit
    # direction (a zero one poisons later 1/d) and the miss radiance
    work = has_work.repeat_interleave(RAY_TILE)
    zeros = torch.zeros(np_rays, device=xs_p.device)
    ones = torch.ones(np_rays, device=xs_p.device)
    cam = rows.cam
    dead = dict(bo=[zeros] * 3, bd=[zeros, zeros, ones], tp=[zeros] * 3,
                rd=[cam[12 + k].expand(np_rays) for k in range(3)])
    for key in ("bo", "bd", "tp", "rd"):
        st[key] = [torch.where(work, a, b_) for a, b_ in zip(st[key], dead[key])]
    st["alive"] = torch.where(work, st["alive"], zeros)
    st["rng"] = torch.where(work, st["rng"], 0)
    return _pack(st, nt, RAY_TILE)


def _pack_diff(cap: dict, nt: int, rt: int) -> torch.Tensor:
    """Oracle rows -> the (nt*8, rt) float32 block of ``diff_out``."""
    planes = [cap[k].to(torch.float32) for k in DIFF_ROWS]
    planes += [torch.zeros_like(planes[0])] * (8 - len(planes))
    return torch.stack([pl.reshape(nt, rt) for pl in planes], dim=1).reshape(
        nt * 8, rt).contiguous()


def bounce_step_tiles_plain(rows: SceneRows, state, rng_state,
                            diffuse_bounce, det_eps=1e-8, tmin=1e-4,
                            shadow_eps=1e-3, shadow_tmin=1e-4, *,
                            dialect="gpu", shadow_samples=1, diff_out=False,
                            cand_plan=None, stats=None):
    """Plain version of the bounce-step kernel; ``diff_out`` and
    ``cand_plan`` as in ``bounce_step_tiles``."""
    sh = _plain_shade(diffuse_bounce, det_eps, tmin, shadow_eps,
                      shadow_tmin, dialect, shadow_samples)
    _check_diff(sh, diff_out, cand_plan, state.shape[1])
    nt = state.shape[0] // _ST_ROWS
    st = _unpack(state, rng_state)
    cap = {} if diff_out else None
    _tally(stats, _bounce_plain(rows, st, sh, cand_plan, cap))
    out = _pack(st, nt, state.shape[1])
    return out + (_pack_diff(cap, nt, state.shape[1]),) if diff_out else out


def _bounces_plain(rows, st, sh, first_depth, max_bounces):
    pairs = 0
    for _ in range(first_depth, int(max_bounces)):
        if not bool((st["alive"] > 0.0).any()):
            break
        pairs = pairs + _bounce_plain(rows, st, sh)
    return pairs


def resume_tiles_plain(rows: SceneRows, state, rng_state, max_bounces,
                       diffuse_bounce, det_eps=1e-8, tmin=1e-4,
                       shadow_eps=1e-3, shadow_tmin=1e-4, *, dialect="gpu",
                       shadow_samples=1, stats=None):
    """Plain version of the resume kernel: bounces 1..max_bounces-1."""
    sh = _plain_shade(diffuse_bounce, det_eps, tmin, shadow_eps,
                      shadow_tmin, dialect, shadow_samples)
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    st = _unpack(state, rng_state)
    _tally(stats, _bounces_plain(rows, st, sh, 1, max_bounces))
    return tuple(c.reshape(nt, rt) for c in st["rd"])


def render_tiles_plain(rows: SceneRows, xs_p, ys_p, has_work, spp,
                       sample_offset, max_bounces, terminal, diffuse_bounce,
                       det_eps=1e-8, tmin=1e-4, shadow_eps=1e-3,
                       shadow_tmin=1e-4, *, dialect="gpu", jitter="wang",
                       shadow_samples=1, cand_plan=None, stats=None):
    """Plain version of the render kernel -> (r, g, b) sums over ``spp``
    samples, each (nt, RAY_TILE).  Per sample: depth 0 (binned or flat),
    then, unless ``terminal``, bounces 1..max-1; the sample adds
    ``clip(rd, 0, 1)`` (gpu) or ``rd`` (cpuonly).  gpu sky tiles
    (``has_work`` False) add ``clip(miss)`` per sample."""
    sh = _plain_shade(diffuse_bounce, det_eps, tmin, shadow_eps,
                      shadow_tmin, dialect, shadow_samples, jitter)
    nt = int(xs_p.shape[0]) // RAY_TILE
    work = has_work.repeat_interleave(RAY_TILE)
    sky = [torch.clamp(rows.cam[12 + c], 0.0, 1.0) for c in range(3)]
    acc = [torch.zeros(nt * RAY_TILE, device=xs_p.device) for _ in range(3)]
    for s in range(int(spp)):
        st = _primary_state(rows, xs_p, ys_p, int(sample_offset) + s, jitter,
                            has_work)
        pairs = _bounce_plain(rows, st, sh, cand_plan)
        if not terminal:
            pairs = pairs + _bounces_plain(rows, st, sh, 1, max_bounces)
        _tally(stats, pairs)
        for c in range(3):
            rd = st["rd"][c] if sh.cpuonly else torch.clamp(st["rd"][c],
                                                            0.0, 1.0)
            acc[c] = acc[c] + torch.where(work, rd, sky[c])
    return tuple(a.reshape(nt, RAY_TILE) for a in acc)


# --- kernel wrappers ---------------------------------------------------

def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _scene_args(rows: SceneRows, sh: _Shade, cand_plan=None):
    from ._native import SceneArgs

    for name in ("cam", "lights", "mats", "tri", "norm", "aabb"):
        t = getattr(rows, name)
        if t.dtype != torch.float32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"scene operand {name}: need contiguous CUDA float32")
    for name in ("ids", "obj"):
        t = getattr(rows, name)
        if t.dtype != torch.int32 or not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"scene operand {name}: need contiguous CUDA int32")
    meta = stream = 0
    chunk = 0
    if cand_plan is not None:
        for t, dt in ((cand_plan.meta, torch.int32),
                      (cand_plan.stream, torch.float32)):
            if t.dtype != dt or not t.is_cuda or not t.is_contiguous():
                raise ValueError(f"candidate plan: need contiguous CUDA {dt}")
        meta, stream = cand_plan.meta.data_ptr(), cand_plan.stream.data_ptr()
        chunk = int(cand_plan.chunk)
    return SceneArgs(
        cam=rows.cam.data_ptr(), lights=rows.lights.data_ptr(),
        mats=rows.mats.data_ptr(), tri=rows.tri.data_ptr(),
        norm=rows.norm.data_ptr(), ids=rows.ids.data_ptr(),
        obj=rows.obj.data_ptr(), aabb=rows.aabb.data_ptr(),
        cand_meta=meta, cand_stream=stream,
        n_lights=int(rows.lights.shape[0]), n_objects=int(rows.mats.shape[0]),
        num_blocks=rows.num_blocks, block_size=rows.block_size,
        diffuse_bounce=int(sh.diffuse_bounce), cpuonly=int(sh.cpuonly),
        shadow_samples=int(sh.shadow_samples), cand_chunk=chunk,
        det_eps=sh.det_eps, tmin=sh.tmin, shadow_eps=sh.shadow_eps,
        shadow_tmin=sh.shadow_tmin)


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


def _shade_of(scene, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
              shadow_samples) -> _Shade:
    if dialect != scene.dialect:
        raise ValueError(f"dialect={dialect!r} for a {scene.dialect} scene")
    return _Shade(bool(scene.diffuse_bounce), det_eps, tmin, shadow_eps,
                  shadow_tmin, dialect, int(shadow_samples))


def _pixel_stream(xs, ys):
    xs, ys, n, np_rays = _pad_tiles(xs, ys)
    return (xs.to(torch.int32).contiguous(), ys.to(torch.int32).contiguous(),
            n, np_rays)


def emit_tiles(scene, xs, ys, sample_offset=0, *, det_eps: float = 1e-8,
               tmin: float = 1e-4, shadow_eps: float = 1e-3,
               shadow_tmin: float = 1e-4, dialect: str = "gpu",
               jitter: str = "wang", shadow_samples: int = 1, plan=None,
               cand_plan=None, rows: SceneRows = None):
    """Depth-0 pass: camera rays + direct light + the RR bounce decision.

    Returns (state (nt*16, RAY_TILE) f32, rng (nt*8, RAY_TILE) i32).
    ``plan``: optional ``camera_tile_plan`` result for the padded stream
    (sample-independent, so frame loops build it once); ``cand_plan``:
    optional binned plan (``ops.binned``) built for exactly this stream
    and camera, walked instead of the blocks; ``rows``: optional
    prebuilt ``_scene_rows``."""
    sh = _shade_of(scene, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
                   shadow_samples)
    _check_jitter(jitter, dialect)
    xs, ys, _, np_rays = _pixel_stream(xs, ys)
    nt = np_rays // RAY_TILE
    rows = _scene_rows(scene, scene.accel) if rows is None else rows
    if cand_plan is not None:
        _check_cand_plan(cand_plan, scene.camera, nt)
    has_work = _has_work(scene, xs, ys, sh, plan, cand_plan)
    if _device_kind(xs) == "cpu":
        return emit_tiles_plain(
            rows, xs, ys, has_work, int(sample_offset), sh.diffuse_bounce,
            det_eps, tmin, shadow_eps, shadow_tmin, dialect=dialect,
            jitter=jitter, shadow_samples=shadow_samples, cand_plan=cand_plan)
    from ._native import load

    lib = load()
    dev = xs.device
    hw = has_work.to(torch.int32).contiguous()
    st = torch.empty(nt * _ST_ROWS, RAY_TILE, dtype=torch.float32, device=dev)
    rng = torch.empty(nt * 8, RAY_TILE, dtype=torch.int32, device=dev)
    # scratch of the kernel's three launches: the shadow list (a ray's
    # walks: one a light, or, cpuonly, up to one a disk sample), its
    # flags, and each ray's closest hit
    rounds = int(rows.lights.shape[0]) * (sh.shadow_samples if sh.cpuonly
                                          else 1)
    counts = torch.empty(2, dtype=torch.int32, device=dev)
    walks = torch.empty(np_rays * rounds, dtype=torch.int32, device=dev)
    flags = torch.empty(np_rays * rounds, dtype=torch.uint8, device=dev)
    hits = torch.empty(5 * np_rays, dtype=torch.float32, device=dev)
    args = _scene_args(rows, sh, cand_plan)
    err = lib.rt_emit(ctypes.byref(args), _ptr(xs), _ptr(ys), _ptr(hw),
                      np_rays, RAY_TILE, int(sample_offset),
                      int(jitter == "center"), _ptr(st), _ptr(rng),
                      _ptr(counts), _ptr(walks), _ptr(flags), _ptr(hits),
                      rounds, _stream())
    _raise_on(lib, err, "emit")
    emit_tiles.launches += 1
    return st, rng


def _check_diff(sh: _Shade, diff_out: bool, cand_plan, rt: int) -> None:
    """The oracle rows exist in the gpu dialect only, and the binned
    bounce serves the oracle's depth 0 only (the JAX asserts,
    ``megakernel.py:2743-2752``)."""
    if diff_out and sh.cpuonly:
        raise ValueError("diff_out: the oracle rows exist in the gpu "
                         "dialect only")
    if cand_plan is not None and (not diff_out or rt != RAY_TILE):
        raise ValueError("a binned bounce needs diff_out=True and "
                         f"{RAY_TILE}-ray tiles")


def bounce_step_tiles(scene, state, rng_state, *, det_eps: float = 1e-8,
                      tmin: float = 1e-4, shadow_eps: float = 1e-3,
                      shadow_tmin: float = 1e-4, dialect: str = "gpu",
                      shadow_samples: int = 1, diff_out: bool = False,
                      cand_plan=None, rows: SceneRows = None):
    """One bounce over packed state tiles -> (state', rng').  The JAX
    version's ``order``/``entry`` plan operands are not taken: the port
    always runs the flat scan, which needs no plan.

    ``diff_out`` (gpu dialect): also return the (nt*8, rt) float32 oracle
    rows of the differentiable integrator -> (state', rng', diff): per
    ray [winner t (F32_MAX on a miss), u, v, global triangle id (-1),
    per-light visibility bits, decision bits (1 found, 2 diffuse, 4
    mirror, 8 alive after), 0, 0], integers as exact floats, dead rays
    at those defaults.  ``cand_plan`` (with ``diff_out`` only): a binned
    camera plan (``ops.binned``) built for this tile stream and camera;
    the closest hit then walks each tile's candidates (depth 0)."""
    sh = _shade_of(scene, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
                   shadow_samples)
    _check_rows(state, rng_state)
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    _check_diff(sh, diff_out, cand_plan, rt)
    if cand_plan is not None:
        _check_cand_plan(cand_plan, scene.camera, nt)
    rows = _scene_rows(scene, scene.accel) if rows is None else rows
    if _device_kind(state) == "cpu":
        return bounce_step_tiles_plain(
            rows, state, rng_state, sh.diffuse_bounce, det_eps, tmin,
            shadow_eps, shadow_tmin, dialect=dialect,
            shadow_samples=shadow_samples, diff_out=diff_out,
            cand_plan=cand_plan)
    from ._native import load

    lib = load()
    state = state.contiguous()
    rng_state = rng_state.contiguous()
    st_out = torch.empty_like(state)
    rng_out = torch.empty_like(rng_state)
    diff = (torch.empty(nt * 8, rt, dtype=torch.float32, device=state.device)
            if diff_out else None)
    args = _scene_args(rows, sh, cand_plan)
    err = lib.rt_bounce_step(ctypes.byref(args), _ptr(state), _ptr(rng_state),
                             nt * rt, rt, _ptr(st_out), _ptr(rng_out),
                             _ptr(diff) if diff_out else None, _stream())
    _raise_on(lib, err, "bounce_step")
    bounce_step_tiles.launches += 1
    if diff_out:
        bounce_step_tiles.diff_launches += 1
        bounce_step_tiles.binned_launches += int(cand_plan is not None)
        return st_out, rng_out, diff
    return st_out, rng_out


def resume_tiles(scene, state, rng_state, *, det_eps: float = 1e-8,
                 tmin: float = 1e-4, shadow_eps: float = 1e-3,
                 shadow_tmin: float = 1e-4, dialect: str = "gpu",
                 shadow_samples: int = 1, rows: SceneRows = None):
    """Bounce depths 1..max_bounces-1 -> per-ray radiance (r, g, b), each
    (nt, RAY_TILE), in the state's ray order."""
    sh = _shade_of(scene, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
                   shadow_samples)
    _check_rows(state, rng_state)
    rows = _scene_rows(scene, scene.accel) if rows is None else rows
    if _device_kind(state) == "cpu":
        return resume_tiles_plain(
            rows, state, rng_state, scene.max_bounces, sh.diffuse_bounce,
            det_eps, tmin, shadow_eps, shadow_tmin, dialect=dialect,
            shadow_samples=shadow_samples)
    from ._native import load

    lib = load()
    state = state.contiguous()
    rng_state = rng_state.contiguous()
    nt = state.shape[0] // _ST_ROWS
    rt = state.shape[1]
    outs = [torch.empty(nt, rt, dtype=torch.float32, device=state.device)
            for _ in range(3)]
    args = _scene_args(rows, sh)
    err = lib.rt_resume(ctypes.byref(args), _ptr(state), _ptr(rng_state),
                        nt * rt, rt, int(scene.max_bounces), *map(_ptr, outs),
                        _stream())
    _raise_on(lib, err, "resume")
    resume_tiles.launches += 1
    return tuple(outs)


def render_tiles(scene, xs, ys, spp: int, sample_offset=0, *,
                 det_eps: float = 1e-8, tmin: float = 1e-4,
                 shadow_eps: float = 1e-3, shadow_tmin: float = 1e-4,
                 dialect: str = "gpu", jitter: str = "wang",
                 shadow_samples: int = 1, plan=None, cand_plan=None,
                 rows: SceneRows = None):
    """Monolithic render of swizzled pixel tiles -> (N, 3) radiance SUM
    over ``spp`` samples (callers divide).  Terminal scenes of the gpu
    dialect (no diffuse bounce, every kr == 0) stop after depth 0 (the
    JAX V1 pass); every other scene runs the bounce loop (V2).
    ``plan``/``cand_plan``/``rows`` as in ``emit_tiles``."""
    sh = _shade_of(scene, det_eps, tmin, shadow_eps, shadow_tmin, dialect,
                   shadow_samples)
    _check_jitter(jitter, dialect)
    xs, ys, n, np_rays = _pixel_stream(xs, ys)
    nt = np_rays // RAY_TILE
    rows = _scene_rows(scene, scene.accel) if rows is None else rows
    if cand_plan is not None:
        _check_cand_plan(cand_plan, scene.camera, nt)
    has_work = _has_work(scene, xs, ys, sh, plan, cand_plan)
    terminal = (bool(scene.terminal_only) and not sh.diffuse_bounce
                and not sh.cpuonly)
    if _device_kind(xs) == "cpu":
        outs = render_tiles_plain(
            rows, xs, ys, has_work, spp, int(sample_offset),
            scene.max_bounces, terminal, sh.diffuse_bounce, det_eps, tmin,
            shadow_eps, shadow_tmin, dialect=dialect, jitter=jitter,
            shadow_samples=shadow_samples, cand_plan=cand_plan)
    else:
        from ._native import load

        lib = load()
        hw = has_work.to(torch.int32).contiguous()
        outs = [torch.empty(nt, RAY_TILE, dtype=torch.float32,
                            device=xs.device) for _ in range(3)]
        args = _scene_args(rows, sh, cand_plan)
        err = lib.rt_render(ctypes.byref(args), _ptr(xs), _ptr(ys), _ptr(hw),
                            np_rays, RAY_TILE, int(spp), int(sample_offset),
                            int(jitter == "center"), int(terminal),
                            int(scene.max_bounces), *map(_ptr, outs),
                            _stream())
        _raise_on(lib, err, "render")
        render_tiles.launches += 1
    return torch.stack([a.reshape(np_rays)[:n] for a in outs], dim=1)


# launch counters: each wrapper adds one where it launches its kernel;
# bounce_step's oracle (diff_out) and binned launches are also counted apart
_WRAPPERS = {"emit": emit_tiles, "bounce_step": bounce_step_tiles,
             "resume": resume_tiles, "render": render_tiles}
_VARIANTS = {"bounce_step[diff]": "diff_launches",
             "bounce_step[binned]": "binned_launches"}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
    for attr in _VARIANTS.values():
        setattr(bounce_step_tiles, attr, 0)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def variant_launch_counts() -> dict:
    """bounce_step's oracle and binned launches since the last reset
    (each also counted under "bounce_step")."""
    return {name: getattr(bounce_step_tiles, attr)
            for name, attr in _VARIANTS.items()}


reset_launch_counts()
