"""Per-tile triangle candidate lists: the binned camera plan.

PyTorch port of ``raytracinginonesemester_tpu.ops.binned``.  The plan
bins triangles to ray tiles once per (scene, camera): an interval slab
test of each tile's jitter-inflated corner-ray direction hull against
per-triangle AABBs (the math of ``megakernel.camera_tile_plan`` at
triangle granularity), with a block-level prefilter.  Each tile's
candidate slots, in ascending grid-slot order, are packed into chunks of
``chunk`` lanes padded with -1, CSR style: ``meta[tile] = [first chunk,
chunk count, 0 x6]`` and ``stream`` holds ``CAND_ROWS`` float32 rows per
chunk:

- rows 0-8: the triangle planes v0 xyz, e1 xyz, e2 xyz (0 on padding);
- row 9: the global triangle id (-1 on padding);
- row 10: the home row (grid slot // (block_size // nq));
- row 11: the flat grid slot (block * block_size + lane), which the
  port's kernels read winner attributes by;
- rows 12-15: zero.

Rows 0-10 equal the JAX layout.  The build runs on the plan's device
with tensor ops (the JAX build is host numpy with a loop over tiles).

The emit and render kernels walk a tile's chunks instead of the block
grid at depth 0; the (t, global id) take rule makes the winner
independent of visit order, and the plan is a conservative superset of
every jittered camera ray's candidates, so images equal the block
walk's.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

__all__ = ["CAND_ROWS", "CandidatePlan", "build_camera_candidate_plan",
           "candidate_plan_stats", "plan_candidate_gids", "refresh_stream",
           "plan_fingerprint", "plan_matches_camera"]

CAND_ROWS = 16
_ID_ROW, _HOME_ROW, _SLOT_ROW = 9, 10, 11
# tiles per slab-test batch of the build: bounds each (tiles, T)
# temporary at a few million elements
_BUILD_PAIRS = 1 << 23


class _TensorsKey:
    """Exact hashable key of some tensors, read without a device copy:
    the static ``sizes`` and each tensor's identity and in-place version
    counter, so a new tensor or an in-place write gives another key.  An
    identity is unique only while its object lives, so the key also
    holds weak references: a key whose tensors were freed equals
    nothing."""

    def __init__(self, sizes: tuple, tensors):
        self._static = tuple(sizes) + tuple((id(t), t._version)
                                            for t in tensors)
        self._refs = tuple(weakref.ref(t) for t in tensors)

    def __hash__(self):
        return hash(self._static)

    def __eq__(self, other):
        return (isinstance(other, _TensorsKey)
                and self._static == other._static
                and all(a() is not None and a() is b()
                        for a, b in zip(self._refs, other._refs)))


def _camera_tensors(camera):
    return (camera.center, camera.pixel00_loc, camera.pixel_delta_u,
            camera.pixel_delta_v)


@dataclasses.dataclass(frozen=True)
class CandidatePlan:
    """``stream`` (total_chunks * CAND_ROWS, chunk) float32, ``meta``
    (nt, 8) int32 [first chunk, chunk count, 0 x6] per ray tile;
    ``camera`` is the key of the camera frame's tensors (center, pixel00,
    du, dv) the plan was built for, checked before the plan is used
    (``plan_matches_camera``)."""

    stream: torch.Tensor
    meta: torch.Tensor
    chunk: int
    total_chunks: int
    camera: _TensorsKey


def plan_matches_camera(plan: CandidatePlan, camera) -> bool:
    """Whether ``plan`` was built for this camera: the same frame
    tensors, unwritten since (no device copy).  Equal values in other
    tensors do not match."""
    return _TensorsKey((), _camera_tensors(camera)) == plan.camera


def _tile_dir_hulls(camera, xs_p, ys_p, ray_tile):
    """Jitter-inflated per-tile camera-ray direction boxes (nt, 3)."""
    nt = int(xs_p.shape[0]) // ray_tile
    xs_t = xs_p.reshape(nt, ray_tile).to(torch.float32)
    ys_t = ys_p.reshape(nt, ray_tile).to(torch.float32)
    px_lo = xs_t.amin(dim=1) - 0.5
    px_hi = xs_t.amax(dim=1) + 0.5
    py_lo = ys_t.amin(dim=1) - 0.5
    py_hi = ys_t.amax(dim=1) + 0.5
    base = camera.pixel00_loc - camera.center
    du, dv = camera.pixel_delta_u, camera.pixel_delta_v
    corners = torch.stack([base[None] + a[:, None] * du[None]
                           + b[:, None] * dv[None]
                           for a in (px_lo, px_hi) for b in (py_lo, py_hi)])
    return corners.amin(dim=0), corners.amax(dim=0)


def _hull_box_pass(d_lo, d_hi, c, boxes_lo, boxes_hi):
    """Interval slab test: tiles (origin ``c``, direction boxes (n, 3))
    against AABBs (m, 3) -> (n, m) bool.  Conservative, with the slack
    rules of ``camera_tile_plan``; NaN candidates are ignored
    (``nanmin``/``nanmax``) as in the JAX build."""
    n, m = d_lo.shape[0], boxes_lo.shape[0]
    inf = float("inf")
    near_all = torch.zeros(n, m, device=d_lo.device)
    far_all = torch.full((n, m), inf, device=d_lo.device)
    for axis in range(3):
        blo = boxes_lo[:, axis][None, :]
        bhi = boxes_hi[:, axis][None, :]
        dlo = d_lo[:, axis:axis + 1]
        dhi = d_hi[:, axis:axis + 1]
        spans0 = (dlo <= 0.0) & (dhi >= 0.0)
        inv_a, inv_b = 1.0 / dhi, 1.0 / dlo
        ca = blo - c[axis]
        cb = bhi - c[axis]
        c0, c1, c2, c3 = ca * inv_a, ca * inv_b, cb * inv_a, cb * inv_b
        near = torch.fmin(torch.fmin(c0, c1), torch.fmin(c2, c3))
        far = torch.fmax(torch.fmax(c0, c1), torch.fmax(c2, c3))
        near = near - near.abs() * 4e-7  # rounding slack
        far = far + far.abs() * 4e-7
        bad = spans0 | near.isnan() | far.isnan()
        near_all = torch.maximum(near_all, torch.where(bad, -inf, near))
        far_all = torch.minimum(far_all, torch.where(bad, inf, far))
    return (near_all <= far_all) & (far_all >= 0.0)


def _stream_rows(slots, flat_tri, ids_flat, qs):
    """(TC, C) grid slots (-1 padding) -> (TC * CAND_ROWS, C) stream."""
    tc, c = slots.shape
    live = slots >= 0
    safe = torch.clamp(slots, min=0)
    rows = torch.zeros(tc, CAND_ROWS, c, device=slots.device)
    planes = flat_tri[:, safe]  # (9, TC, C)
    rows[:, :9] = torch.where(live[None], planes, 0.0).permute(1, 0, 2)
    rows[:, _ID_ROW] = torch.where(live, ids_flat[safe], -1).to(torch.float32)
    rows[:, _HOME_ROW] = (safe // qs).to(torch.float32)
    rows[:, _SLOT_ROW] = safe.to(torch.float32)
    return rows.reshape(tc * CAND_ROWS, c)


def build_camera_candidate_plan(camera, xs_p, ys_p, grid, ray_tile: int,
                                nq: int = 1, chunk: int = 256,
                                slack: float = 0.0) -> CandidatePlan:
    """Build the binned camera plan on the grid's device.

    ``xs_p``/``ys_p``: the tile-padded swizzled pixel stream the kernels
    render (``megakernel._pad_tiles``).  ``nq``: quarter rows per block
    for the home row (1: home row == block).  ``slack``: absolute
    inflation of every triangle and block AABB, so that the candidate
    set stays conservative while each vertex moves less than ``slack``
    (``refresh_stream``)."""
    nt = int(xs_p.shape[0]) // ray_tile
    if nt % 8:
        raise ValueError("tile stream must be padded to 8-tile groups")
    l, b = grid.tri_index.shape
    t_all = l * b
    qs = b // nq
    dev = grid.tri.device
    xs_p, ys_p = xs_p.to(dev), ys_p.to(dev)

    d_lo, d_hi = _tile_dir_hulls(camera, xs_p, ys_p, ray_tile)
    c = camera.center
    flat_tri = grid.tri.reshape(9, t_all)
    v0 = flat_tri[0:3].T
    p1 = v0 + flat_tri[3:6].T
    p2 = v0 + flat_tri[6:9].T
    tlo = torch.minimum(torch.minimum(v0, p1), p2) - slack  # (T, 3)
    thi = torch.maximum(torch.maximum(v0, p1), p2) + slack
    ids_flat = grid.tri_index.reshape(t_all).to(torch.int64)
    valid = ids_flat >= 0

    # block-level prefilter: only tiles that can see some block test
    # triangles (the sky majority of a frame skips the (tiles, T) pass)
    baabb = grid.aabb
    blk_pass = _hull_box_pass(d_lo, d_hi, c, baabb[:3].T - slack,
                              baabb[3:].T + slack)
    blk_pass &= (baabb[0] <= baabb[3])[None, :]
    active = blk_pass.any(dim=1).nonzero().squeeze(1)

    counts = torch.zeros(nt, dtype=torch.int64, device=dev)
    rows_t, slots_t = [], []
    step = max(1, _BUILD_PAIRS // max(t_all, 1))
    for part in active.split(step):
        tri_pass = _hull_box_pass(d_lo[part], d_hi[part], c, tlo, thi)
        tri_pass &= valid[None, :]
        counts[part] = tri_pass.sum(dim=1)
        r, s = tri_pass.nonzero(as_tuple=True)  # row-major: slots ascend
        rows_t.append(part[r])
        slots_t.append(s)

    nch = (counts + chunk - 1) // chunk
    starts = torch.where(nch > 0, torch.cumsum(nch, 0) - nch, 0)
    tc = int(nch.sum())
    if tc:
        tile = torch.cat(rows_t)
        slot = torch.cat(slots_t)
        first = torch.cumsum(counts, 0) - counts  # candidates before a tile
        rank = torch.arange(tile.numel(), device=dev) - first[tile]
        slots = torch.full((tc * chunk,), -1, dtype=torch.int64, device=dev)
        slots[starts[tile] * chunk + rank] = slot
        slots = slots.reshape(tc, chunk)
    else:
        tc = 1
        slots = torch.full((1, chunk), -1, dtype=torch.int64, device=dev)

    meta = torch.zeros(nt, 8, dtype=torch.int32, device=dev)
    meta[:, 0] = starts.to(torch.int32)
    meta[:, 1] = nch.to(torch.int32)
    return CandidatePlan(stream=_stream_rows(slots, flat_tri, ids_flat, qs),
                         meta=meta, chunk=int(chunk), total_chunks=int(tc),
                         camera=_TensorsKey((), _camera_tensors(camera)))


def candidate_plan_stats(plan: CandidatePlan, ray_tile: int) -> dict:
    """Plan-size diagnostics: padded dense pairs, stream bytes."""
    counts = plan.meta[:, 1].to(torch.int64)
    return dict(
        tiles=int(counts.numel()),
        nonempty_tiles=int((counts > 0).sum()),
        chunks=int(plan.total_chunks),
        padded_pairs=int(counts.sum()) * plan.chunk * ray_tile,
        stream_bytes=int(plan.stream.numel()) * 4,
    )


def plan_candidate_gids(plan: CandidatePlan) -> torch.Tensor:
    """Per-slot global triangle ids, (total_chunks, chunk) int32, -1 on
    padding lanes: the geometry-independent part of a plan."""
    rows = plan.stream.reshape(plan.total_chunks, CAND_ROWS, plan.chunk)
    return torch.round(rows[:, _ID_ROW]).to(torch.int32)


def refresh_stream(gids: torch.Tensor, grid, nq: int = 1) -> torch.Tensor:
    """Rebuild a plan's chunk stream against the current grid, by global
    id: the plane values and the home and slot rows go stale when the
    vertices move and the grid is rebuilt.  A gid that the grid does not
    hold (outside [0, L*B) or absent) becomes a padding lane: the
    inverse permutation starts at a -1 sentinel, never at slot 0.
    Returns the (TC * CAND_ROWS, C) stream."""
    l, b = grid.tri_index.shape
    t_hi = l * b
    dev = grid.tri.device
    gids = gids.to(dev, torch.int64)
    flat_ids = grid.tri_index.reshape(t_hi).to(torch.int64)
    inv = torch.full((t_hi + 1,), -1, dtype=torch.int64, device=dev)
    inv[torch.where(flat_ids >= 0, flat_ids, t_hi)] = torch.arange(
        t_hi, device=dev)
    inv = inv[:t_hi]
    in_range = (gids >= 0) & (gids < t_hi)
    pos = torch.where(in_range, inv[torch.clamp(gids, 0, t_hi - 1)], -1)
    return _stream_rows(pos, grid.tri.reshape(9, t_hi), flat_ids, b // nq)


def plan_fingerprint(camera, grid, ray_tile: int, nq: int,
                     chunk: int) -> _TensorsKey:
    """Cache key of a (scene, camera) plan, exact whatever the geometry's
    size and read without a device copy: the sizes, and the identity and
    in-place version of the camera frame's tensors and of the triangle
    planes and ids (a stale plan would render the old geometry)."""
    return _TensorsKey(
        (ray_tile, nq, chunk, int(camera.width), int(camera.height)),
        _camera_tensors(camera) + (grid.tri, grid.tri_index))
