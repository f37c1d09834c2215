"""Block grid: Morton-ordered triangle blocks in plane-SoA layout.

PyTorch port of ``BlockGrid``, ``build_block_grid``,
``build_block_grid_treelet``, ``super_aabbs`` and ``tile_visit_plan_fast``
(the streamed kernels' per-tile superblock plan) from
``raytracinginonesemester_tpu.ops.accel``.  Triangles are sorted by
centroid Morton code (stable, so equal codes keep their input order) and
cut into runs of ``block_size`` (the "runs" layout) or into LBVH
treelets of at most ``block_size`` (the "treelet" layout); each block's
AABB is the union of its members'.  The plane layout is kept as it is,
so the planes of the two packages can be compared element for element
and handed across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lbvh import morton_codes, triangle_aabbs

__all__ = ["BlockGrid", "build_block_grid", "build_block_grid_treelet",
           "super_aabbs", "SUPER", "PARK_THRESHOLD", "tile_visit_plan_fast"]

# blocks per superblock (the camera plan's coarse level)
SUPER = 8


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """``tri`` (9, L, B): [v0 xyz, e1 xyz, e2 xyz]; ``norm`` (12, L, B):
    vertex normals [n0 n1 n2 xyz] and the unit geometric normal [g xyz];
    ``tri_index`` (L, B) original triangle ids (-1 padding); ``obj``
    (L, B) object ids (-1 padding); ``aabb`` (6, L) [min xyz, max xyz]."""

    tri: torch.Tensor
    norm: torch.Tensor
    tri_index: torch.Tensor
    obj: torch.Tensor
    aabb: torch.Tensor
    block_size: int

    @property
    def num_blocks(self) -> int:
        return int(self.tri.shape[1])


def _planes(sv, sn, l: int, block_size: int):
    """The (9, L, B) triangle planes and (12, L, B) normal planes of the
    triangles ``sv`` (L*B, 3, 3) in slot order, with their vertex
    normals ``sn``; a triangle of zero edges gets a zero geometric
    normal (its length clamped at 1e-38)."""
    v0 = sv[:, 0]
    e1 = sv[:, 1] - v0
    e2 = sv[:, 2] - v0
    tri = torch.stack(
        [v0[:, 0], v0[:, 1], v0[:, 2],
         e1[:, 0], e1[:, 1], e1[:, 2],
         e2[:, 0], e2[:, 1], e2[:, 2]]
    ).reshape(9, l, block_size)
    g = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    g_len_sq = g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
    g = g / torch.sqrt(torch.clamp(g_len_sq, min=1e-38))[:, None]
    norm = torch.stack(
        [sn[:, 0, 0], sn[:, 0, 1], sn[:, 0, 2],
         sn[:, 1, 0], sn[:, 1, 1], sn[:, 1, 2],
         sn[:, 2, 0], sn[:, 2, 1], sn[:, 2, 2],
         g[:, 0], g[:, 1], g[:, 2]]
    ).reshape(12, l, block_size)
    return tri, norm


def build_block_grid(vertices: torch.Tensor, num_valid: int,
                     block_size: int = 128, normals: torch.Tensor = None,
                     obj_ids: torch.Tensor = None) -> BlockGrid:
    """Build the block grid from (T, 3, 3) float32 triangles; T must be a
    multiple of ``block_size``.  Triangles at or past ``num_valid`` are
    padding: they sort to the tail and never hit."""
    t = int(vertices.shape[0])
    if t % block_size:
        raise ValueError("triangle count must be padded to block_size")
    l = t // block_size
    dev = vertices.device
    if normals is None:
        normals = torch.zeros_like(vertices)

    leaf_min, leaf_max = triangle_aabbs(vertices)
    valid = torch.arange(t, device=dev) < int(num_valid)
    inf = torch.tensor(float("inf"), device=dev)
    scene_min = torch.where(valid[:, None], leaf_min, inf).amin(dim=0)
    scene_max = torch.where(valid[:, None], leaf_max, -inf).amax(dim=0)

    centroid = 0.5 * (leaf_min + leaf_max)
    extent = scene_max - scene_min
    unit = (centroid - scene_min) / torch.where(
        extent == 0, torch.ones_like(extent), extent)
    codes = morton_codes(unit)
    codes = torch.where(valid, codes, torch.full_like(codes, 0xFFFFFFFF))
    order = torch.argsort(codes, stable=True)

    tri, norm = _planes(vertices[order], normals[order], l, block_size)

    sorted_valid = valid[order]
    minus1 = torch.full_like(order, -1)
    tri_index = torch.where(sorted_valid, order, minus1).to(
        torch.int32).reshape(l, block_size)
    if obj_ids is None:
        obj_ids = torch.zeros(t, dtype=torch.int32, device=dev)
    obj_plane = torch.where(sorted_valid, obj_ids.to(torch.int64)[order],
                            minus1).to(torch.int32).reshape(l, block_size)

    bmin = torch.where(sorted_valid[:, None], leaf_min[order], inf)
    bmax = torch.where(sorted_valid[:, None], leaf_max[order], -inf)
    block_min = bmin.reshape(l, block_size, 3).amin(dim=1)
    block_max = bmax.reshape(l, block_size, 3).amax(dim=1)
    aabb = torch.cat([block_min.T, block_max.T]).contiguous()  # (6, L)

    return BlockGrid(tri=tri.contiguous(), norm=norm.contiguous(),
                     tri_index=tri_index.contiguous(),
                     obj=obj_plane.contiguous(), aabb=aabb,
                     block_size=int(block_size))



def _find_split_np(codes: np.ndarray, lo: int, hi: int) -> int:
    """Karras ``find_split`` on the host (``bvh.h:219-257``): the last
    index in [lo, hi) sharing more leading Morton bits with ``codes[lo]``
    than lo and hi share."""
    first, last = int(codes[lo]), int(codes[hi])
    if first == last:
        return lo + (hi - lo + 1) // 2 - 1  # equal codes: median split
    common = 32 - (first ^ last).bit_length()
    split, step = lo, hi - lo + 1
    while step > 1:
        step = (step + 1) // 2
        nxt = split + step
        if nxt < hi:
            code = int(codes[nxt])
            prefix = 64 if code == first else 32 - (first ^ code).bit_length()
            if prefix > common:
                split = nxt
    return split


def _treelet_ranges(codes: np.ndarray, block_size: int):
    """Cut the sorted leaves into LBVH-subtree-aligned ranges of at most
    ``block_size``: split each range at its highest differing Morton bit
    until it fits.  Each range is a complete Karras subtree, so its box
    is an LBVH internal node's."""
    out = []
    stack = [(0, len(codes) - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo + 1 <= block_size:
            out.append((lo, hi))
            continue
        mid = _find_split_np(codes, lo, hi)
        stack.append((mid + 1, hi))
        stack.append((lo, mid))
    out.sort()
    return out


def build_block_grid_treelet(vertices: torch.Tensor, num_valid: int,
                             block_size: int = 512,
                             normals: torch.Tensor = None,
                             obj_ids: torch.Tensor = None) -> BlockGrid:
    """Block grid whose blocks are LBVH treelets: complete Karras subtrees
    of at most ``block_size`` triangles, each padded to ``block_size``
    lanes with dead slots (id -1, zero triangles) -- inside every block,
    not only the last.  The same planes as the JAX package's
    ``build_block_grid_treelet``.  The cuts are a host-side numpy
    recursion over the Morton codes; the planes are built on the
    triangles' device."""
    dev = vertices.device
    t = int(vertices.shape[0])
    nv = int(num_valid)
    if normals is None:
        normals = torch.zeros_like(vertices)
    if obj_ids is None:
        obj_ids = torch.zeros(t, dtype=torch.int32, device=dev)

    leaf_min, leaf_max = triangle_aabbs(vertices)
    lmin, lmax = leaf_min.cpu().numpy(), leaf_max.cpu().numpy()
    valid = np.arange(t) < nv
    smin = np.where(valid[:, None], lmin, np.inf).min(0)
    smax = np.where(valid[:, None], lmax, -np.inf).max(0)
    centroid = 0.5 * (lmin + lmax)
    ext = np.where(smax - smin == 0, 1.0, smax - smin)
    unit = np.asarray((centroid - smin) / ext, dtype=np.float32)
    codes = morton_codes(torch.from_numpy(unit)).numpy()
    codes = np.where(valid, codes, 0xFFFFFFFF)
    order = np.argsort(codes, kind="stable")
    order = order[valid[order]]  # (nv,) the real triangles, sorted
    ranges = _treelet_ranges(codes[order], block_size)

    l = len(ranges)
    slot_index = np.full((l, block_size), -1, np.int32)
    for b, (lo, hi) in enumerate(ranges):
        slot_index[b, : hi - lo + 1] = order[lo:hi + 1]
    flat_np = slot_index.reshape(-1)
    safe_np = np.maximum(flat_np, 0)

    flat = torch.from_numpy(flat_np).to(dev)
    safe = torch.from_numpy(safe_np).to(dev, torch.int64)
    ok = flat >= 0
    sv = torch.where(ok[:, None, None], vertices[safe], 0.0)
    sn = torch.where(ok[:, None, None], normals[safe], 0.0)
    tri, norm = _planes(sv, sn, l, block_size)
    obj_plane = torch.where(ok, obj_ids.to(torch.int32)[safe], -1)

    live = (flat_np >= 0)[:, None]
    bmin = np.where(live, lmin[safe_np], np.inf)
    bmax = np.where(live, lmax[safe_np], -np.inf)
    block_min = bmin.reshape(l, block_size, 3).min(axis=1)
    block_max = bmax.reshape(l, block_size, 3).max(axis=1)
    aabb = torch.from_numpy(np.concatenate(
        [block_min.T, block_max.T]).astype(np.float32)).to(dev)

    return BlockGrid(tri=tri.contiguous(), norm=norm.contiguous(),
                     tri_index=torch.from_numpy(slot_index).to(dev),
                     obj=obj_plane.reshape(l, block_size).contiguous(),
                     aabb=aabb.contiguous(), block_size=int(block_size))


def super_aabbs(grid: BlockGrid) -> torch.Tensor:
    """Union AABBs of consecutive SUPER-block groups -> (6, LS)."""
    l = grid.num_blocks
    ls = -(-l // SUPER)
    pad = ls * SUPER - l
    aabb = grid.aabb
    if pad:
        dev = aabb.device
        pad_cols = torch.cat([
            torch.full((3, pad), float("inf"), device=dev),
            torch.full((3, pad), float("-inf"), device=dev)])
        aabb = torch.cat([aabb, pad_cols], dim=1)
    smin = aabb[:3].reshape(3, ls, SUPER).amin(dim=2)
    smax = aabb[3:].reshape(3, ls, SUPER).amax(dim=2)
    return torch.cat([smin, smax])


# Origins at or above this are parked lanes (dead rays, padding): they are
# left out of the interval bounds, so one dead lane does not blow up a
# tile's hull (the integrator parks at 1e30).
PARK_THRESHOLD = 1e29


def _interval_mul(alo, ahi, blo, bhi):
    p1, p2, p3, p4 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
    return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
            torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))


def interval_slab(o_lo, o_hi, d_lo, d_hi, near_all, far_all, boxes):
    """Conservative interval slab test of ray hulls (rows: [o_lo, o_hi],
    [d_lo, d_hi] each (N, 3), windows ``near_all``/``far_all`` (N, 1))
    against box columns ``boxes`` (6, M) -> (near (N, M), far (N, M)).
    Widened by a few ulps (``x -/+ |x| 4e-7``): round-to-nearest interval
    arithmetic may under-cover, and culling must stay conservative.  A
    direction interval that straddles zero opens that axis."""
    inf = float("inf")
    for axis in range(3):
        blo = boxes[axis][None, :]
        bhi = boxes[axis + 3][None, :]
        olo, ohi = o_lo[:, axis:axis + 1], o_hi[:, axis:axis + 1]
        dlo, dhi = d_lo[:, axis:axis + 1], d_hi[:, axis:axis + 1]
        spans0 = (dlo <= 0.0) & (dhi >= 0.0)
        # the same-sign interval reciprocal is [1/dhi, 1/dlo]
        inv_a, inv_b = 1.0 / dhi, 1.0 / dlo
        p1lo, p1hi = _interval_mul(blo - ohi, blo - olo, inv_a, inv_b)
        p2lo, p2hi = _interval_mul(bhi - ohi, bhi - olo, inv_a, inv_b)
        near = torch.minimum(p1lo, p2lo)
        far = torch.maximum(p1hi, p2hi)
        near = near - near.abs() * 4e-7
        far = far + far.abs() * 4e-7
        bad = spans0 | near.isnan() | far.isnan()
        near_all = torch.maximum(near_all, torch.where(bad, -inf, near))
        far_all = torch.minimum(far_all, torch.where(bad, inf, far))
    return near_all, far_all


def ray_hulls(origins, dirs, tmin, tmax, group: int):
    """Interval hulls of the live rays (origin x below ``PARK_THRESHOLD``)
    of each run of ``group`` rays -> (o_lo, o_hi, d_lo, d_hi (N, 3),
    near (N, 1), far (N, 1), any_live (N,))."""
    r = int(origins.shape[0])
    n = r // group
    inf = float("inf")
    live = (origins[:, 0] < PARK_THRESHOLD).reshape(n, group, 1)
    o3 = origins.reshape(n, group, 3)
    d3 = dirs.reshape(n, group, 3)
    o_lo = torch.where(live, o3, inf).amin(dim=1)
    o_hi = torch.where(live, o3, -inf).amax(dim=1)
    d_lo = torch.where(live, d3, inf).amin(dim=1)
    d_hi = torch.where(live, d3, -inf).amax(dim=1)
    lv = live[..., 0]
    tn = torch.where(lv, tmin.reshape(n, group), inf).amin(dim=1)
    tx = torch.where(lv, tmax.reshape(n, group), -inf).amax(dim=1)
    return o_lo, o_hi, d_lo, d_hi, tn[:, None], tx[:, None], lv.any(dim=1)


def tile_visit_plan_fast(origins, dirs, grid: BlockGrid, tmin, tmax,
                         ray_tile: int):
    """Front-to-back superblock plan of each tile of ``ray_tile`` rays
    (``accel.py:347-422`` of the JAX package), on the rays' device.

    One interval slab test per (tile, superblock) of the tile's live-ray
    hull: conservative, so every superblock a ray's own slab test would
    pass is in the plan, and its entry is a lower bound of any ray's
    entry distance.  ``origins``/``dirs`` (R, 3) must be padded to a
    ``ray_tile`` multiple; ``tmin``/``tmax`` floats or (R,).  Returns
    (order (NT, LS) int32, sorted entry (NT, LS) float32 with inf past the
    active superblocks, count (NT, 1) int32).  The sort is stable, as
    ``jnp.argsort`` is."""
    r = int(origins.shape[0])
    if r % ray_tile:
        raise ValueError("ray count must be a multiple of ray_tile")
    dev = origins.device
    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float32,
                                              device=dev), (r,))
    tmax = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32,
                                              device=dev), (r,))
    saabb = super_aabbs(grid)
    o_lo, o_hi, d_lo, d_hi, near, far, any_live = ray_hulls(
        origins, dirs, tmin, tmax, ray_tile)
    near, far = interval_slab(o_lo, o_hi, d_lo, d_hi, near, far, saabb)
    valid_box = (saabb[0] <= saabb[3])[None, :]  # padded supers never hit
    hit = (near <= far) & valid_box & any_live[:, None]
    entry = torch.where(hit, near, float("inf"))
    count = hit.to(torch.int32).sum(dim=1, keepdim=True)
    sorted_entry, order = torch.sort(entry, dim=1, stable=True)
    return order.to(torch.int32), sorted_entry, count
