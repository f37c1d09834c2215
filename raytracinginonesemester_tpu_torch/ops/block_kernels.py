"""The staged integrator's intersection kernels: closest hit (E, G, H) and
occlusion (F, I, H).

PyTorch/CUDA counterpart of ``raytracinginonesemester_tpu.ops.pallas_kernels``:

- ``block_closest`` replaces ``pallas_block_closest`` → ``_closest_kernel``
  (E): the closest hit of each ray over the block grid, optionally with
  the gpu shading normal and the fused point-light shadow visibility;
- ``block_occluded`` replaces ``pallas_block_occluded`` →
  ``_occluded_kernel`` (F): any hit in [tmin, tmax] per ray;
- ``block_closest_streamed`` / ``block_occluded_streamed`` replace
  ``pallas_block_closest_streamed`` / ``pallas_block_occluded_streamed``
  → ``_closest_streamed_kernel`` (G) / ``_occluded_streamed_kernel`` (I):
  the same functions by a per-tile front-to-back superblock walk
  (``accel.tile_visit_plan_fast``) with early exit;
- ``block_closest_blockmajor`` / ``block_occluded_blockmajor`` replace
  ``pallas_block_closest_blockmajor`` / ``pallas_block_occluded_blockmajor``
  → ``_closest_blockmajor_kernel`` (H): each ray chunk sweeps the scene
  slabs an (I, J) interval gate lets through, in order.

And the plane-budget rule (``fits_vmem``, ``num_chunks_for``) by which
the JAX package sends a scene to the streamed kernels.

Each wrapper launches its hand-written CUDA kernel (E, F in
``csrc/megakernel.cu``; G, I, H in ``csrc/block_stream.cu``) for CUDA
tensors and calls its plain PyTorch version (``*_plain``) for CPU
tensors; there is no other path.  E and F run the flat block scan of
kernels A and B: a per-ray slab test against the running best t before
each block, then the block's triangles with the lexicographic (t, global
triangle id) take rule, so winners do not depend on visit order and equal
the JAX kernels' superblock walk.  G, I and H keep their JAX walks (the
plan's order and early exit, the gate) with the same per-ray slab test
and take rule, so the five give the same winners and flags.
``shared_origin`` is accepted for the JAX signature and ignored: a
per-ray walk has no pair-invariant terms to hoist.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .accel import (SUPER, BlockGrid, interval_slab, ray_hulls,
                    tile_visit_plan_fast)
from .intersect import F32_MAX, HitData
from .megakernel import (RAY_TILE, SceneRows, _Best, _Shade, _chunks,
                         _closest_plain, _mt, _occluded_plain, _ptr,
                         _raise_on, _scene_args, _shading_normal, _slab,
                         _stream, _tally)

__all__ = ["grid_rows", "block_closest", "block_occluded",
           "block_closest_plain", "block_occluded_plain",
           "block_closest_streamed", "block_occluded_streamed",
           "block_closest_streamed_plain", "block_occluded_streamed_plain",
           "block_closest_blockmajor", "block_occluded_blockmajor",
           "block_closest_blockmajor_plain",
           "block_occluded_blockmajor_plain", "fits_vmem", "num_chunks_for",
           "BM_CHUNK_TILES", "BM_SLAB_BLOCKS", "launch_counts",
           "reset_launch_counts"]

# --- the plane-budget rule (pallas_kernels.py:66-114 of the JAX package) --
#
# On the TPU a grid whose planes exceed this budget cannot stay in the
# kernels' VMEM, and the JAX package sends it to the streamed kernels; the
# fused kernels and the oracle refuse it.  The card has no such limit
# (every kernel reads the planes from global memory through L2), so here
# this is a dispatch rule, not a memory limit: it is kept so that every
# scene takes the path the JAX package takes.  A module attribute, so that
# tests can lower it.
_VMEM_TRI_BUDGET_BYTES = 10 * 1024 * 1024


def _grid_bytes(l: int, b: int) -> int:
    return 9 * l * b * 4 + 8 * l * 4 + l * b * 4


def fits_vmem(grid: BlockGrid) -> bool:
    """Whether the grid's planes are under the plane budget."""
    l, b = grid.tri_index.shape
    return _grid_bytes(l, b) < _VMEM_TRI_BUDGET_BYTES


def num_chunks_for(grid: BlockGrid) -> int:
    """Fewest block-axis chunks whose planes each fit the budget (1 when
    the whole grid fits); more than 1 binds the streamed kernels."""
    l, b = grid.tri_index.shape
    n = 1
    while _grid_bytes(-(-l // n), b) >= _VMEM_TRI_BUDGET_BYTES:
        n += 1
    return n


def grid_rows(grid: BlockGrid) -> SceneRows:
    """Kernel operands of a block grid alone: its planes and the (L, 8)
    AABB rows; no camera, lights or materials."""
    dev = grid.tri.device
    l = grid.num_blocks
    return SceneRows(
        cam=torch.zeros(16, device=dev), lights=torch.zeros(0, 8, device=dev),
        mats=torch.zeros(0, 16, device=dev), tri=grid.tri.contiguous(),
        norm=grid.norm.contiguous(),
        ids=grid.tri_index.to(torch.int32).contiguous(),
        obj=grid.obj.to(torch.int32).contiguous(),
        aabb=torch.cat([grid.aabb.T, torch.zeros(l, 2, device=dev)],
                       dim=1).contiguous())


def _per_ray(x, r: int, dev) -> torch.Tensor:
    return torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=dev), (r,)).contiguous()


def _soa(a):
    return tuple(a[:, k] for k in range(3))


# --- plain versions ----------------------------------------------------

def block_closest_plain(origins, dirs, grid: BlockGrid, tmin=1e-4, *,
                        det_eps: float = 1e-8, return_normal: bool = False,
                        shadow_lights=None, shadow_eps: float = 1e-3,
                        shadow_tmin: float = 1e-4, shared_origin: bool = False,
                        rows: SceneRows = None, stats=None):
    """Plain version of ``block_closest`` (same arguments and results).
    ``stats``: optional dict whose ``"pairs"`` entry grows by the
    ray-triangle tests the kernel makes on these inputs."""
    del shared_origin  # a per-ray walk has nothing to hoist
    rows = grid_rows(grid) if rows is None else rows
    r = origins.shape[0]
    dev = origins.device
    o, d = _soa(origins), _soa(dirs)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    best = _closest_plain(rows, o, d, alive, det_eps, _per_ray(tmin, r, dev))
    pairs = best.pairs
    hit = best.t < F32_MAX
    hits = HitData(t=best.t, u=best.u, v=best.v,
                   tri_idx=best.id.to(torch.int32), hit=hit)
    n_shadow = 0 if shadow_lights is None else int(shadow_lights.shape[0])
    if not (return_normal or n_shadow):
        _tally(stats, pairs)
        return hits
    sn = _shading_normal(rows, d, best, cpuonly=False)
    n = (torch.where(hit, sn[0], 0.0), torch.where(hit, sn[1], 0.0),
         torch.where(hit, sn[2], 1.0))
    normal = torch.stack(n, dim=1)
    if not n_shadow:
        _tally(stats, pairs)
        return hits, normal
    # the fused IsInShadow walk of _closest_kernel, in its op order
    p = tuple(torch.where(hit, o[c] + best.t * d[c] + n[c] * shadow_eps, 1e30)
              for c in range(3))
    ndotv = -(n[0] * d[0] + n[1] * d[1] + n[2] * d[2])
    vis = []
    for li in range(n_shadow):
        lpos = shadow_lights[li]
        to = tuple(lpos[c] - p[c] for c in range(3))
        dist = torch.sqrt(torch.clamp(to[0] * to[0] + to[1] * to[1]
                                      + to[2] * to[2], min=1e-38))
        inv_dist = 1.0 / dist
        sd = tuple(c * inv_dist for c in to)
        ndotl = n[0] * sd[0] + n[1] * sd[1] + n[2] * sd[2]
        facing = hit & (ndotl > 0.0) & (ndotv > 0.0)
        blocked, k = _occluded_plain(rows, p, sd, dist, facing, det_eps,
                                     shadow_tmin)
        pairs = pairs + k
        vis.append(torch.where(facing & ~blocked, 1.0, 0.0))
    _tally(stats, pairs)
    return hits, normal, torch.stack(vis, dim=1)


def block_occluded_plain(origins, dirs, grid: BlockGrid, tmin=1e-4,
                         tmax=F32_MAX, *, det_eps: float = 1e-8,
                         rows: SceneRows = None, stats=None) -> torch.Tensor:
    """Plain version of ``block_occluded`` -> (R,) bool; ``stats`` as in
    ``block_closest_plain``."""
    rows = grid_rows(grid) if rows is None else rows
    r = origins.shape[0]
    dev = origins.device
    tmax_t = _per_ray(tmax, r, dev)
    every = torch.ones(r, dtype=torch.bool, device=dev)
    blocked, pairs = _occluded_plain(rows, _soa(origins), _soa(dirs), tmax_t,
                                     every, det_eps, _per_ray(tmin, r, dev),
                                     tmax_t)
    _tally(stats, pairs)
    return blocked


# --- kernel wrappers ---------------------------------------------------

def _check_rays(origins, dirs):
    if origins.dtype != torch.float32 or dirs.dtype != torch.float32:
        raise ValueError("origins and dirs must be float32")
    if origins.ndim != 2 or origins.shape[1] != 3 or dirs.shape != origins.shape:
        raise ValueError(f"bad ray shapes {tuple(origins.shape)}, "
                         f"{tuple(dirs.shape)}: need (R, 3) each")
    if origins.device != dirs.device or origins.device.type not in ("cpu",
                                                                    "cuda"):
        raise ValueError(f"rays on {origins.device} and {dirs.device}")


def block_closest(origins, dirs, grid: BlockGrid, tmin=1e-4, *,
                  det_eps: float = 1e-8, return_normal: bool = False,
                  shadow_lights=None, shadow_eps: float = 1e-3,
                  shadow_tmin: float = 1e-4, shared_origin: bool = False,
                  rows: SceneRows = None):
    """Closest hit of (R, 3) rays over the block grid, from ``tmin`` (a
    float or (R,)) -> ``HitData``; ``return_normal`` adds the gpu shading
    normal (R, 3) -> (hits, normal); ``shadow_lights`` (NL, 3) point-light
    positions add the fused shadow visibility -> (hits, normal, vis
    (R, NL)).  ``rows``: optional prebuilt ``grid_rows(grid)``."""
    _check_rays(origins, dirs)
    rows = grid_rows(grid) if rows is None else rows
    if origins.device.type == "cpu":
        return block_closest_plain(
            origins, dirs, grid, tmin, det_eps=det_eps,
            return_normal=return_normal, shadow_lights=shadow_lights,
            shadow_eps=shadow_eps, shadow_tmin=shadow_tmin, rows=rows)
    r = origins.shape[0]
    dev = origins.device
    n_shadow = 0 if shadow_lights is None else int(shadow_lights.shape[0])
    with_normal = bool(return_normal or n_shadow)
    t = torch.empty(r, dtype=torch.float32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    idx = torch.empty(r, dtype=torch.int32, device=dev)
    normal = torch.empty(r, 3, dtype=torch.float32, device=dev)
    vis = torch.empty(r, n_shadow, dtype=torch.float32, device=dev)
    lights = (torch.zeros(0, 3, device=dev) if not n_shadow else
              shadow_lights.to(device=dev, dtype=torch.float32).contiguous())
    if r:
        from ._native import load

        lib = load()
        o, d = origins.contiguous(), dirs.contiguous()
        tm = _per_ray(tmin, r, dev)
        args = _scene_args(rows, _Shade(False, det_eps, 1e-4, shadow_eps,
                                        shadow_tmin))
        err = lib.rt_closest(ctypes.byref(args), _ptr(o), _ptr(d), _ptr(tm), r,
                             int(with_normal), _ptr(lights), n_shadow,
                             _ptr(t), _ptr(u), _ptr(v), _ptr(idx),
                             _ptr(normal), _ptr(vis), _stream())
        _raise_on(lib, err, "closest")
        block_closest.launches += 1
    hits = HitData(t=t, u=u, v=v, tri_idx=idx, hit=idx >= 0)
    if n_shadow:
        return hits, normal, vis
    return (hits, normal) if with_normal else hits


def block_occluded(origins, dirs, grid: BlockGrid, tmin=1e-4, tmax=F32_MAX,
                   *, det_eps: float = 1e-8,
                   rows: SceneRows = None) -> torch.Tensor:
    """Any hit on [tmin, tmax] (each a float or (R,)) per ray -> (R,)
    bool; ``rows`` as in ``block_closest``."""
    _check_rays(origins, dirs)
    rows = grid_rows(grid) if rows is None else rows
    if origins.device.type == "cpu":
        return block_occluded_plain(origins, dirs, grid, tmin, tmax,
                                    det_eps=det_eps, rows=rows)
    r = origins.shape[0]
    dev = origins.device
    blocked = torch.empty(r, dtype=torch.bool, device=dev)
    if r:
        from ._native import load

        lib = load()
        o, d = origins.contiguous(), dirs.contiguous()
        args = _scene_args(rows, _Shade(False, det_eps))
        # scratch: the list of rays to walk and its two counters
        counts = torch.empty(2, dtype=torch.int32, device=dev)
        walks = torch.empty(r, dtype=torch.int32, device=dev)
        err = lib.rt_occluded(ctypes.byref(args), _ptr(o), _ptr(d),
                              _ptr(_per_ray(tmin, r, dev)),
                              _ptr(_per_ray(tmax, r, dev)), r, _ptr(blocked),
                              _ptr(counts), _ptr(walks), _stream())
        _raise_on(lib, err, "occluded")
        block_occluded.launches += 1
    return blocked


# --- streamed kernels G, I and H: operands ------------------------------

BM_CHUNK_TILES = 64   # ray tiles per block-major ray chunk (32k rays)
BM_SLAB_BLOCKS = 64   # blocks per block-major scene slab


def _pad_rays(rays, multiple: int):
    """(R, 8) rays padded to a multiple of ``multiple`` with parked filler
    (origin 1e30, direction 1, window [1, 1]: it fails every slab test and
    never enters a plan or a gate) -> (rays, RP)."""
    pad = (-int(rays.shape[0])) % multiple
    if pad:
        filler = torch.ones(pad, 8, dtype=torch.float32, device=rays.device)
        filler[:, 0:3] = 1e30
        rays = torch.cat([rays, filler])
    return rays.contiguous(), int(rays.shape[0])


def _prep_rays(origins, dirs, tmin, tmax):
    """(R, 3) rays and their windows (floats or (R,)) -> (rays (RP, 8) [o,
    d, tmin, tmax], RP), padded to whole 8-tile groups as the JAX
    package pads them (``pallas_kernels.py:518-535``)."""
    r = int(origins.shape[0])
    dev = origins.device
    rays = torch.cat([origins, dirs, _per_ray(tmin, r, dev)[:, None],
                      _per_ray(tmax, r, dev)[:, None]], dim=1)
    return _pad_rays(rays, 8 * RAY_TILE)


def _block_rows(grid: BlockGrid, blocks: int):
    """Block-major planes of the grid with its block axis padded to
    ``blocks``: (tri (blocks*9, B), ids (blocks, B) int32).  Rows [9b,
    9b+9) are block b's planes, so a block is one contiguous run; padding
    blocks carry ids -1 and never hit."""
    l, b = grid.tri_index.shape
    pad = blocks - l
    tri, ids = grid.tri, grid.tri_index.to(torch.int32)
    if pad:
        tri = torch.cat([tri, tri.new_zeros(9, pad, b)], dim=1)
        ids = torch.cat([ids, ids.new_full((pad, b), -1)])
    return (tri.permute(1, 0, 2).reshape(blocks * 9, b).contiguous(),
            ids.contiguous())


def _stream_grid_operands(grid: BlockGrid):
    """Operands of G and I (``pallas_kernels.py:922-939``): (tri (LS*8*9,
    B), ids (LS*8, B), aabb rows (L8, 8), LS), the block axis padded to
    whole superblocks."""
    l = grid.num_blocks
    ls = -(-l // SUPER)
    tri, ids = _block_rows(grid, ls * SUPER)
    aabb_rows = F.pad(grid.aabb.T, (0, 2, 0, (-l) % 8))
    return tri, ids, aabb_rows.contiguous(), ls


def _blockmajor_operands(grid: BlockGrid, slab_blocks: int):
    """Operands of H (``pallas_kernels.py:1155-1182``): (tri (Lp*9, B),
    ids (Lp, B), aabb rows (Lp8, 8), union rows (J8, 8), J); padding blocks
    get empty AABBs (min inf, max -inf)."""
    l = grid.num_blocks
    j = -(-l // slab_blocks)
    lp = j * slab_blocks
    tri, ids = _block_rows(grid, lp)
    aabb = grid.aabb
    if lp > l:
        dev = aabb.device
        aabb = torch.cat([aabb, torch.cat([
            torch.full((3, lp - l), float("inf"), device=dev),
            torch.full((3, lp - l), float("-inf"), device=dev)])], dim=1)
    aabb_rows = F.pad(aabb.T, (0, 2, 0, (-lp) % 8))
    umin = aabb[:3].reshape(3, j, slab_blocks).amin(dim=2)
    umax = aabb[3:].reshape(3, j, slab_blocks).amax(dim=2)
    union_rows = F.pad(torch.cat([umin, umax]).T, (0, 2, 0, (-j) % 8))
    return tri, ids, aabb_rows.contiguous(), union_rows.contiguous(), j


def _chunk_slab_gate(rays, chunk_rays: int, union_rows, num_slabs: int):
    """(I, J) int32 gate of H (``pallas_kernels.py:1185-1227``): the
    interval slab test of each ray chunk's live hull against each scene
    slab's union AABB, with the plan's interval arithmetic."""
    o_lo, o_hi, d_lo, d_hi, near, far, any_live = ray_hulls(
        rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7], chunk_rays)
    ub = union_rows[:num_slabs]
    near, far = interval_slab(o_lo, o_hi, d_lo, d_hi, near, far, ub.T[:6])
    valid = (ub[:, 0] <= ub[:, 3])[None, :]
    return ((near <= far) & valid & any_live[:, None]).to(torch.int32)


# --- streamed kernels: plain versions --------------------------------------


class _TileWalk:
    """A plain walk of padded (RP, 8) rays, tile by tile in lockstep: every
    tile visits one block per step (``visit``), in its own order.  Keeps
    the closest winners (``best``) or the blocked flags, the ray-triangle
    pairs the kernel tests (lanes with a nonzero direction that pass
    their slab test; an occlusion lane up to its first hit) and the
    blocks the kernel stages (a tile's block with any lane passing)."""

    def __init__(self, rows: SceneRows, rays, det_eps: float, closest: bool):
        dev = rays.device
        self.rows, self.det_eps, self.closest = rows, det_eps, closest
        self.o, self.d = _soa(rays[:, 0:3]), _soa(rays[:, 3:6])
        self.inv = tuple(1.0 / c for c in self.d)
        # a zero direction cannot hit (its determinant is 0 < det_eps):
        # the kernels skip such rays, the parked shade points' shadow rays
        self.moving = (rays[:, 3:6] != 0.0).any(dim=1)
        self.tmin, self.tmax = rays[:, 6], rays[:, 7]
        rp = int(rays.shape[0])
        self.best = _Best(rp, dev)
        self.blocked = torch.zeros(rp, dtype=torch.bool, device=dev)
        self.occ_pairs = torch.zeros((), dtype=torch.int64, device=dev)
        self.staged = torch.zeros((), dtype=torch.int64, device=dev)
        self.lane = torch.arange(RAY_TILE, device=dev)

    def lanes(self, tiles):
        return (tiles[:, None] * RAY_TILE + self.lane).reshape(-1)

    def visit(self, tiles, blocks) -> None:
        """Tile ``tiles[i]`` visits block ``blocks[i]``; blocks past the
        grid are skipped, as the kernels skip them."""
        rows = self.rows
        nb, bs = rows.num_blocks, rows.block_size
        lanes = self.lanes(tiles)
        blk = torch.clamp(blocks, max=nb - 1).repeat_interleave(RAY_TILE)
        a = rows.aabb[blk].T
        o = tuple(c[lanes] for c in self.o)
        inv = tuple(c[lanes] for c in self.inv)
        window = self.best.t[lanes] if self.closest else self.tmax[lanes]
        boxed = _slab(a, o, inv, self.tmin[lanes], window)
        boxed &= ((blocks < nb).repeat_interleave(RAY_TILE)
                  & self.moving[lanes])
        if not self.closest:
            boxed &= ~self.blocked[lanes]
        self.staged += boxed.reshape(-1, RAY_TILE).any(dim=1).sum()
        sub, sblk = lanes[boxed], blk[boxed]
        if sub.numel() == 0:
            return
        slot = torch.arange(bs, device=sub.device)
        for part in _chunks(torch.arange(sub.numel(), device=sub.device), bs):
            ch, cb = sub[part], sblk[part]
            tri = tuple(rows.tri[q][cb] for q in range(9))
            ids = rows.ids[cb].to(torch.int64)
            if self.closest:
                self.best.visit(ch, self.o, self.d, tri, ids,
                                cb[:, None] * bs + slot, self.det_eps,
                                self.tmin)
            else:
                self._any_hit(ch, tri, ids)

    def _any_hit(self, ch, tri, ids) -> None:
        t, _, _ = _mt(tuple(c[ch, None] for c in self.o),
                      tuple(c[ch, None] for c in self.d), tri, self.det_eps,
                      self.tmin[ch, None], self.tmax[ch, None])
        live = ids >= 0
        hits = live & (t < F32_MAX)
        hit = hits.any(dim=1)
        upto = live.cumsum(dim=1)
        first = hits.to(torch.int32).argmax(dim=1, keepdim=True)
        self.occ_pairs += torch.where(hit, upto.gather(1, first)[:, 0],
                                      upto[:, -1]).sum()
        self.blocked[ch] |= hit

    def tally(self, stats) -> None:
        _tally(stats, self.best.pairs + self.occ_pairs)
        if stats is not None:
            stats["staged_blocks"] = (stats.get("staged_blocks", 0)
                                      + int(self.staged))

    def hits(self, r: int) -> HitData:
        b = self.best
        idx = b.id[:r].to(torch.int32)
        return HitData(t=b.t[:r], u=b.u[:r], v=b.v[:r], tri_idx=idx,
                       hit=idx >= 0)


def _plan_walk_plain(rays, grid: BlockGrid, rows: SceneRows, det_eps: float,
                     closest: bool, stats) -> _TileWalk:
    """G's (``closest``) or I's walk: each tile's plan row in order, while
    the next entry is <= the tile's largest best t (G), or is finite and
    a lane of the tile is unblocked (I)."""
    rp = int(rays.shape[0])
    nt = rp // RAY_TILE
    walk = _TileWalk(rows, rays, det_eps, closest)
    order, entry, _ = tile_visit_plan_fast(
        rays[:, 0:3], rays[:, 3:6], grid, rays[:, 6], rays[:, 7], RAY_TILE)
    walking = torch.ones(nt, dtype=torch.bool, device=rays.device)
    for k in range(int(order.shape[1])):
        if closest:
            walking &= entry[:, k] <= walk.best.t.reshape(nt, -1).amax(dim=1)
        else:
            walking &= ((entry[:, k] < float("inf"))
                        & (~walk.blocked).reshape(nt, -1).any(dim=1))
        tiles = walking.nonzero().squeeze(1)
        if tiles.numel() == 0:
            break
        sb = order[tiles, k].to(torch.int64)
        for j in range(SUPER):
            walk.visit(tiles, sb * SUPER + j)
    walk.tally(stats)
    return walk


def _blockmajor_plain(rays, grid: BlockGrid, rows: SceneRows, det_eps: float,
                      closest: bool, chunk_tiles: int, slab_blocks: int,
                      stats) -> _TileWalk:
    """H's sweep: the rays padded to whole chunks, the (I, J) gate, then
    for each slab j the tiles of the chunks the gate lets through, blocks
    of the slab in order."""
    rays, rp = _pad_rays(rays, chunk_tiles * RAY_TILE)
    _, _, _, union_rows, nj = _blockmajor_operands(grid, slab_blocks)
    gate = _chunk_slab_gate(rays, chunk_tiles * RAY_TILE, union_rows, nj)
    walk = _TileWalk(rows, rays, det_eps, closest)
    in_chunk = torch.arange(chunk_tiles, device=rays.device)
    for j in range(nj):
        chunks = gate[:, j].nonzero().squeeze(1)
        if chunks.numel() == 0:
            continue
        tiles = (chunks[:, None] * chunk_tiles + in_chunk).reshape(-1)
        for bb in range(slab_blocks):
            gb = j * slab_blocks + bb
            if gb >= rows.num_blocks:
                break  # padding blocks hold no triangle
            walk.visit(tiles, torch.full_like(tiles, gb))
    walk.tally(stats)
    return walk


def block_closest_streamed_plain(origins, dirs, grid: BlockGrid, tmin=1e-4, *,
                                 det_eps: float = 1e-8, rows: SceneRows = None,
                                 stats=None) -> HitData:
    """Plain version of ``block_closest_streamed`` (G); ``stats`` as in
    ``block_closest_plain``, plus ``"staged_blocks"``: the blocks the
    kernel stages into shared memory."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, F32_MAX)
    walk = _plan_walk_plain(rays, grid, rows, det_eps, True, stats)
    return walk.hits(int(origins.shape[0]))


def block_occluded_streamed_plain(origins, dirs, grid: BlockGrid, tmin=1e-4,
                                  tmax=F32_MAX, *, det_eps: float = 1e-8,
                                  rows: SceneRows = None,
                                  stats=None) -> torch.Tensor:
    """Plain version of ``block_occluded_streamed`` (I)."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, tmax)
    walk = _plan_walk_plain(rays, grid, rows, det_eps, False, stats)
    return walk.blocked[:int(origins.shape[0])]


def block_closest_blockmajor_plain(origins, dirs, grid: BlockGrid, tmin=1e-4,
                                   *, det_eps: float = 1e-8,
                                   chunk_tiles: int = BM_CHUNK_TILES,
                                   slab_blocks: int = BM_SLAB_BLOCKS,
                                   rows: SceneRows = None,
                                   stats=None) -> HitData:
    """Plain version of ``block_closest_blockmajor`` (H, closest)."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, F32_MAX)
    walk = _blockmajor_plain(rays, grid, rows, det_eps, True, chunk_tiles,
                             slab_blocks, stats)
    return walk.hits(int(origins.shape[0]))


def block_occluded_blockmajor_plain(origins, dirs, grid: BlockGrid, tmin=1e-4,
                                    tmax=F32_MAX, *, det_eps: float = 1e-8,
                                    chunk_tiles: int = BM_CHUNK_TILES,
                                    slab_blocks: int = BM_SLAB_BLOCKS,
                                    rows: SceneRows = None,
                                    stats=None) -> torch.Tensor:
    """Plain version of ``block_occluded_blockmajor`` (H, occlusion)."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, tmax)
    walk = _blockmajor_plain(rays, grid, rows, det_eps, False, chunk_tiles,
                             slab_blocks, stats)
    return walk.blocked[:int(origins.shape[0])]


# --- streamed kernels: wrappers --------------------------------------------


def _check_grid(grid: BlockGrid, dev) -> None:
    """The streamed kernels read the grid through raw pointers."""
    for name in ("tri", "aabb", "tri_index"):
        t = getattr(grid, name)
        if t.device != dev:
            raise ValueError(f"grid.{name} on {t.device}, rays on {dev}")
    if grid.tri.dtype != torch.float32 or grid.aabb.dtype != torch.float32:
        raise ValueError("grid planes and AABBs must be float32")


def _plan_operands(origins, dirs, grid: BlockGrid, tmin, tmax):
    _check_grid(grid, origins.device)
    rays, rp = _prep_rays(origins.contiguous(), dirs.contiguous(), tmin, tmax)
    order, entry, _ = tile_visit_plan_fast(
        rays[:, 0:3], rays[:, 3:6], grid, rays[:, 6], rays[:, 7], RAY_TILE)
    tri, ids, aabb, ls = _stream_grid_operands(grid)
    return rays, rp // RAY_TILE, order, entry, tri, ids, aabb, ls


def block_closest_streamed(origins, dirs, grid: BlockGrid, tmin=1e-4, *,
                           det_eps: float = 1e-8,
                           rows: SceneRows = None) -> HitData:
    """Closest hit of (R, 3) rays from ``tmin`` (a float or (R,)) by each
    512-ray tile's front-to-back superblock plan, with the early exit of
    the JAX kernel (G) -> ``HitData`` (no normal: the caller recomputes
    the hit frame).  ``rows``: optional prebuilt ``grid_rows(grid)`` for
    the plain version."""
    _check_rays(origins, dirs)
    if origins.device.type == "cpu":
        return block_closest_streamed_plain(origins, dirs, grid, tmin,
                                            det_eps=det_eps, rows=rows)
    r = int(origins.shape[0])
    rays, nt, order, entry, tri, ids, aabb, ls = _plan_operands(
        origins, dirs, grid, tmin, F32_MAX)
    rp = nt * RAY_TILE
    t = torch.empty(rp, dtype=torch.float32, device=origins.device)
    u, v = torch.empty_like(t), torch.empty_like(t)
    idx = torch.empty(rp, dtype=torch.int32, device=origins.device)
    if r:
        from ._native import load

        lib = load("block_stream")
        err = lib.rt_closest_streamed(
            _ptr(rays), _ptr(aabb), _ptr(order), _ptr(entry), _ptr(tri),
            _ptr(ids), nt, grid.num_blocks, ls, grid.block_size, det_eps,
            _ptr(t), _ptr(u), _ptr(v), _ptr(idx), _stream())
        _raise_on(lib, err, "closest_streamed")
        block_closest_streamed.launches += 1
    return HitData(t=t[:r], u=u[:r], v=v[:r], tri_idx=idx[:r],
                   hit=idx[:r] >= 0)


def block_occluded_streamed(origins, dirs, grid: BlockGrid, tmin=1e-4,
                            tmax=F32_MAX, *, det_eps: float = 1e-8,
                            rows: SceneRows = None) -> torch.Tensor:
    """Any hit on [tmin, tmax] (each a float or (R,)) per ray by the same
    plan walk (I), each tile stopping once every lane is blocked -> (R,)
    bool."""
    _check_rays(origins, dirs)
    if origins.device.type == "cpu":
        return block_occluded_streamed_plain(origins, dirs, grid, tmin, tmax,
                                             det_eps=det_eps, rows=rows)
    r = int(origins.shape[0])
    rays, nt, order, entry, tri, ids, aabb, ls = _plan_operands(
        origins, dirs, grid, tmin, tmax)
    blocked = torch.empty(nt * RAY_TILE, dtype=torch.bool,
                          device=origins.device)
    if r:
        from ._native import load

        lib = load("block_stream")
        err = lib.rt_occluded_streamed(
            _ptr(rays), _ptr(aabb), _ptr(order), _ptr(entry), _ptr(tri),
            _ptr(ids), nt, grid.num_blocks, ls, grid.block_size, det_eps,
            _ptr(blocked), _stream())
        _raise_on(lib, err, "occluded_streamed")
        block_occluded_streamed.launches += 1
    return blocked[:r]


def _blockmajor(origins, dirs, grid: BlockGrid, tmin, tmax, det_eps: float,
                occluded: bool, chunk_tiles: int, slab_blocks: int):
    """Launch H -> its (RP,) outputs: (t, u, v, idx) or blocked."""
    if chunk_tiles <= 0 or slab_blocks <= 0:
        raise ValueError("chunk_tiles and slab_blocks must be positive")
    dev = origins.device
    _check_grid(grid, dev)
    rays, _ = _prep_rays(origins.contiguous(), dirs.contiguous(), tmin, tmax)
    rays, rp = _pad_rays(rays, chunk_tiles * RAY_TILE)
    tri, ids, aabb, union_rows, nj = _blockmajor_operands(grid, slab_blocks)
    gate = _chunk_slab_gate(rays, chunk_tiles * RAY_TILE, union_rows, nj)
    t = torch.empty(rp, dtype=torch.float32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    idx = torch.empty(rp, dtype=torch.int32, device=dev)
    blocked = torch.empty(rp, dtype=torch.bool, device=dev)
    from ._native import load

    lib = load("block_stream")
    err = lib.rt_blockmajor(
        _ptr(rays), _ptr(aabb), _ptr(gate.contiguous()), _ptr(tri), _ptr(ids),
        rp // RAY_TILE, grid.num_blocks, nj, slab_blocks, chunk_tiles,
        grid.block_size, det_eps, int(occluded), _ptr(t), _ptr(u), _ptr(v),
        _ptr(idx), _ptr(blocked), _stream())
    _raise_on(lib, err, "blockmajor")
    return blocked if occluded else (t, u, v, idx)


def block_closest_blockmajor(origins, dirs, grid: BlockGrid, tmin=1e-4, *,
                             det_eps: float = 1e-8,
                             chunk_tiles: int = BM_CHUNK_TILES,
                             slab_blocks: int = BM_SLAB_BLOCKS,
                             rows: SceneRows = None) -> HitData:
    """Closest hit by H's block-major sweep: each ``chunk_tiles`` x 512-ray
    chunk visits the ``slab_blocks``-block scene slabs its (I, J) gate lets
    through, in order -> ``HitData``; the same winners as G and E."""
    _check_rays(origins, dirs)
    if origins.device.type == "cpu":
        return block_closest_blockmajor_plain(
            origins, dirs, grid, tmin, det_eps=det_eps,
            chunk_tiles=chunk_tiles, slab_blocks=slab_blocks, rows=rows)
    r = int(origins.shape[0])
    if not r:
        t = origins.new_empty(0)
        i = torch.empty(0, dtype=torch.int32, device=origins.device)
        return HitData(t=t, u=t, v=t, tri_idx=i, hit=i >= 0)
    t, u, v, idx = _blockmajor(origins, dirs, grid, tmin, F32_MAX, det_eps,
                               False, chunk_tiles, slab_blocks)
    block_closest_blockmajor.launches += 1
    return HitData(t=t[:r], u=u[:r], v=v[:r], tri_idx=idx[:r],
                   hit=idx[:r] >= 0)


def block_occluded_blockmajor(origins, dirs, grid: BlockGrid, tmin=1e-4,
                              tmax=F32_MAX, *, det_eps: float = 1e-8,
                              chunk_tiles: int = BM_CHUNK_TILES,
                              slab_blocks: int = BM_SLAB_BLOCKS,
                              rows: SceneRows = None) -> torch.Tensor:
    """Any hit on [tmin, tmax] by H's block-major sweep (a blocked ray's
    window closes) -> (R,) bool."""
    _check_rays(origins, dirs)
    if origins.device.type == "cpu":
        return block_occluded_blockmajor_plain(
            origins, dirs, grid, tmin, tmax, det_eps=det_eps,
            chunk_tiles=chunk_tiles, slab_blocks=slab_blocks, rows=rows)
    r = int(origins.shape[0])
    if not r:
        return torch.empty(0, dtype=torch.bool, device=origins.device)
    blocked = _blockmajor(origins, dirs, grid, tmin, tmax, det_eps, True,
                          chunk_tiles, slab_blocks)
    block_occluded_blockmajor.launches += 1
    return blocked[:r]


# launch counters: each wrapper adds one where it launches its kernel
_WRAPPERS = {"closest": block_closest, "occluded": block_occluded,
             "closest_streamed": block_closest_streamed,
             "occluded_streamed": block_occluded_streamed,
             "closest_blockmajor": block_closest_blockmajor,
             "occluded_blockmajor": block_occluded_blockmajor}
for _fn in _WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
