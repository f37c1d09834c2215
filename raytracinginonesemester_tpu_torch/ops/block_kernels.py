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
the JAX package sends a scene to the streamed kernels, and by which the
port's staged integrator takes G and I over E and F.

Each wrapper launches its hand-written CUDA kernel (E, F in
``csrc/megakernel.cu``; G, I, H in ``csrc/block_stream.cu``) for CUDA
tensors and calls its plain PyTorch version (``*_plain``) for CPU
tensors; there is no other path.  E and F run the flat block scan of
kernels A and B: a per-ray slab test against the running best t before
each block, then the block's triangles with the lexicographic (t, global
triangle id) take rule, so winners do not depend on visit order and equal
the JAX kernels' superblock walk.  Each lists the rays whose slab test
passes some block, and a grid that fills the card walks the list, a (ray,
block) pair's triangles on a warp's 32 lanes; E lists its fused shadow
rays and walks them the same way.  G and I walk the plan's order with the
same per-ray slab test and take rule, a CTA's warps testing the (ray,
block) pairs of each staged block together (``csrc/block_stream.cu``);
H walks the same way the blocks of the slabs its JAX gate lets through;
so the five give the same winners and flags.  The plain versions of G,
I and H walk the JAX kernels' schedule and count its tests and staged
blocks, and, in ``stats``, the CUDA walk's tests and the blocks it tests
(``walk_pairs``, ``walk_tested_blocks``; a CTA that stops has also
copied up to two blocks it does not test).
``shared_origin`` is accepted for the JAX signature and ignored: a
per-ray walk has no pair-invariant terms to hoist.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..utils.timing import span
from .accel import (SUPER, BlockGrid, interval_slab, ray_hulls,
                    tile_visit_plan_fast)
from .intersect import F32_MAX, HitData
from .megakernel import (GROUP_TILES, RAY_TILE, SceneRows, _Best, _Shade,
                         _chunks, _closest_plain, _mt, _occluded_plain, _ptr,
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
# kernels' VMEM, and the JAX package sends it to the streamed kernels; its
# fused kernels and oracle refuse it.  The card has no such limit (every
# kernel reads the planes from global memory through L2), so the port's
# fused kernels A-D take such a grid (``megakernel_ineligible_reason``).
# What the rule decides here is the staged integrator's route, E and F
# against G and I, and the oracle's: over the budget E's scan, one thread
# a ray over thousands of blocks, loses to G and I's per-tile walk
# (27.3 ms against 3.7 for the 1.27M-triangle frog's camera rays on an
# H100), and the detached mode serves a differentiable scene.  A module
# attribute, so that tests can lower it.
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
        # scratch: the list of rays to walk, that of (ray, light) entries
        # whose shadow ray walks, and their counters
        counts = torch.empty(4, dtype=torch.int32, device=dev)
        walks = torch.empty(r, dtype=torch.int32, device=dev)
        shadows = torch.empty(max(r * n_shadow, 1), dtype=torch.int32,
                              device=dev)
        with span("rt.launch.closest"):
            err = lib.rt_closest(ctypes.byref(args), _ptr(o), _ptr(d),
                                 _ptr(tm), r, int(with_normal), _ptr(lights),
                                 n_shadow, _ptr(t), _ptr(u), _ptr(v),
                                 _ptr(idx), _ptr(normal), _ptr(vis),
                                 _ptr(counts), _ptr(walks), _ptr(shadows),
                                 _stream())
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
        tm, tx = _per_ray(tmin, r, dev), _per_ray(tmax, r, dev)
        with span("rt.launch.occluded"):
            err = lib.rt_occluded(ctypes.byref(args), _ptr(o), _ptr(d),
                                  _ptr(tm), _ptr(tx), r, _ptr(blocked),
                                  _ptr(counts), _ptr(walks), _stream())
            _raise_on(lib, err, "occluded")
            block_occluded.launches += 1
    return blocked


# --- streamed kernels G, I and H: operands ------------------------------

BM_CHUNK_TILES = 64   # ray tiles per block-major ray chunk (32k rays)
BM_SLAB_BLOCKS = 64   # blocks per block-major scene slab
# G's, I's and H's CUDA walk (csrc/block_stream.cu kSplit, kPairLanes,
# kVote, kBuffers): the CTAs that share a tile (CTA p of a tile takes its
# rays p, p + STREAM_SPLIT, ...), the lanes that test one (ray, block) pair,
# the triangles an occlusion pair tests between votes, the blocks staged
# in flight
STREAM_SPLIT = 2
STREAM_LANES = 32
STREAM_VOTE = 128
STREAM_BUFFERS = 2


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
    return _pad_rays(rays, GROUP_TILES * RAY_TILE)


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
    whole superblocks.  Packed once a grid and kept on it (a grid is
    frozen and its tensors are never written in place)."""
    ops = grid.__dict__.get("_stream_operands")
    if ops is None:
        l = grid.num_blocks
        ls = -(-l // SUPER)
        tri, ids = _block_rows(grid, ls * SUPER)
        aabb_rows = F.pad(grid.aabb.T, (0, 2, 0, (-l) % 8))
        ops = (tri, ids, aabb_rows.contiguous(), ls)
        object.__setattr__(grid, "_stream_operands", ops)
    return ops


def _slab_aabbs(grid: BlockGrid, slab_blocks: int):
    """H's slabs (``pallas_kernels.py:1155-1182``): the block AABBs (6,
    Lp) with the block axis padded to whole slabs (padding blocks empty:
    min inf, max -inf) and the slabs' union rows (J8, 8) -> (aabb, union
    rows, J).  H reads G's packed planes (``_stream_grid_operands``)."""
    l = grid.num_blocks
    j = -(-l // slab_blocks)
    lp = j * slab_blocks
    aabb = grid.aabb
    if lp > l:
        dev = aabb.device
        aabb = torch.cat([aabb, torch.cat([
            torch.full((3, lp - l), float("inf"), device=dev),
            torch.full((3, lp - l), float("-inf"), device=dev)])], dim=1)
    umin = aabb[:3].reshape(3, j, slab_blocks).amin(dim=2)
    umax = aabb[3:].reshape(3, j, slab_blocks).amax(dim=2)
    union_rows = F.pad(torch.cat([umin, umax]).T, (0, 2, 0, (-j) % 8))
    return aabb, union_rows.contiguous(), j


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
    pairs the JAX kernel's walk tests (lanes with a nonzero direction that
    pass their slab test; an occlusion lane up to its first hit) and the
    blocks it stages (a tile's block with any lane passing).  ``visit``'s
    ``kernel`` counts apart what G's and I's CUDA walk tests
    (``csrc/block_stream.cu``): each of a tile's STREAM_SPLIT CTAs still
    walking tests the blocks that some active lane of its own passes on
    the lane's window at the start (its candidates); I tests up to the
    vote after the first hit.  A CTA that stops has also copied the
    candidate it stops at and the one after it, which are not counted."""

    def __init__(self, rows: SceneRows, rays, det_eps: float, closest: bool,
                 n_rays: int = None):
        dev = rays.device
        self.rows, self.det_eps, self.closest = rows, det_eps, closest
        self.o, self.d = _soa(rays[:, 0:3]), _soa(rays[:, 3:6])
        self.inv = tuple(1.0 / c for c in self.d)
        # a zero direction cannot hit (its determinant is 0 < det_eps):
        # the kernels skip such rays, the parked shade points' shadow rays
        self.moving = (rays[:, 3:6] != 0.0).any(dim=1)
        self.tmin, self.tmax = rays[:, 6], rays[:, 7]
        rp = int(rays.shape[0])
        # the lanes that can hit: the CUDA walk's exit tests leave out the
        # others and the padding past the real rays
        real = torch.arange(rp, device=dev) < (rp if n_rays is None
                                                else n_rays)
        self.active = self.moving & real
        self.best = _Best(rp, dev)
        self.blocked = torch.zeros(rp, dtype=torch.bool, device=dev)
        self.occ_pairs = torch.zeros((), dtype=torch.int64, device=dev)
        self.staged = torch.zeros((), dtype=torch.int64, device=dev)
        self.walk_pairs = torch.zeros((), dtype=torch.int64, device=dev)
        self.walk_tested = torch.zeros((), dtype=torch.int64, device=dev)
        self.live = (rows.ids >= 0).sum(dim=1)  # live slots a block
        self.lane = torch.arange(RAY_TILE, device=dev)
        # optional callback (tiles, lanes, boxed) of every visit, for
        # profiling the walk
        self.log = None

    def lanes(self, tiles):
        return (tiles[:, None] * RAY_TILE + self.lane).reshape(-1)

    def visit(self, tiles, blocks, kernel=None) -> None:
        """Tile ``tiles[i]`` visits block ``blocks[i]``; blocks past the
        grid are skipped, as the kernels skip them.  ``kernel``: (T,
        STREAM_SPLIT) bool, whether each CUDA CTA of tile ``tiles[i]`` is
        still walking."""
        rows = self.rows
        nb, bs = rows.num_blocks, rows.block_size
        lanes = self.lanes(tiles)
        blk = torch.clamp(blocks, max=nb - 1).repeat_interleave(RAY_TILE)
        a = rows.aabb[blk].T
        o = tuple(c[lanes] for c in self.o)
        inv = tuple(c[lanes] for c in self.inv)
        window = self.best.t[lanes] if self.closest else self.tmax[lanes]
        in_grid = (blocks < nb).repeat_interleave(RAY_TILE)
        boxed = _slab(a, o, inv, self.tmin[lanes], window)
        boxed &= in_grid & self.moving[lanes]
        if not self.closest:
            boxed &= ~self.blocked[lanes]
        if self.log is not None:
            self.log(tiles, lanes, boxed)
        self.staged += boxed.reshape(-1, RAY_TILE).any(dim=1).sum()
        counted = None
        if kernel is not None:
            start = (torch.full_like(window, F32_MAX) if self.closest
                     else self.tmax[lanes])
            cand = (_slab(a, o, inv, self.tmin[lanes], start) & in_grid
                    & self.active[lanes]).reshape(
                        -1, RAY_TILE // STREAM_SPLIT, STREAM_SPLIT).any(dim=1)
            self.walk_tested += (cand & kernel).sum()
            counted = kernel[:, None, :].expand(
                -1, RAY_TILE // STREAM_SPLIT, -1).reshape(-1)[boxed]
        sub, sblk = lanes[boxed], blk[boxed]
        if sub.numel() == 0:
            return
        if counted is not None and self.closest:
            self.walk_pairs += self.live[sblk[counted]].sum()
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
                self._any_hit(ch, tri, ids,
                              None if counted is None else counted[part])

    def _any_hit(self, ch, tri, ids, counted) -> None:
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
        if counted is not None:
            # the CUDA walk's pair votes every STREAM_VOTE slots
            last = torch.clamp((first // STREAM_VOTE + 1) * STREAM_VOTE,
                               max=ids.shape[1]) - 1
            tests = torch.where(hit, upto.gather(1, last)[:, 0], upto[:, -1])
            self.walk_pairs += tests[counted].sum()
        self.blocked[ch] |= hit

    def tally(self, stats, kernel: bool = False) -> None:
        _tally(stats, self.best.pairs + self.occ_pairs)
        if stats is not None:
            stats["staged_blocks"] = (stats.get("staged_blocks", 0)
                                      + int(self.staged))
            if kernel:
                for key, n in (("walk_pairs", self.walk_pairs),
                               ("walk_tested_blocks", self.walk_tested)):
                    stats[key] = stats.get(key, 0) + int(n)

    def hits(self, r: int) -> HitData:
        b = self.best
        idx = b.id[:r].to(torch.int32)
        return HitData(t=b.t[:r], u=b.u[:r], v=b.v[:r], tri_idx=idx,
                       hit=idx >= 0)


def _plan_walk_plain(rays, grid: BlockGrid, rows: SceneRows, det_eps: float,
                     closest: bool, stats, n_rays: int, log=None) -> _TileWalk:
    """G's (``closest``) or I's walk: each tile's plan row in order, while
    the next entry is <= the tile's largest best t (G), or is finite and
    a lane of the tile is unblocked (I).  With ``stats``, the CUDA walk's
    tests and tested blocks too: each CTA of a tile stops once the entry
    exceeds every active lane's best t (G) or every active lane is blocked
    (I), its own lanes, tested before each block.  ``log``:
    ``_TileWalk.log``."""
    rp = int(rays.shape[0])
    nt = rp // RAY_TILE
    walk = _TileWalk(rows, rays, det_eps, closest, n_rays)
    walk.log = log
    order, entry, _ = tile_visit_plan_fast(
        rays[:, 0:3], rays[:, 3:6], grid, rays[:, 6], rays[:, 7], RAY_TILE)
    walking = torch.ones(nt, dtype=torch.bool, device=rays.device)
    kernel = torch.ones(nt, STREAM_SPLIT, dtype=torch.bool,
                        device=rays.device)
    # (tile, ray of its CTA, CTA): CTA p holds the tile's rays p, p + S, ...
    cta = (nt, RAY_TILE // STREAM_SPLIT, STREAM_SPLIT)
    active = walk.active.reshape(cta)
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
            if stats is not None:
                if closest:
                    m = torch.where(active[tiles],
                                    walk.best.t.reshape(cta)[tiles],
                                    -float("inf")).amax(dim=1)
                    kernel[tiles] &= entry[tiles, k, None] <= m
                else:
                    kernel[tiles] &= (active[tiles] & ~walk.blocked.reshape(
                        cta)[tiles]).any(dim=1)
            walk.visit(tiles, sb * SUPER + j,
                       None if stats is None else kernel[tiles])
    walk.tally(stats, kernel=True)
    return walk


def _blockmajor_plain(rays, grid: BlockGrid, rows: SceneRows, det_eps: float,
                      closest: bool, chunk_tiles: int, slab_blocks: int,
                      stats, n_rays: int, log=None) -> _TileWalk:
    """H's sweep: the rays padded to whole chunks, the (I, J) gate, then
    for each slab j the tiles of the chunks the gate lets through, blocks
    of the slab in order.  With ``stats``, the CUDA walk's tests and
    tested blocks too: its candidates are the same blocks, each tile's in
    block order, and each CTA of a tile stops once every active lane of
    its own is blocked (occlusion; closest hit has no exit).  ``log``:
    ``_TileWalk.log``."""
    rays, rp = _pad_rays(rays, chunk_tiles * RAY_TILE)
    _, union_rows, nj = _slab_aabbs(grid, slab_blocks)
    gate = _chunk_slab_gate(rays, chunk_tiles * RAY_TILE, union_rows, nj)
    walk = _TileWalk(rows, rays, det_eps, closest, n_rays)
    walk.log = log
    nt = rp // RAY_TILE
    kernel = torch.ones(nt, STREAM_SPLIT, dtype=torch.bool,
                        device=rays.device)
    active = walk.active.reshape(nt, RAY_TILE // STREAM_SPLIT, STREAM_SPLIT)
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
            if stats is not None and not closest:
                kernel[tiles] &= (active[tiles] & ~walk.blocked.reshape(
                    active.shape)[tiles]).any(dim=1)
            walk.visit(tiles, torch.full_like(tiles, gb),
                       None if stats is None else kernel[tiles])
    walk.tally(stats, kernel=True)
    return walk


def block_closest_streamed_plain(origins, dirs, grid: BlockGrid, tmin=1e-4, *,
                                 det_eps: float = 1e-8, rows: SceneRows = None,
                                 stats=None) -> HitData:
    """Plain version of ``block_closest_streamed`` (G); ``stats`` as in
    ``block_closest_plain``, plus ``"staged_blocks"``: the blocks the
    kernel stages into shared memory."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, F32_MAX)
    r = int(origins.shape[0])
    walk = _plan_walk_plain(rays, grid, rows, det_eps, True, stats, r)
    return walk.hits(r)


def block_occluded_streamed_plain(origins, dirs, grid: BlockGrid, tmin=1e-4,
                                  tmax=F32_MAX, *, det_eps: float = 1e-8,
                                  rows: SceneRows = None,
                                  stats=None) -> torch.Tensor:
    """Plain version of ``block_occluded_streamed`` (I)."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, tmax)
    r = int(origins.shape[0])
    walk = _plan_walk_plain(rays, grid, rows, det_eps, False, stats, r)
    return walk.blocked[:r]


def block_closest_blockmajor_plain(origins, dirs, grid: BlockGrid, tmin=1e-4,
                                   *, det_eps: float = 1e-8,
                                   chunk_tiles: int = BM_CHUNK_TILES,
                                   slab_blocks: int = BM_SLAB_BLOCKS,
                                   rows: SceneRows = None,
                                   stats=None) -> HitData:
    """Plain version of ``block_closest_blockmajor`` (H, closest)."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, F32_MAX)
    r = int(origins.shape[0])
    walk = _blockmajor_plain(rays, grid, rows, det_eps, True, chunk_tiles,
                             slab_blocks, stats, r)
    return walk.hits(r)


def block_occluded_blockmajor_plain(origins, dirs, grid: BlockGrid, tmin=1e-4,
                                    tmax=F32_MAX, *, det_eps: float = 1e-8,
                                    chunk_tiles: int = BM_CHUNK_TILES,
                                    slab_blocks: int = BM_SLAB_BLOCKS,
                                    rows: SceneRows = None,
                                    stats=None) -> torch.Tensor:
    """Plain version of ``block_occluded_blockmajor`` (H, occlusion)."""
    rows = grid_rows(grid) if rows is None else rows
    rays, _ = _prep_rays(origins, dirs, tmin, tmax)
    r = int(origins.shape[0])
    walk = _blockmajor_plain(rays, grid, rows, det_eps, False, chunk_tiles,
                             slab_blocks, stats, r)
    return walk.blocked[:r]


# --- streamed kernels: wrappers --------------------------------------------


def _check_grid(grid: BlockGrid, dev) -> None:
    """The streamed kernels read the grid through raw pointers."""
    for name in ("tri", "aabb", "tri_index"):
        t = getattr(grid, name)
        if t.device != dev:
            raise ValueError(f"grid.{name} on {t.device}, rays on {dev}")
    if grid.tri.dtype != torch.float32 or grid.aabb.dtype != torch.float32:
        raise ValueError("grid planes and AABBs must be float32")


def _streamed_launch(origins, dirs, grid: BlockGrid, tmin, tmax,
                     det_eps: float, occluded: bool):
    """G's (``occluded`` False) or I's operands for (R, 3) rays on the
    card: the rays padded to whole tiles, their plan, the tiles in
    launch order (the longest plans first, so that the CTAs that walk
    the most start first) and the grid's block-major operands -> a
    function that launches the kernel on them and returns its padded
    outputs: (t, u, v, idx), or the blocked flags."""
    from ._native import load

    dev = origins.device
    _check_grid(grid, dev)
    r = int(origins.shape[0])
    rays, rp = _prep_rays(origins.contiguous(), dirs.contiguous(), tmin, tmax)
    order, entry, count = tile_visit_plan_fast(
        rays[:, 0:3], rays[:, 3:6], grid, rays[:, 6], rays[:, 7], RAY_TILE)
    count = count[:, 0].to(torch.int32).contiguous()
    tiles = torch.sort(count, descending=True, stable=True)[1].to(
        torch.int32)
    tri, ids, aabb, ls = _stream_grid_operands(grid)
    t = torch.empty(rp, dtype=torch.float32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    idx = torch.empty(rp, dtype=torch.int32, device=dev)
    blocked = torch.empty(rp, dtype=torch.bool, device=dev)

    def launch():
        lib = load("block_stream")
        err = lib.rt_streamed(
            _ptr(rays), _ptr(aabb), _ptr(order), _ptr(entry), _ptr(count),
            _ptr(tiles), _ptr(tri), _ptr(ids), rp // RAY_TILE, r,
            grid.num_blocks, ls, grid.block_size, det_eps, int(occluded),
            _ptr(t), _ptr(u), _ptr(v), _ptr(idx), _ptr(blocked), _stream())
        _raise_on(lib, err, "occluded_streamed" if occluded
                  else "closest_streamed")
        return blocked if occluded else (t, u, v, idx)

    return launch


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
    if not r:
        t = origins.new_empty(0)
        i = torch.empty(0, dtype=torch.int32, device=origins.device)
        return HitData(t=t, u=t, v=t, tri_idx=i, hit=i >= 0)
    launch = _streamed_launch(origins, dirs, grid, tmin, F32_MAX, det_eps,
                              False)
    with span("rt.launch.closest_streamed"):
        t, u, v, idx = launch()
        block_closest_streamed.launches += 1
    return HitData(t=t[:r], u=u[:r], v=v[:r], tri_idx=idx[:r],
                   hit=idx[:r] >= 0)


def block_occluded_streamed(origins, dirs, grid: BlockGrid, tmin=1e-4,
                            tmax=F32_MAX, *, det_eps: float = 1e-8,
                            rows: SceneRows = None) -> torch.Tensor:
    """Any hit on [tmin, tmax] (each a float or (R,)) per ray by the same
    plan walk (I), each tile stopping once every lane is blocked -> (R,)
    bool; ``rows`` as in ``block_closest_streamed``."""
    _check_rays(origins, dirs)
    if origins.device.type == "cpu":
        return block_occluded_streamed_plain(origins, dirs, grid, tmin, tmax,
                                             det_eps=det_eps, rows=rows)
    r = int(origins.shape[0])
    if not r:
        return torch.empty(0, dtype=torch.bool, device=origins.device)
    launch = _streamed_launch(origins, dirs, grid, tmin, tmax, det_eps, True)
    with span("rt.launch.occluded_streamed"):
        blocked = launch()
        block_occluded_streamed.launches += 1
    return blocked[:r]


def _blockmajor_launch(origins, dirs, grid: BlockGrid, tmin, tmax,
                       det_eps: float, occluded: bool, chunk_tiles: int,
                       slab_blocks: int):
    """H's operands for (R, 3) rays on the card: the rays padded to whole
    chunks, the (I, J) gate and the slabs' union boxes, the tiles in
    launch order (the most gated blocks first, so that the CTAs that walk
    the most start first) and G's packed planes -> a function that
    launches the kernel on them and returns its padded outputs: (t, u,
    v, idx), or the blocked flags."""
    from ._native import load

    if chunk_tiles <= 0 or slab_blocks <= 0:
        raise ValueError("chunk_tiles and slab_blocks must be positive")
    dev = origins.device
    _check_grid(grid, dev)
    r = int(origins.shape[0])
    rays, _ = _prep_rays(origins.contiguous(), dirs.contiguous(), tmin, tmax)
    rays, rp = _pad_rays(rays, chunk_tiles * RAY_TILE)
    _, union_rows, nj = _slab_aabbs(grid, slab_blocks)
    gate = _chunk_slab_gate(rays, chunk_tiles * RAY_TILE, union_rows,
                            nj).contiguous()
    in_slab = torch.clamp(grid.num_blocks - slab_blocks * torch.arange(
        nj, device=dev), max=slab_blocks)
    gated = (gate * in_slab).sum(dim=1).repeat_interleave(chunk_tiles)
    tiles = torch.sort(gated, descending=True, stable=True)[1].to(
        torch.int32)
    tri, ids, aabb, _ = _stream_grid_operands(grid)
    t = torch.empty(rp, dtype=torch.float32, device=dev)
    u, v = torch.empty_like(t), torch.empty_like(t)
    idx = torch.empty(rp, dtype=torch.int32, device=dev)
    blocked = torch.empty(rp, dtype=torch.bool, device=dev)

    def launch():
        lib = load("block_stream")
        err = lib.rt_blockmajor(
            _ptr(rays), _ptr(aabb), _ptr(gate), _ptr(union_rows),
            _ptr(tiles), _ptr(tri), _ptr(ids), rp // RAY_TILE, r,
            grid.num_blocks, nj, slab_blocks,
            chunk_tiles, grid.block_size, det_eps, int(occluded), _ptr(t),
            _ptr(u), _ptr(v), _ptr(idx), _ptr(blocked), _stream())
        _raise_on(lib, err, "occluded_blockmajor" if occluded
                  else "closest_blockmajor")
        return blocked if occluded else (t, u, v, idx)

    return launch


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
    launch = _blockmajor_launch(origins, dirs, grid, tmin, F32_MAX, det_eps,
                                False, chunk_tiles, slab_blocks)
    with span("rt.launch.closest_blockmajor"):
        t, u, v, idx = launch()
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
    launch = _blockmajor_launch(origins, dirs, grid, tmin, tmax, det_eps,
                                True, chunk_tiles, slab_blocks)
    with span("rt.launch.occluded_blockmajor"):
        blocked = launch()
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
