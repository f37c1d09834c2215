"""The staged integrator's closest-hit (E) and occlusion (F) kernels.

PyTorch/CUDA counterpart of ``raytracinginonesemester_tpu.ops.pallas_kernels``
(its resident kernels; the chunked, streamed and block-major variants
are VMEM schedules of the TPU):

- ``block_closest`` replaces ``pallas_block_closest`` → ``_closest_kernel``:
  the closest hit of each ray over the block grid, optionally with the
  gpu shading normal and the fused point-light shadow visibility;
- ``block_occluded`` replaces ``pallas_block_occluded`` →
  ``_occluded_kernel``: any hit in [tmin, tmax] per ray.

Each wrapper launches its hand-written CUDA kernel (``closest_kernel``,
``occluded_kernel`` in ``csrc/megakernel.cu``) for CUDA tensors and
calls its plain PyTorch version (``block_closest_plain``,
``block_occluded_plain``) for CPU tensors; there is no other path.  Both
run the flat block scan of kernels A and B: a per-ray slab test against
the running best t before each block, then the block's triangles with
the lexicographic (t, global triangle id) take rule, so winners do not
depend on visit order and equal the JAX kernels' superblock walk.
``shared_origin`` is accepted for the JAX signature and ignored: a
per-ray walk has no pair-invariant terms to hoist.
"""

from __future__ import annotations

import ctypes

import torch

from .accel import BlockGrid
from .intersect import F32_MAX, HitData
from .megakernel import (SceneRows, _Shade, _closest_plain, _occluded_plain,
                         _ptr, _raise_on, _scene_args, _shading_normal,
                         _stream, _tally)

__all__ = ["grid_rows", "block_closest", "block_occluded",
           "block_closest_plain", "block_occluded_plain", "launch_counts",
           "reset_launch_counts"]


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
        err = lib.rt_occluded(ctypes.byref(args), _ptr(o), _ptr(d),
                              _ptr(_per_ray(tmin, r, dev)),
                              _ptr(_per_ray(tmax, r, dev)), r, _ptr(blocked),
                              _stream())
        _raise_on(lib, err, "occluded")
        block_occluded.launches += 1
    return blocked


# launch counters: each wrapper adds one where it launches its kernel
_WRAPPERS = {"closest": block_closest, "occluded": block_occluded}
for _fn in _WRAPPERS.values():
    _fn.launches = 0


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
