"""BVH traversal: the reference's SearchBVH as a lockstep stack walk.

PyTorch port of ``raytracinginonesemester_tpu.ops.traversal``.
``SearchBVH`` (``GPUandCPU/include/query.h:224-311``) pops an explicit
per-ray stack, prunes with the slab test against the running closest t,
and falls back to brute force on stack overflow.  Here every live ray
makes one pop/test/push step a round, in plain PyTorch on the rays'
device.  Each ray's steps are the JAX package's, so its winner is too;
what differs is the schedule:

- rays whose stacks are empty leave the walk, and each round works on
  the live rays only (one device-to-host read a round, as the JAX
  package's loop condition);
- only the rays whose stacks overflowed are brute-forced (the JAX
  package brute-forces the whole batch when any ray overflows); a ray's
  result is the same either way.

This is the exact traversal for parity checks; the render paths walk
the block grid (``ops.block_kernels``).
"""

from __future__ import annotations

import torch

from .intersect import F32_MAX, HitData, _tuv, intersect_closest
from .lbvh import INVALID, Lbvh

__all__ = ["bvh_closest", "STACK_DEPTH"]

# 64-bit keys bound the radix-tree depth by 64 (the reference uses 512,
# query.h:242); overflow falls back to brute force.
STACK_DEPTH = 64


def _slab_test(o, inv_d, box_min, box_max, tmin, tmax) -> torch.Tensor:
    """Ray/AABB slab test (``intersectAABB``, ``bvh.h:81-129``) with IEEE
    inf for zero direction components, a NaN axis (origin on a slab
    plane) passed through, and the far plane stretched by 4 ulp (Ize
    2013) so that the test stays conservative.  (..., 3) -> (...,) bool."""
    t1 = (box_min - o) * inv_d
    t2 = (box_max - o) * inv_d
    t_near = torch.minimum(t1, t2)
    t_far = torch.maximum(t1, t2)
    t_near = torch.where(torch.isnan(t_near), float("-inf"), t_near)
    t_far = torch.where(torch.isnan(t_far), float("inf"), t_far * 1.0000004)
    t0 = torch.maximum(t_near.amax(dim=-1), tmin)
    t1_ = torch.minimum(t_far.amin(dim=-1), tmax)
    return t0 <= t1_


def bvh_closest(origins, dirs, bvh: Lbvh, vertices, tmin=1e-4, *,
                det_eps: float = 1e-8, stats=None) -> HitData:
    """Closest hit of (R, 3) rays by the lockstep stack walk of ``bvh``
    over ``vertices`` (T, 3, 3) in their original order (a leaf's
    ``object_idx`` indexes them, ``bvh.cu:34-56``); T is a multiple of
    512 or below it, for the brute force of overflowed rays, as in the
    JAX package.  A leaf replaces the
    running best when ``t <= best_t``: of equal t, the leaf tested last
    wins, as in the JAX package.  ``stats``: optional dict that receives
    the walk's ``rounds`` and its ``overflowed`` rays."""
    r = int(origins.shape[0])
    dev = origins.device
    num_tris = int(vertices.shape[0])
    tmin = torch.broadcast_to(torch.as_tensor(tmin, dtype=torch.float32,
                                              device=dev), (r,)).contiguous()
    inv_d = 1.0 / dirs
    v0 = vertices[:, 0]
    e1 = vertices[:, 1] - v0
    e2 = vertices[:, 2] - v0

    stack = torch.zeros(r, STACK_DEPTH, dtype=torch.int32, device=dev)
    sp = torch.ones(r, dtype=torch.int64, device=dev)  # the root pre-pushed
    best_t = torch.full((r,), F32_MAX, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)
    best_idx = torch.full((r,), -1, dtype=torch.int64, device=dev)
    overflow = torch.zeros(r, dtype=torch.bool, device=dev)

    act = torch.arange(r, device=dev)
    rounds = 0
    while act.numel():
        rounds += 1
        o, d, inv, tm = origins[act], dirs[act], inv_d[act], tmin[act]
        bt = best_t[act]
        top = sp[act] - 1
        node = stack[act, top].long()
        sp_a = top
        live = _slab_test(o, inv, bvh.aabb_min[node], bvh.aabb_max[node],
                          tm, bt)
        obj = bvh.object_idx[node]
        is_leaf = obj != INVALID

        # leaf: Moller-Trumbore against the running best (query.h:72-132)
        tri = torch.clamp(obj, 0, num_tris - 1)
        t, u, v, det_ok = _tuv(o, d, v0[tri], e1[tri], e2[tri], det_eps)
        ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
              & (u + v <= 1.0) & (t >= tm) & (t <= bt))
        take = live & is_leaf & ok
        best_t[act] = torch.where(take, t, bt)
        best_u[act] = torch.where(take, u, best_u[act])
        best_v[act] = torch.where(take, v, best_v[act])
        best_idx[act] = torch.where(take, tri, best_idx[act])

        # internal: push the children whose boxes pass (query.h:265-287)
        internal = live & ~is_leaf
        ov = overflow[act]
        for child in (bvh.left, bvh.right):
            c = torch.where(internal, child[node], 0)
            push = internal & _slab_test(o, inv, bvh.aabb_min[c],
                                         bvh.aabb_max[c], tm, bt)
            can = sp_a < STACK_DEPTH
            slot = torch.clamp(sp_a, max=STACK_DEPTH - 1)
            stack[act, slot] = torch.where(push & can, c.to(torch.int32),
                                           stack[act, slot])
            ov = ov | (push & ~can)
            sp_a = torch.where(push & can, sp_a + 1, sp_a)
        overflow[act] = ov
        sp[act] = sp_a
        act = act[sp_a > 0]

    # overflow fallback (query.h:298-308): brute force the overflowed rays
    ov_idx = torch.nonzero(overflow).flatten()
    if ov_idx.numel():
        brute = intersect_closest(origins[ov_idx], dirs[ov_idx], vertices,
                                  tmin=tmin[ov_idx], det_eps=det_eps)
        bt = best_t[ov_idx]
        take = brute.hit & (brute.t < bt)
        best_t[ov_idx] = torch.where(take, brute.t, bt)
        best_u[ov_idx] = torch.where(take, brute.u, best_u[ov_idx])
        best_v[ov_idx] = torch.where(take, brute.v, best_v[ov_idx])
        best_idx[ov_idx] = torch.where(take, brute.tri_idx.to(torch.int64),
                                       best_idx[ov_idx])
    if stats is not None:
        stats["rounds"] = rounds
        stats["overflowed"] = int(ov_idx.numel())
    best_idx = best_idx.to(torch.int32)
    return HitData(t=best_t, u=best_u, v=best_v, tri_idx=best_idx,
                   hit=best_idx >= 0)
