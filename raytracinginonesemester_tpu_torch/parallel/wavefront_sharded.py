"""Compacted, load-balanced bounce scheduling under dp x tp meshes.

PyTorch port of ``raytracinginonesemester_tpu.parallel.wavefront_sharded``.
A scene whose block grid is split over a model axis takes the staged
integrator, which would trace every ray at every depth although few
survive depth 0, and whose survivors may crowd onto a few data ranks (an
object that fills one rank's pixel rows).  This scheduler runs the
integrator's own bounce step (``ops.integrator.make_bounce_step``, so
the per-ray math is the same) on rearranged rays:

1. depth 0 on every local ray (camera rays are dense);
2. one stable sort per rank packs the alive rays first, ordered by
   (direction octant, origin Morton) for coherence;
3. the sorted rays are dealt round-robin over the data ranks (row k to
   rank k mod S, one ``all_to_all``), so every rank holds about the mean
   alive count; the deal is an involution, so the same exchange brings
   the radiance home;
4. depths 1.. run on an alive-capacity prefix of the dealt rows; when any
   rank's survivors overflow it (the flag's MAX over the data ranks, so
   that all ranks agree), on every row.

Rays are only permuted whole, and a dead ray's bounce is a no-op, so the
radiance does not depend on the arrangement.  Under a model axis the
bounce step's hit merges pair up the model ranks of one data row; those
ranks sort the same rays identically, because the sort bounds come from
the replicated vertices (``_scene_bounds``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.rng import to_u32
from ..ops import comm
from ..ops.integrator import any_alive, make_bounce_step
from ..ops.lbvh import _bit_expand

__all__ = ["trace_rays_compacted"]

_I32_MAX = 2 ** 31 - 1


def _scene_bounds(scene):
    """Morton quantization bounds from the replicated vertices, never the
    block AABBs: those are split over the model axis, and per-shard
    bounds would sort one data row's rays differently on each model
    rank, so that the hit merges would combine different rays."""
    v = scene.geometry.vertices.detach()
    lo = [v[..., c].amin() for c in range(3)]
    span = [torch.clamp(v[..., c].amax() - lo[c], min=1e-20)
            for c in range(3)]
    return lo, span


def _sort_key(o, d, alive, lo, span):
    """(octant << 24) | 24-bit origin Morton of (R, 3) rays, INT32_MAX for
    dead rays: the packing key of ``ops.wavefront._sort_key``."""
    oct_ = ((d[:, 0] < 0.0).to(torch.int64) * 4
            | (d[:, 1] < 0.0).to(torch.int64) * 2
            | (d[:, 2] < 0.0).to(torch.int64))
    q = [torch.clamp((o[:, c] - lo[c]) / span[c] * 256.0, 0.0, 255.0)
         .to(torch.int64) for c in range(3)]
    morton = (_bit_expand(q[0]) | (_bit_expand(q[1]) << 1)
              | (_bit_expand(q[2]) << 2))
    return torch.where(alive, (oct_ << 24) | morton, _I32_MAX)


def _deal(x: torch.Tensor, group) -> torch.Tensor:
    """Round-robin deal of the rows of ``x`` (R, K) over the group's S
    ranks: row k goes to rank k % S, and row i of the result came from
    rank i % S, where it was row (i // S) * S + this rank.  Applying it
    twice is the identity."""
    s = comm.size(group)
    if s == 1:
        return x
    r, k = x.shape
    out = comm.all_to_all(x.reshape(r // s, s, k).transpose(0, 1).contiguous(),
                          group)
    return out.reshape(s, r // s, k).transpose(0, 1).reshape(r, k)


def trace_rays_compacted(origins, dirs, rng_state, scene, model_axis,
                         data_axis, capacity: Optional[int] = None
                         ) -> torch.Tensor:
    """Trace this rank's (R, 3) rays with sort compaction and the deal
    over ``data_axis`` (a process group, None for one rank) -> (R, 3)
    radiance in the caller's ray order, the radiance of
    ``ops.integrator.trace_rays``.  ``model_axis``: the group over which
    the block grid is split, as in ``make_bounce_step``.  ``capacity``:
    rows of the prefix that depths 1.. run on (default: the least power
    of two >= 512 and >= R / 8)."""
    bounce = make_bounce_step(scene, model_axis)
    gpu = scene.dialect == "gpu"
    max_depth = int(scene.max_bounces)
    r = origins.shape[0]
    dev = origins.device
    carry = (origins, dirs, torch.ones(r, 3, device=dev),
             torch.zeros(r, 3, device=dev), to_u32(rng_state),
             torch.ones(r, dtype=torch.bool, device=dev))
    carry = bounce(carry)  # depth 0 on the dense camera rays
    if max_depth <= 1:
        rad = carry[3]
        return torch.clamp(rad, 0.0, 1.0) if gpu else rad

    # pad to a multiple of the data size with dead rays, whose pixel keys
    # sort after every real ray's
    s = comm.size(data_axis)
    pad = (-r) % s
    rp = r + pad
    o, d, tp, rad, state, alive = (
        torch.cat([a, a.new_zeros((pad,) + a.shape[1:])]) for a in carry)
    lo, span = _scene_bounds(scene)
    key = _sort_key(o, d, alive, lo, span)
    pix = torch.arange(rp, dtype=torch.int64, device=dev)
    pix = torch.where(pix < r, pix, _I32_MAX - (rp - pix))

    perm = torch.sort(key, stable=True).indices
    ints = torch.stack([pix, state, alive.to(torch.int64)], dim=1)[perm]
    floats = torch.cat([o, d, tp, rad], dim=1)[perm]
    # no re-sort after the deal: the homing deal is its positional
    # inverse.  Row i came from rank i % s at sorted position i // s, so
    # rows [0, cap) hold every alive ray while no rank sorted more than
    # cap / s of them, which the overflow flag checks (conservatively,
    # by the rows [cap, rp) after the deal)
    ints, floats = _deal(ints, data_axis), _deal(floats, data_axis)

    def run_depths(n):
        f = floats[:n]
        c = (f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12], ints[:n, 1],
             ints[:n, 2] > 0)
        depth = 1
        while depth < max_depth and any_alive(c[5], model_axis):
            c = bounce(c)
            depth += 1
        return c[3]

    cap = capacity
    if cap is None:
        cap = 512
        while cap < rp // 8:
            cap *= 2
    cap = min(int(cap), rp)
    if cap < rp:
        flag = (ints[cap:, 2] > 0).any().to(torch.int32).reshape(1)
        overflow = bool(comm.all_reduce(flag, data_axis,
                                        torch.distributed.ReduceOp.MAX))
    if cap >= rp or overflow:
        rad = run_depths(rp)
    else:
        rad = torch.cat([run_depths(cap), floats[cap:, 9:12]])

    # home every ray (the deal is an involution), then the caller's order
    homed = _deal(torch.cat([ints[:, :1].to(torch.float64),
                             rad.to(torch.float64)], dim=1), data_axis)
    order = torch.argsort(homed[:, 0].to(torch.int64))
    radiance = homed[order[:r], 1:].to(torch.float32)
    return torch.clamp(radiance, 0.0, 1.0) if gpu else radiance
