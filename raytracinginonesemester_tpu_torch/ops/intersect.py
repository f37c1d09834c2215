"""Batched ray-triangle intersection (Moller-Trumbore) and hit records.

PyTorch port of ``raytracinginonesemester_tpu.ops.intersect``: the hit
record, the brute-force closest hit and any-hit over the whole triangle
soup (the staged integrator's path for a scene without a block grid;
the JAX package has no kernel there either), the per-ray single-triangle
test, and the hit frame in the three reference dialects
(``HW1/include/ray.h:67-117``, ``CPUOnly/include/ray.h:48-97``,
``GPUandCPU/include/query.h:72-132``).  Plain PyTorch on any device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["HitData", "FLT_EPSILON", "F32_MAX", "mt_single",
           "intersect_closest", "occluded", "make_hit_frame"]

FLT_EPSILON = 1.1920929e-7  # std::numeric_limits<float>::epsilon()
F32_MAX = float(np.finfo(np.float32).max)  # 3.4028235e38


@dataclasses.dataclass(frozen=True)
class HitData:
    """Closest-hit result for a wavefront of rays (all leading shape R)."""

    t: torch.Tensor  # (R,) float32, F32_MAX where no hit
    u: torch.Tensor  # (R,) barycentric
    v: torch.Tensor  # (R,)
    tri_idx: torch.Tensor  # (R,) int32, -1 where no hit
    hit: torch.Tensor  # (R,) bool


def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _tuv(o, d, v0, e1, e2, det_eps: float):
    """Moller-Trumbore algebra (``query.h:77-103``) on broadcast shapes
    (..., 3) -> (t, u, v, det_ok), without the inside test."""
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < det_eps, 1.0, det)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    return t, u, v, det.abs() >= det_eps


def mt_single(o, d, tri, det_eps: float):
    """Per-ray single-triangle Moller-Trumbore: o, d (R, 3) against one
    paired triangle each, tri (R, 3, 3) -> raw (t, u, v), no acceptance
    test."""
    v0 = tri[:, 0]
    t, u, v, _ = _tuv(o, d, v0, tri[:, 1] - v0, tri[:, 2] - v0, det_eps)
    return t, u, v


def _chunk_hits(o, d, tri, det_eps, tmin, tmax):
    """(R, 3) rays vs a (C, 3, 3) triangle chunk -> (t, u, v, ok) (R, C)
    with the hard inside test (``query.h:104-108``) and [tmin, tmax]."""
    v0 = tri[None, :, 0]
    e1 = tri[None, :, 1] - v0
    e2 = tri[None, :, 2] - v0
    t, u, v, det_ok = _tuv(o[:, None], d[:, None], v0, e1, e2, det_eps)
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= tmin[:, None]) & (t <= tmax[:, None]))
    return t, u, v, ok


def _bounds(tmin, tmax, r, dev):
    def full(x):
        return torch.broadcast_to(
            torch.as_tensor(x, dtype=torch.float32, device=dev), (r,))

    return full(tmin), full(tmax)


def intersect_closest(origins, dirs, vertices, tmin=1e-4, tmax=F32_MAX, *,
                      det_eps: float = 1e-8, chunk: int = 512) -> HitData:
    """Closest hit of each ray against all triangles ``vertices``
    (T, 3, 3), T a multiple of ``chunk``; ``tmin``/``tmax`` broadcast to
    (R,).  Strictly closer wins, so the lowest triangle index survives
    equal t (the reference's sequential scan)."""
    r = origins.shape[0]
    dev = origins.device
    n_tri = vertices.shape[0]
    chunk = min(chunk, n_tri)
    if n_tri % chunk:
        raise ValueError("triangle count must be padded to the chunk size")
    tmin, tmax = _bounds(tmin, tmax, r, dev)
    best_t = torch.full((r,), F32_MAX, device=dev)
    best_u = torch.zeros(r, device=dev)
    best_v = torch.zeros(r, device=dev)
    best_idx = torch.full((r,), -1, dtype=torch.int32, device=dev)
    rows = torch.arange(r, device=dev)
    for c in range(n_tri // chunk):
        t, u, v, ok = _chunk_hits(origins, dirs,
                                  vertices[c * chunk:(c + 1) * chunk],
                                  det_eps, tmin, tmax)
        t = torch.where(ok, t, F32_MAX)
        ct, j = t.min(dim=1)  # first index of the minimum
        better = ct < best_t
        best_u = torch.where(better, u[rows, j], best_u)
        best_v = torch.where(better, v[rows, j], best_v)
        best_idx = torch.where(better, (c * chunk + j).to(torch.int32),
                               best_idx)
        best_t = torch.where(better, ct, best_t)
    return HitData(t=best_t, u=best_u, v=best_v, tri_idx=best_idx,
                   hit=best_idx >= 0)


def occluded(origins, dirs, vertices, tmin=1e-4, tmax=F32_MAX, *,
             det_eps: float = 1e-8, chunk: int = 512) -> torch.Tensor:
    """Any-hit occlusion: True where a triangle blocks [tmin, tmax]
    (``ShadowVisibility``, ``IsInShadow``)."""
    r = origins.shape[0]
    dev = origins.device
    n_tri = vertices.shape[0]
    chunk = min(chunk, n_tri)
    if n_tri % chunk:
        raise ValueError("triangle count must be padded to the chunk size")
    tmin, tmax = _bounds(tmin, tmax, r, dev)
    blocked = torch.zeros(r, dtype=torch.bool, device=dev)
    for c in range(n_tri // chunk):
        ok = _chunk_hits(origins, dirs, vertices[c * chunk:(c + 1) * chunk],
                         det_eps, tmin, tmax)[3]
        blocked = blocked | ok.any(dim=1)
    return blocked


def make_hit_frame(origins, dirs, hits: HitData, vertices, normals,
                   mode: str = "gpu"):
    """Hit position, shading normal and front_face of a ``HitData``.

    - ``"hw1"``: raw interpolated vertex normal (``HW1/include/ray.h:108-110``);
    - ``"cpuonly"``: the face normal picks the side; the normalised
      interpolation is flipped to it (``CPUOnly/include/ray.h:76-92``);
    - ``"gpu"``: geometric sidedness, zero-length fallback, hemisphere
      alignment (``GPUandCPU/include/query.h:113-126``).

    The geometric normal is normalised with ``max(len, 1e-20)`` as in the
    JAX package (the block grid clamps ``len**2`` at 1e-38 instead; each
    keeps its own).  Values where ``hits.hit`` is False are arbitrary."""
    idx = torch.clamp(hits.tri_idx.long(), min=0)
    tri = vertices[idx]  # (R, 3, 3)
    tn = normals[idx]
    u, v = hits.u[:, None], hits.v[:, None]
    w = 1.0 - u - v
    p = origins + hits.t[:, None] * dirs
    interp = w * tn[:, 0] + u * tn[:, 1] + v * tn[:, 2]

    geom = _cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    geom_len = torch.sqrt(_dot(geom, geom))[:, None]
    geom_n = geom / torch.clamp(geom_len, min=1e-20)
    front_face = _dot(dirs, geom_n) < 0.0
    if mode == "hw1":
        return p, interp, front_face

    oriented_geom = torch.where(front_face[:, None], geom_n, -geom_n)
    interp_len_sq = _dot(interp, interp)[:, None]
    shade_n = interp / torch.sqrt(torch.clamp(interp_len_sq, min=1e-24))
    if mode == "cpuonly":
        return p, torch.where(front_face[:, None], shade_n, -shade_n), front_face
    if mode == "gpu":
        shade_n = torch.where(interp_len_sq < 1e-12, oriented_geom, shade_n)
        flip = _dot(shade_n, oriented_geom)[:, None] < 0.0
        return p, torch.where(flip, -shade_n, shade_n), front_face
    raise ValueError(f"unknown hit-frame mode {mode!r}")
