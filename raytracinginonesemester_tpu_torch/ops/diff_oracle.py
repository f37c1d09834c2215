"""Fused detached oracle of the differentiable integrator.

PyTorch port of ``raytracinginonesemester_tpu.ops.diff_oracle``.  One
``bounce_step_tiles(diff_out=True)`` launch per depth (kernel B with its
oracle rows) runs the whole bounce on the ray wavefront and returns what
the differentiable chain needs and cannot differentiate: the winner's t,
u, v and id, the per-light shadow visibility and the branch decisions.
``ops.integrator`` then recomputes everything a gradient flows through
(the winner's Moller-Trumbore, the hit frame, the BRDF) from those rows,
and takes the decisions as they are, so the kernel and the chain cannot
take different branches and the rng streams stay in lockstep.

The walk is the flat block scan at every depth (the port has no
``bounce_tile_plan``); a binned camera plan, when given, serves depth 0.
Everything returned is detached.
"""

from __future__ import annotations

import torch

from ..core import rng as rnglib
from .block_kernels import fits_vmem
from .megakernel import (_ST_ROWS, RAY_TILE, _scene_rows, bounce_step_tiles,
                         padded_rays)

__all__ = ["MAX_ORACLE_LIGHTS", "fused_bounce_oracle", "oracle_eligible",
           "pack_rays"]

# the visibility bits ride an exact-integer float32 row: 24 bits
MAX_ORACLE_LIGHTS = 24


def oracle_eligible(scene, model_axis=None) -> bool:
    """Whether the fused oracle serves this scene: a block grid under the
    plane budget (``block_kernels.fits_vmem``, the JAX package's rule;
    kernel B itself reads the planes from global memory), the gpu dialect,
    1 to 24 lights and no triangle sharding."""
    if scene.accel is None or model_axis is not None:
        return False
    if not fits_vmem(scene.accel):
        return False  # the streamed kernels' detached mode serves it
    if scene.dialect != "gpu":
        return False  # cpuonly soft shadows: no capture
    return 1 <= scene.lights.num_lights <= MAX_ORACLE_LIGHTS


@torch.no_grad()
def pack_rays(origins, dirs, seeds):
    """(R, 3) rays and their rng ``seeds`` (R,) -> the kernels' packed
    camera state (state (nt*16, RAY_TILE) float32, rng (nt*8, RAY_TILE)
    int32), padded to whole 8-tile groups with dead rays parked at 1e30
    (``diff_oracle.py:83-111`` of the JAX package)."""
    dev = origins.device
    r = int(origins.shape[0])
    rp = padded_rays(r)
    nt = rp // RAY_TILE

    def stream(x, fill):
        out = torch.full((rp,), fill, dtype=x.dtype, device=dev)
        out[:r] = x
        return out.reshape(nt, RAY_TILE)

    o, d = origins.detach(), dirs.detach()
    zeros = torch.zeros(nt, RAY_TILE, device=dev)
    ones = torch.ones(nt, RAY_TILE, device=dev)
    planes = ([stream(o[:, k], 1e30) for k in range(3)]
              + [stream(d[:, 0], 0.0), stream(d[:, 1], 0.0),
                 stream(d[:, 2], 1.0)]
              + [ones] * 3 + [zeros] * 3
              + [stream(torch.ones(r, device=dev), 0.0)]
              + [zeros] * (_ST_ROWS - 13))
    st = torch.stack(planes, dim=1).reshape(nt * _ST_ROWS, RAY_TILE)
    rng = torch.zeros(nt, 8, RAY_TILE, dtype=torch.int32, device=dev)
    rng[:, 0] = stream(rnglib.to_i32(rnglib.to_u32(seeds.detach())), 0)
    return st, rng.reshape(nt * 8, RAY_TILE)


@torch.no_grad()
def fused_bounce_oracle(origins, dirs, seeds, scene, max_depth: int, *,
                        det_eps: float, tmin: float, shadow_eps: float,
                        shadow_tmin: float, cand_plan=None) -> dict:
    """Run ``max_depth`` oracle bounces on (R, 3) rays with rng ``seeds``
    (R,) and return per-depth lists of (R,) tensors: ``t``, ``u``, ``v``
    float32, ``idx`` int32 (-1 on a miss), ``vis`` int32 per-light
    unoccluded bits, ``dec`` int32 decision bits (1 found, 2 diffuse, 4
    mirror, 8 alive after).

    The rays are packed by ``pack_rays``.  ``cand_plan``: a binned camera
    plan (``ops.binned``) for exactly this padded tile stream and the
    scene's camera, its stream refreshed against the current grid; it
    serves depth 0."""
    r = int(origins.shape[0])
    st, rng = pack_rays(origins, dirs, seeds)
    nt = st.shape[0] // _ST_ROWS
    rp = nt * RAY_TILE
    rows = _scene_rows(scene, scene.accel)
    kw = dict(det_eps=det_eps, tmin=tmin, shadow_eps=shadow_eps,
              shadow_tmin=shadow_tmin, dialect="gpu", diff_out=True,
              rows=rows)
    out = dict(t=[], u=[], v=[], idx=[], vis=[], dec=[])
    for k in range(int(max_depth)):
        st, rng, diff = bounce_step_tiles(
            scene, st, rng, cand_plan=cand_plan if k == 0 else None, **kw)
        dv = diff.reshape(nt, 8, RAY_TILE).transpose(0, 1).reshape(8, rp)
        dv = dv[:, :r]
        out["t"].append(dv[0])
        out["u"].append(dv[1])
        out["v"].append(dv[2])
        for key, row in (("idx", 3), ("vis", 4), ("dec", 5)):
            out[key].append(dv[row].to(torch.int32))
    return out
