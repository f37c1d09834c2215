"""Staged path integrator: a wavefront loop over depth with throughput and
radiance carried per ray.

PyTorch port of the forward path of ``raytracinginonesemester_tpu.ops.
integrator``: the iterative tracer of ``TraceRayIterative``
(``GPUandCPU/include/query.h:156-220``), the same semantics as CPUOnly's
recursive ``TraceRay`` (``CPUOnly/include/raytracer.h:215-260``).  Per
bounce: closest hit (kernel E, ``ops.block_kernels.block_closest``) ->
miss shading -> hit frame -> direct light with shadows (fused into E in
the gpu dialect, kernel F per shadow sample in cpuonly) ->
Russian-roulette diffuse/mirror split -> throughput update -> early-out.
This is the path for scenes the fused kernels (``ops.megakernel``) do
not take: ``reference_cpu`` jitter, gpu ``center`` jitter, cpuonly
scenes with more than 16 shadow samples, and scenes without a block
grid (brute force, ``ops.intersect``).

The glue between the kernels is plain PyTorch on the rays' device; the
rng is the reference's per-ray uint32 stream in int64 storage
(``core.rng``), drawn lane by lane only where a branch is taken.
"""

from __future__ import annotations

import torch

from ..core import rng as rnglib
from ..core.vecmath import reflect, unit
from .block_kernels import block_closest, block_occluded, grid_rows
from .intersect import FLT_EPSILON, intersect_closest, make_hit_frame, occluded
from .shading import RT_EPS_CPUONLY, RT_EPS_GPU, shade_direct, sky_gradient

__all__ = ["make_bounce_step", "trace_rays"]


def _check_forward(scene, model_axis, oracle) -> None:
    if model_axis is not None:
        raise NotImplementedError(
            "model_axis (triangle sharding) comes with the sharding slice")
    if oracle is not None or getattr(scene, "differentiable", False):
        raise NotImplementedError(
            "differentiable scenes come with the differentiable slice")


def make_bounce_step(scene, model_axis=None, oracle=None):
    """The integrator's single-bounce step for a scene:
    ``bounce(carry, first=False) -> carry`` over the wavefront carry
    ``(origins, dirs, throughput, radiance, rng_state, alive)``, the loop
    body of ``TraceRayIterative`` (``query.h:165-216``) with the scene's
    dialect rules.  Forward only: ``model_axis``, ``oracle`` and
    differentiable scenes raise ``NotImplementedError``.

    With a block grid, closest hits run kernel E (in the gpu dialect with
    the shading normal and the point lights' shadow visibility) and
    cpuonly shadow rays kernel F; without one, the brute-force scans of
    ``ops.intersect``.  ``first`` marks the pinhole camera pass, whose
    rays share one origin."""
    _check_forward(scene, model_axis, oracle)
    gpu = scene.dialect == "gpu"
    det_eps = 1e-8 if gpu else FLT_EPSILON
    offset_eps = RT_EPS_GPU if gpu else RT_EPS_CPUONLY
    tmin = 1e-4  # kRayTMin (query.h:230) == CPUOnly RT_EPS
    diffuse_bounce = bool(scene.diffuse_bounce)
    geom = scene.geometry
    mats = scene.materials

    if scene.accel is not None:
        rows = grid_rows(scene.accel)
        lights = scene.lights.position if gpu else None

        def closest_fn(o, d, shared=False):
            out = block_closest(o, d, scene.accel, tmin, det_eps=det_eps,
                                return_normal=gpu, shadow_lights=lights,
                                shadow_eps=RT_EPS_GPU, shadow_tmin=1e-4,
                                shared_origin=shared, rows=rows)
            return out if gpu else (out, None, None)

        def occlude_fn(o, d, s_tmin, s_tmax):
            return block_occluded(o, d, scene.accel, s_tmin, s_tmax,
                                  det_eps=det_eps, rows=rows)
    else:
        def closest_fn(o, d, shared=False):
            return (intersect_closest(o, d, geom.vertices, tmin,
                                      det_eps=det_eps), None, None)

        def occlude_fn(o, d, s_tmin, s_tmax):
            return occluded(o, d, geom.vertices, s_tmin, s_tmax,
                            det_eps=det_eps)

    def bounce(carry, first=False):
        o, d, throughput, radiance, state, alive = carry
        r = o.shape[0]
        # park dead rays where every slab test misses
        o = torch.where(alive[:, None], o, 1e30)
        hits, kernel_n, kernel_vis = closest_fn(o, d, shared=first)
        found = hits.hit & alive

        # --- miss shading ---
        if gpu:
            miss_rad = torch.broadcast_to(scene.miss_color, (r, 3))
        else:
            miss_rad = sky_gradient(unit(d))
        missed = alive & ~hits.hit
        radiance = radiance + torch.where(missed[:, None],
                                          throughput * miss_rad, 0.0)

        # --- hit frame + material ---
        if kernel_n is not None:
            # the shading normal came out of kernel E; p = o + t d (query.h:111)
            p = o + hits.t[:, None] * d
            n = kernel_n
        else:
            p, n, _ = make_hit_frame(o, d, hits, geom.vertices, geom.normals,
                                     mode=scene.dialect)
        # park the shade points of missed and dead rays too: their shadow
        # rays then cull at once
        p = torch.where(found[:, None], p, 1e30)
        obj = geom.obj_id[torch.clamp(hits.tri_idx.long(), min=0)]
        mat = mats.gather(obj)

        # --- direct light ---
        direct, state_direct = shade_direct(
            o, d, p, n, mat, scene.lights, occlude_fn, state,
            dialect=scene.dialect, vis_precomputed=kernel_vis)
        state = torch.where(found, state_direct, state)
        radiance = radiance + torch.where(found[:, None], throughput * direct,
                                          0.0)

        # --- Russian-roulette bounce split (query.h:188-206) ---
        kd, kr = mat.kd, mat.kr
        total = kd + kr
        can_bounce = found & (total > 0.0)
        n_unit = unit(n)
        state_xi, xi = rnglib.rng_next(state)
        state = torch.where(can_bounce, state_xi, state)
        if diffuse_bounce:
            take_diffuse = can_bounce & (
                xi < kd / torch.where(total > 0, total, 1.0))
        else:
            take_diffuse = torch.zeros_like(can_bounce)
        take_mirror = can_bounce & ~take_diffuse
        if not gpu:
            # CPUOnly mirrors only when kr > 0 (raytracer.h:249); the GPU
            # loop always takes the else-branch
            take_mirror = take_mirror & (kr > 0.0)

        if diffuse_bounce:
            # hemisphere samples draw only on the rays that take them
            hemi = n_unit.clone()
            sel = take_diffuse.nonzero().squeeze(1)
            if sel.numel():
                s_h, h_sel = rnglib.random_on_hemisphere(n_unit[sel],
                                                         state[sel])
                state = state.index_put((sel,), s_h)
                hemi = hemi.index_put((sel,), h_sel)
            ndotl = torch.clamp((n_unit * hemi).sum(dim=-1), min=0.0)
            if gpu:
                diff_tp = mat.albedo * (2.0 * ndotl)[:, None]
            else:
                diff_tp = mat.albedo * (total * 2.0 * ndotl)[:, None]
        else:
            hemi = n_unit
            diff_tp = torch.ones_like(mat.albedo)

        # mirror: GPU kr * tint (query.h:202-205); CPUOnly
        # (diffuse_bounce ? total : kr) * tint (raytracer.h:249-255)
        refl = reflect(unit(d), n_unit)
        mirror_scale = kr if (gpu or not diffuse_bounce) else total
        mirror_tp = mat.specular_color * mirror_scale[:, None]

        new_dir = torch.where(take_diffuse[:, None], hemi, refl)
        new_origin = p + n_unit * offset_eps
        tp_scale = torch.where(take_diffuse[:, None], diff_tp,
                               torch.where(take_mirror[:, None], mirror_tp,
                                           1.0))
        bounced = take_diffuse | take_mirror
        o = torch.where(bounced[:, None], new_origin, o)
        d = torch.where(bounced[:, None], new_dir, d)
        throughput = torch.where(bounced[:, None], throughput * tp_scale,
                                 throughput)
        # early-out: all channels < 1e-4 (query.h:209-212)
        tiny = (throughput < 1e-4).all(dim=-1)
        return o, d, throughput, radiance, state, bounced & ~tiny

    return bounce


def trace_rays(origins, dirs, rng_state, scene, model_axis=None,
               shared_origin0: bool = False) -> torch.Tensor:
    """Trace a wavefront of (R, 3) rays to completion -> radiance (R, 3).

    The loop runs while any ray is alive, up to ``scene.max_bounces``
    (one host read of the alive flags per depth).  ``shared_origin0``:
    every ray starts at ``origins[0]`` (the pinhole camera pass); the
    camera bounce is then peeled off with that flag, which kernel E
    accepts and does not need.  gpu dialect: the radiance is clamped to
    [0, 1] (``query.h:219``); cpuonly: not clamped.  ``rng_state``:
    uint32 values (any integer tensor, ``core.rng.to_u32``)."""
    _check_forward(scene, model_axis, None)
    bounce = make_bounce_step(scene)
    r = origins.shape[0]
    dev = origins.device
    carry = (origins, dirs, torch.ones(r, 3, device=dev),
             torch.zeros(r, 3, device=dev), rnglib.to_u32(rng_state),
             torch.ones(r, dtype=torch.bool, device=dev))
    max_depth = int(scene.max_bounces)
    depth = 0
    if shared_origin0 and max_depth >= 1 and scene.accel is not None:
        carry = bounce(carry, first=True)
        depth = 1
    while depth < max_depth and bool(carry[5].any()):
        carry = bounce(carry)
        depth += 1
    radiance = carry[3]
    if scene.dialect == "gpu":
        radiance = torch.clamp(radiance, 0.0, 1.0)  # clamp(radiance), query.h:219
    return radiance
