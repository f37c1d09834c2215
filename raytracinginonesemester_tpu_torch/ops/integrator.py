"""Staged path integrator: a wavefront loop over depth with throughput and
radiance carried per ray.

PyTorch port of ``raytracinginonesemester_tpu.ops.integrator``: the
iterative tracer of ``TraceRayIterative``
(``GPUandCPU/include/query.h:156-220``), the same semantics as CPUOnly's
recursive ``TraceRay`` (``CPUOnly/include/raytracer.h:215-260``).  Per
bounce: closest hit (kernel E, ``ops.block_kernels.block_closest``) ->
miss shading -> hit frame -> direct light with shadows (fused into E in
the gpu dialect, kernel F per shadow sample in cpuonly) ->
Russian-roulette diffuse/mirror split -> throughput update -> early-out.
A grid over the plane budget (``block_kernels.fits_vmem``, the JAX
package's rule) takes the streamed kernels G and I instead (H with
``RT_STREAM_BLOCKMAJOR=1``), in every mode.  This is the path for scenes
the fused kernels (``ops.megakernel``) do not take: ``reference_cpu``
jitter, gpu ``center`` jitter, cpuonly scenes with more than 16 shadow
samples, scenes over the plane budget, scenes without a block grid (brute
force, ``ops.intersect``) and differentiable scenes.

Differentiable scenes (``Scene.differentiable``) run a fixed number of
bounces, with no host read of the alive flags, in one of three modes:

- oracle (the default for a block grid, the gpu dialect, 1-24 lights and
  at most 8 bounces; ``RT_DIFF_ORACLE=0`` turns it off): one kernel-B
  launch per depth (``ops.diff_oracle``) supplies the winners, the
  visibility bits and the branch decisions, which the chain adopts;
- detached (other scenes with a block grid, among them those over the
  plane budget): kernel E without normals or fused shadows, and F per
  light (G and I over the budget), on detached inputs;
- brute (no grid): the brute-force intersector, differentiated through.

In the first two, the winner's triangle and normals come from
``ops.diff_gather.gather_rows`` (kernel J in the backward pass), and a
per-ray Moller-Trumbore on them carries the gradients while the primal t,
u, v pass through bit for bit (``a + (b - b.detach())``).

The glue between the kernels is plain PyTorch on the rays' device; the
rng is the reference's per-ray uint32 stream in int64 storage
(``core.rng``), drawn lane by lane only where a branch is taken.
"""

from __future__ import annotations

import dataclasses
import os

import torch

from ..core import rng as rnglib
from ..core.vecmath import reflect, unit
from .block_kernels import (block_closest, block_closest_blockmajor,
                            block_closest_streamed, block_occluded,
                            block_occluded_blockmajor,
                            block_occluded_streamed, grid_rows,
                            num_chunks_for)
from .diff_gather import gather_int_rows, gather_rows
from .intersect import (FLT_EPSILON, HitData, intersect_closest,
                        make_hit_frame, mt_single, occluded)
from .shading import RT_EPS_CPUONLY, RT_EPS_GPU, shade_direct, sky_gradient

__all__ = ["diff_candidate_plan", "make_bounce_step", "trace_rays"]

# Fused detached oracle for differentiable scenes: "0" keeps kernels E and
# F.  Read once at import, as the JAX package does, like the two below.
_DIFF_ORACLE = os.environ.get("RT_DIFF_ORACLE", "1") == "1"
# A scene over the plane budget: "0" takes kernels E and F instead of the
# streamed G and I (the JAX package's launch-per-chunk E/F relaunches
# compute the same function; the card runs it in one launch).
_STREAM_ENV = os.environ.get("RT_STREAM", "1") == "1"
# "1": kernel H (block-major sweep) instead of G and I for such a scene.
_STREAM_BLOCKMAJOR = os.environ.get("RT_STREAM_BLOCKMAJOR", "0") == "1"
# the JAX unroll gate: the oracle serves scenes of at most this many
# bounces, so that both packages send the same scenes the same way
_ORACLE_MAX_BOUNCES = 8

# Binned camera plan for the oracle's depth-0 bounce, set by
# ``diff_candidate_plan`` around a render (a context, so the render
# chain's signatures stay those of the JAX package).
_DIFF_CAND = [None]


class diff_candidate_plan:
    """Context manager: the oracle's depth-0 bounce walks the binned
    candidates of ``plan`` (``ops.binned.CandidatePlan``, built with a
    slack that covers the vertices' motion).  Only the candidate set and
    the camera are kept; the plane stream is regathered from the current
    grid on every trace (``binned.refresh_stream``).  The plan engages
    only for a ray stream of its tile count under its camera; any other
    render inside the context takes the flat walk."""

    def __init__(self, plan):
        from .binned import plan_candidate_gids

        self.plan = plan
        self.gids = plan_candidate_gids(plan)

    def __enter__(self):
        _DIFF_CAND.append(self)
        return self

    def __exit__(self, *exc):
        _DIFF_CAND.pop()
        return False


def _diff_cand(scene, num_rays: int):
    """The active context's plan, with its stream refreshed against the
    scene's grid, if it was built for this ray stream and camera."""
    from .binned import plan_matches_camera, refresh_stream
    from .megakernel import RAY_TILE

    ctx = _DIFF_CAND[-1]
    if ctx is None:
        return None
    nt = -(-num_rays // (8 * RAY_TILE)) * 8
    if (int(ctx.plan.meta.shape[0]) != nt
            or not plan_matches_camera(ctx.plan, scene.camera)):
        return None
    with torch.no_grad():
        stream = refresh_stream(ctx.gids, scene.accel)
    return dataclasses.replace(ctx.plan, stream=stream)


def _check(scene, model_axis, oracle) -> None:
    if model_axis is not None:
        raise NotImplementedError(
            "model_axis (triangle sharding) comes with the sharding slice")
    if oracle is not None and not (
            getattr(scene, "differentiable", False)
            and scene.accel is not None and scene.dialect == "gpu"):
        raise ValueError("an oracle serves differentiable gpu scenes with a "
                         "block grid only")


def _passthrough(a, b):
    """The value of ``a`` (detached), the gradient of ``b``."""
    return a + (b - b.detach())


def make_bounce_step(scene, model_axis=None, oracle=None):
    """The integrator's single-bounce step for a scene:
    ``bounce(carry, first=False, k=0) -> carry`` over the wavefront carry
    ``(origins, dirs, throughput, radiance, rng_state, alive)``, the loop
    body of ``TraceRayIterative`` (``query.h:165-216``) with the scene's
    dialect rules.  ``model_axis`` raises ``NotImplementedError``.

    Forward scenes with a block grid run kernel E (in the gpu dialect with
    the shading normal and the point lights' shadow visibility) and
    cpuonly shadow rays kernel F; a grid over the plane budget
    (``block_kernels.num_chunks_for`` > 1) runs the streamed kernels G and
    I (H with ``RT_STREAM_BLOCKMAJOR=1``; E with normals and F with
    ``RT_STREAM=0``) and the hit frame's gathers, in both dialects;
    without a grid, the brute-force scans of ``ops.intersect``.  ``first``
    marks the pinhole camera pass, whose rays share one origin.
    ``oracle``: the per-depth rows of
    ``ops.diff_oracle.fused_bounce_oracle``, read at depth ``k``;
    otherwise a differentiable scene with a grid takes the detached
    mode (module docstring)."""
    _check(scene, model_axis, oracle)
    gpu = scene.dialect == "gpu"
    det_eps = 1e-8 if gpu else FLT_EPSILON
    offset_eps = RT_EPS_GPU if gpu else RT_EPS_CPUONLY
    tmin = 1e-4  # kRayTMin (query.h:230) == CPUOnly RT_EPS
    diffuse_bounce = bool(scene.diffuse_bounce)
    differentiable = bool(getattr(scene, "differentiable", False))
    geom = scene.geometry
    mats = scene.materials
    winners = differentiable and scene.accel is not None

    if scene.accel is not None:
        rows = grid_rows(scene.accel)
        # over the plane budget, the streamed kernels (the JAX package's
        # rule, integrator.py:182-194 there)
        grid_chunks = num_chunks_for(scene.accel)
        streamed = grid_chunks > 1 and _STREAM_ENV
        # the streamed kernels return no normal, and the detached mode
        # recomputes the hit frame differentiably: then E returns neither
        # the normal nor the fused shadows; shadows fuse only under the
        # budget (RT_STREAM=0 over it: E with normals, then F)
        fused = gpu and not differentiable and not streamed
        lights = (scene.lights.position if fused and grid_chunks == 1
                  else None)

        def closest_fn(o, d, shared=False):
            if streamed:
                fn = (block_closest_blockmajor if _STREAM_BLOCKMAJOR
                      else block_closest_streamed)
                return fn(o, d, scene.accel, tmin, det_eps=det_eps,
                          rows=rows), None, None
            out = block_closest(o, d, scene.accel, tmin, det_eps=det_eps,
                                return_normal=fused, shadow_lights=lights,
                                shadow_eps=RT_EPS_GPU, shadow_tmin=1e-4,
                                shared_origin=shared, rows=rows)
            out = out if isinstance(out, tuple) else (out,)
            return out + (None,) * (3 - len(out))  # (hits, normal, vis)

        def occlude_fn(o, d, s_tmin, s_tmax):
            def det(x):
                return x.detach() if torch.is_tensor(x) else x

            fn = block_occluded
            if streamed:
                fn = (block_occluded_blockmajor if _STREAM_BLOCKMAJOR
                      else block_occluded_streamed)
            return fn(det(o), det(d), scene.accel, det(s_tmin), det(s_tmax),
                      det_eps=det_eps, rows=rows)
    else:
        def closest_fn(o, d, shared=False):
            return (intersect_closest(o, d, geom.vertices, tmin,
                                      det_eps=det_eps), None, None)

        def occlude_fn(o, d, s_tmin, s_tmax):
            return occluded(o, d, geom.vertices, s_tmin, s_tmax,
                            det_eps=det_eps)

    def winner_closest(o, d, k, shared):
        """Detached or oracle winners, their gathered triangle and normals
        (R, 3, 3) each, and a Moller-Trumbore recompute that carries the
        gradients -> (hits, (tri, tn), visibility or None, dec or None)."""
        if oracle is not None:
            idx_raw = oracle["idx"][k]
            hits = HitData(t=oracle["t"][k], u=oracle["u"][k],
                           v=oracle["v"][k], tri_idx=idx_raw,
                           hit=idx_raw >= 0)
            bits = oracle["vis"][k]
            vis = torch.stack([((bits >> li) & 1).to(torch.float32)
                               for li in range(scene.lights.num_lights)],
                              dim=1)
            dec = oracle["dec"][k]
        else:
            hits = closest_fn(o.detach(), d.detach(), shared)[0]
            vis = dec = None
        idx = torch.clamp(hits.tri_idx, min=0)
        tri = gather_rows(geom.vertices, idx)
        tn = gather_rows(geom.normals, idx)
        t2, u2, v2 = mt_single(o, d, tri, det_eps)
        hits = HitData(t=_passthrough(hits.t, t2), u=_passthrough(hits.u, u2),
                       v=_passthrough(hits.v, v2), tri_idx=hits.tri_idx,
                       hit=hits.hit)
        return hits, (tri, tn), vis, dec

    def bounce(carry, first=False, k=0):
        o, d, throughput, radiance, state, alive = carry
        r = o.shape[0]
        # park dead rays where every slab test misses
        o = torch.where(alive[:, None], o, 1e30)
        tri_tn = dec = None
        if winners:
            hits, tri_tn, kernel_vis, dec = winner_closest(o, d, k, first)
            kernel_n = None
        else:
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
            p, n, _ = make_hit_frame(
                o, d, hits, geom.vertices, geom.normals, mode=scene.dialect,
                tri=None if tri_tn is None else tri_tn[0],
                tn=None if tri_tn is None else tri_tn[1])
        # park the shade points of missed and dead rays too: their shadow
        # rays then cull at once
        p = torch.where(found[:, None], p, 1e30)
        obj = gather_int_rows(geom.obj_id, torch.clamp(hits.tri_idx, min=0))
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
        if dec is not None:
            # the oracle's decisions are authoritative: the chain cannot
            # take another branch than the kernel whose rows it reads next
            take_diffuse = (dec & 2) > 0
            take_mirror = (dec & 4) > 0
        else:
            if diffuse_bounce:
                take_diffuse = can_bounce & (
                    xi < kd / torch.where(total > 0, total, 1.0))
            else:
                take_diffuse = torch.zeros_like(can_bounce)
            take_mirror = can_bounce & ~take_diffuse
            if not gpu:
                # CPUOnly mirrors only when kr > 0 (raytracer.h:249); the
                # GPU loop always takes the else-branch
                take_mirror = take_mirror & (kr > 0.0)

        if diffuse_bounce:
            # hemisphere samples draw only on the rays that take them; the
            # sampled directions are constants to the gradient (detached
            # sampling), as in the JAX package
            n_det = n_unit.detach()
            hemi = n_det.clone()
            sel = take_diffuse.nonzero().squeeze(1)
            if sel.numel():
                s_h, h_sel = rnglib.random_on_hemisphere(n_det[sel],
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
        if dec is not None:
            alive = (dec & 8) > 0  # the kernel's own bounced & ~tiny
        else:
            # early-out: all channels < 1e-4 (query.h:209-212)
            alive = bounced & ~(throughput < 1e-4).all(dim=-1)
        return o, d, throughput, radiance, state, alive

    return bounce


def trace_rays(origins, dirs, rng_state, scene, model_axis=None,
               shared_origin0: bool = False) -> torch.Tensor:
    """Trace a wavefront of (R, 3) rays to completion -> radiance (R, 3).

    A forward scene's loop runs while any ray is alive, up to
    ``scene.max_bounces`` (one host read of the alive flags per depth); a
    differentiable scene's runs ``max_bounces`` bounces, reading nothing
    back, and takes the oracle when it is eligible (module docstring; its
    depth 0 walks the binned plan of an active ``diff_candidate_plan``
    built for this stream and camera).  ``shared_origin0``: every ray
    starts at ``origins[0]`` (the pinhole camera pass), which kernel E
    accepts and does not need.  gpu dialect: the radiance is clamped to
    [0, 1] (``query.h:219``); cpuonly: not clamped.  ``rng_state``:
    uint32 values (any integer tensor, ``core.rng.to_u32``)."""
    _check(scene, model_axis, None)
    differentiable = bool(getattr(scene, "differentiable", False))
    max_depth = int(scene.max_bounces)
    oracle = None
    if differentiable and _DIFF_ORACLE and max_depth <= _ORACLE_MAX_BOUNCES:
        from .diff_oracle import fused_bounce_oracle, oracle_eligible

        if oracle_eligible(scene):
            oracle = fused_bounce_oracle(
                origins, dirs, rng_state, scene, max_depth, det_eps=1e-8,
                tmin=1e-4, shadow_eps=RT_EPS_GPU, shadow_tmin=1e-4,
                cand_plan=_diff_cand(scene, int(origins.shape[0])))
    bounce = make_bounce_step(scene, oracle=oracle)
    r = origins.shape[0]
    dev = origins.device
    carry = (origins, dirs, torch.ones(r, 3, device=dev),
             torch.zeros(r, 3, device=dev), rnglib.to_u32(rng_state),
             torch.ones(r, dtype=torch.bool, device=dev))
    shared = shared_origin0 and scene.accel is not None
    if differentiable:
        for k in range(max_depth):
            carry = bounce(carry, first=shared and k == 0, k=k)
    else:
        depth = 0
        if shared and max_depth >= 1:
            carry = bounce(carry, first=True)
            depth = 1
        while depth < max_depth and bool(carry[5].any()):
            carry = bounce(carry)
            depth += 1
    radiance = carry[3]
    if scene.dialect == "gpu":
        radiance = torch.clamp(radiance, 0.0, 1.0)  # clamp(radiance), query.h:219
    return radiance
