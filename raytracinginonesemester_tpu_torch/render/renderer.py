"""Top-level render drivers.

PyTorch port of ``raytracinginonesemester_tpu.render.renderer``'s
dispatch, and the one place in the port where a render call's route is
decided (``resolve_route``) and its pixel stream built
(``pixel_stream``).  Scenes the fused kernels take render on the staged
wavefront (``ops.wavefront``) or the monolithic render kernel
(``ops.megakernel.render_tiles``), both with the binned camera plan;
every other scene renders through the staged integrator
(``accumulate_samples`` -> ``ops.integrator.trace_rays``: kernels E and
F, or G and I for a scene over the plane budget), with a one-time
warning that names the reason.  The plane budget is the JAX package's
dispatch rule, a limit of the TPU's VMEM: the fused kernels take a grid
over it, so a scene over it renders on the staged integrator only for
another reason (``reference_cpu`` jitter, a differentiable scene).
Differentiable scenes render there too, without a warning (the fused
kernels have no gradient): through kernel B's oracle rows and kernel J
in the backward pass (``ops.integrator``).  ``render_hw1`` is the HW1
brute-force pipeline, in plain PyTorch on the triangles' device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import rng as rnglib
from ..ops.megakernel import (
    megakernel_ineligible_reason, megakernel_kwargs, padded_rays)
from ..scene.build import Scene
from ..utils.timing import span

__all__ = ["render_scene", "render_scene_frames", "render_hw1", "Route",
           "resolve_route", "resolve_wavefront", "route_counts",
           "reset_route_counts", "plan_counts", "reset_plan_counts",
           "resolve_candidate_plan",
           "resolve_jitter_mode", "pixel_stream", "unswizzle",
           "render_stream", "accumulate_samples", "DEFAULT_RAY_TILE",
           "frog_scene", "entry"]

# rays per ``trace_rays`` call of the staged integrator; <= 0 is one
# batch of the whole frame.  Images do not depend on it (per-ray math,
# seeds by absolute pixel and sample); the JAX package's 16384 bounds its
# compiled program's memory, which eager PyTorch on an 80 GB card need
# not do.
DEFAULT_RAY_TILE = 0


def _swizzled_grid(width: int, height: int, tile: int = 16, device="cpu"):
    """Pixel indices in tile-major (16x16) order over a tile-padded frame
    -> (xs, ys, (hp, wp)), int32 and contiguous on ``device``.  Seeds
    derive from absolute (x, y), so any pixel order gives the same image.
    Built on ``device`` from two ``arange``s broadcast over the
    (tile row, tile column, row, column) layout: no pixel data crosses
    from the host."""
    wp = -(-width // tile) * tile
    hp = -(-height // tile) * tile
    shape = (hp // tile, wp // tile, tile, tile)
    xs = torch.arange(wp, dtype=torch.int32, device=device)
    ys = torch.arange(hp, dtype=torch.int32, device=device)
    return (xs.view(1, wp // tile, 1, tile).expand(shape).reshape(-1),
            ys.view(hp // tile, 1, tile, 1).expand(shape).reshape(-1),
            (hp, wp))


def pixel_stream(width: int, height: int, device="cpu", ranks: int = 1):
    """The pixel stream of a frame -> (xs, ys, n, (hp, wp)): the 16x16
    tile-major pixels of the tile-padded (hp, wp) frame, ``n = hp * wp``
    of them, then padding rays at pixel (0, 0) up to whole 8-tile groups
    of ``RAY_TILE`` rays for each of ``ranks`` data ranks
    (``megakernel.padded_rays``), which ``parallel.sharded`` deals out in
    groups.  The fused kernels take the whole stream; the staged
    integrator traces its first ``n`` rays; ``unswizzle`` is the
    inverse."""
    with span("rt.dispatch.grid"):
        xs, ys, (hp, wp) = _swizzled_grid(width, height, device=device)
        n = hp * wp
        pad = padded_rays(n, ranks) - n
        if pad:
            xs, ys = F.pad(xs, (0, pad)), F.pad(ys, (0, pad))
        return xs, ys, n, (hp, wp)


def unswizzle(accum: torch.Tensor, width: int, height: int, hp: int, wp: int,
              tile: int = 16) -> torch.Tensor:
    """(..., >= hp*wp, C) in stream order -> (..., height, width, C)
    scanline; rows past the frame's ``hp * wp`` (padding) are dropped."""
    lead = accum.shape[:-2]
    c = accum.shape[-1]
    with span("rt.dispatch.unswizzle"):
        img = (accum[..., :hp * wp, :]
               .reshape(*lead, hp // tile, wp // tile, tile, tile, c)
               .transpose(-4, -3)
               .reshape(*lead, hp, wp, c))
        return img[..., :height, :width, :]


def resolve_jitter_mode(scene: Scene, jitter_mode: str, spp: int) -> str:
    if jitter_mode != "auto":
        return jitter_mode
    return "wang" if (scene.dialect == "gpu" or spp > 1) else "center"


def _bouncing(scene: Scene) -> bool:
    return bool(scene.diffuse_bounce) or not scene.terminal_only


def _kernel_kwargs(scene: Scene, jitter_mode: str) -> dict:
    kw = megakernel_kwargs(scene, jitter_mode)
    kw.setdefault("jitter", jitter_mode)
    return kw


# calls of resolve_route by route since the last reset (``Route.name``)
_ROUTES: dict = {}


def route_counts() -> dict:
    """Render calls by route since the last reset (``_ROUTES``)."""
    return dict(_ROUTES)


def reset_route_counts() -> None:
    _ROUTES.clear()


def _calibrate(scene: Scene, jm: str, stream, mesh=None) -> Optional[int]:
    """The staged wavefront's capacity for a scene the fused kernels
    take, None where staging cannot help (the scene never bounces, or its
    alive wavefront is about the whole frame): ``auto_capacity_tiles`` on
    the frame's stream.  Under ``mesh`` data rank 0 alone calibrates, the
    result is broadcast, and each rank takes ``rank_capacity`` of it."""
    if not _bouncing(scene):
        return None
    from ..ops.wavefront import auto_capacity_tiles, rank_capacity

    xs, ys, n, _ = stream
    m = padded_rays(n)  # the frame's own groups, whatever the ranks

    def calibrated():
        with span("rt.dispatch.calibrate"):
            return auto_capacity_tiles(scene, xs[:m], ys[:m],
                                       **_kernel_kwargs(scene, jm))

    if mesh is None:
        return calibrated()
    from ..ops import comm

    cap = calibrated() if mesh.index("data") == 0 else None
    cap = int(comm.broadcast(torch.tensor(
        [-1 if cap is None else cap], dtype=torch.int64,
        device=scene.device), mesh.group("data")))
    return None if cap < 0 else rank_capacity(cap, mesh.size("data"))


def resolve_wavefront(scene: Scene, jitter_mode: str = "auto",
                      spp_override: Optional[int] = None):
    """(wavefront, capacity) of a render call without a forced capacity,
    as the JAX package resolves it at its defaults: the staged wavefront
    where the fused kernels take the scene, it bounces and a capacity is
    calibrated (``_calibrate``), else (False, None)."""
    spp_eff = spp_override if spp_override is not None else scene.spp
    jm = resolve_jitter_mode(scene, jitter_mode, spp_eff)
    if megakernel_ineligible_reason(scene, jm) is not None:
        return False, None
    cap = _calibrate(scene, jm, pixel_stream(
        int(scene.camera.width), int(scene.camera.height), scene.device))
    return cap is not None, cap


# (scene, camera) fingerprint -> binned camera plan (ops.binned).  The
# plan decides which triangles a tile tests, so the key holds the camera
# frame's and the triangle planes' tensors by identity and in-place
# version (ops.binned.plan_fingerprint: exact, and no device copy).
# Bounded: each plan pins a device stream, so a camera animation evicts
# the oldest entries beyond the cap.
_CAND_PLAN_CACHE: dict = {}
_CAND_PLAN_CACHE_MAX = 8

# the binned plans built since the last reset, and their size as
# ``binned.candidate_plan_stats`` reads it once a build: the chunks and the
# padded depth-0 (ray, candidate) pairs that a frame's emit walks
_PLANS = {"plans": 0, "chunks": 0, "padded_pairs": 0}


def plan_counts() -> dict:
    """Binned plans built since the last reset (``_PLANS``): ``plans``,
    and the ``chunks`` and ``padded_pairs`` they hold in all."""
    return dict(_PLANS)


def reset_plan_counts() -> None:
    _PLANS.update(plans=0, chunks=0, padded_pairs=0)


def resolve_candidate_plan(scene: Scene, jitter_mode: str = "auto",
                           spp_override: Optional[int] = None,
                           align_tiles: int = 1):
    """Binned camera-candidate plan of a scene (``ops.binned``, chunks of
    ``binned.CHUNK`` lanes), built on its device once per (scene, camera),
    ordered front to back (``order_front_to_back``) and cached; None for a
    scene the fused kernels do not take.  The depth-0 walk of emit and
    render then tests each tile's candidates instead of the block grid,
    and stops a warp at the first chunk behind all of its rays' hits.
    ``align_tiles``: the data ranks of the ``pixel_stream`` the plan is
    built for, so that its meta rows deal out with the stream
    (``parallel.sharded``; the chunk stream, whose starts are global, is
    shared)."""
    from ..ops.binned import (CHUNK, build_camera_candidate_plan,
                              candidate_plan_stats, order_front_to_back,
                              plan_fingerprint)
    from ..ops.megakernel import RAY_TILE

    spp_eff = spp_override if spp_override is not None else scene.spp
    jm = resolve_jitter_mode(scene, jitter_mode, spp_eff)
    if megakernel_ineligible_reason(scene, jm) is not None:
        return None
    fp = (plan_fingerprint(scene.camera, scene.accel, RAY_TILE, 1, CHUNK),
          int(align_tiles))
    if fp in _CAND_PLAN_CACHE:
        plan = _CAND_PLAN_CACHE.pop(fp)
        _CAND_PLAN_CACHE[fp] = plan  # LRU: refresh the insertion order
        return plan
    xs, ys, _, _ = pixel_stream(int(scene.camera.width),
                                int(scene.camera.height), scene.device,
                                align_tiles)
    with span("rt.dispatch.plan"):
        plan = order_front_to_back(
            build_camera_candidate_plan(scene.camera, xs, ys, scene.accel,
                                        RAY_TILE, chunk=CHUNK), scene.camera)
        stats = candidate_plan_stats(plan, RAY_TILE)
    _PLANS["plans"] += 1
    _PLANS["chunks"] += stats["chunks"]
    _PLANS["padded_pairs"] += stats["padded_pairs"]
    while len(_CAND_PLAN_CACHE) >= _CAND_PLAN_CACHE_MAX:
        _CAND_PLAN_CACHE.pop(next(iter(_CAND_PLAN_CACHE)))
    _CAND_PLAN_CACHE[fp] = plan
    return plan


@dataclasses.dataclass(frozen=True)
class Route:
    """How one render call runs (``resolve_route``).  ``name``:
    "wavefront" (the staged wavefront, kernels A and B, C on overflow),
    "render" (the monolithic kernel D) or "staged: <reason>" (the staged
    integrator, with the fused kernels' reason for refusing the scene);
    ``jitter``: the resolved jitter mode; ``capacity``: the wavefront's
    alive-tile capacity (a data rank's, under a mesh); ``cand_plan``:
    the stream's binned plan; ``kwargs``: the kernel wrappers' dialect
    keyword arguments."""

    name: str
    jitter: str
    capacity: Optional[int] = None
    cand_plan: object = None
    kwargs: dict = dataclasses.field(default_factory=dict)

    @property
    def staged(self) -> bool:
        return self.name.startswith("staged")


def resolve_route(scene: Scene, stream, jitter_mode: str = "auto",
                  spp: int = 1, cand_plan=None,
                  capacity_tiles: Optional[int] = None, mesh=None) -> Route:
    """The route of one render call of ``scene`` over ``stream``
    (``pixel_stream``), counted under its name (``route_counts``).

    Where the fused kernels take the scene
    (``megakernel_ineligible_reason``): the staged wavefront when the
    scene bounces and has a capacity, else kernel D; both walk the binned
    plan (``cand_plan``, or the cached one).  The capacity is
    ``capacity_tiles``, the one way to force it, or else calibrated
    (``_calibrate``).  Every other scene takes the staged integrator, with
    one warning per reason, none for a differentiable scene, which has no
    faster route.  ``mesh``: ``parallel.sharded``'s mesh, over whose data
    ranks the stream is dealt: the capacity is a rank's share and the
    plan is built for that many ranks."""
    jm = resolve_jitter_mode(scene, jitter_mode, spp)
    with span("rt.dispatch.resolve"):
        reason = megakernel_ineligible_reason(scene, jm)
        if reason is not None:
            if not reason.startswith("differentiable"):
                from ..utils.logging import warn_once

                warn_once(f"mk-fallback:{reason}",
                          f"scene falls off the fused kernels ({reason}); "
                          "rendering via the staged integrator")
            route = Route(f"staged: {reason}", jm)
        else:
            cap = capacity_tiles
            if cap is None:
                cap = _calibrate(scene, jm, stream, mesh)
            if cand_plan is None:
                cand_plan = resolve_candidate_plan(
                    scene, jm, spp, 1 if mesh is None else mesh.size("data"))
            wavefront = _bouncing(scene) and cap is not None
            route = Route("wavefront" if wavefront else "render", jm,
                          None if cap is None else int(cap), cand_plan,
                          _kernel_kwargs(scene, jm))
        _ROUTES[route.name] = _ROUTES.get(route.name, 0) + 1
        return route


def _tile_map(fn, args, num_rays: int, tile: int):
    """``fn`` over consecutive ray tiles of ``args`` (tensors with leading
    dim ``num_rays``), the tail tile padded with copies of ray 0;
    ``tile <= 0`` is one whole-batch tile.  Results keep ``num_rays``."""
    if tile <= 0 or tile >= num_rays:
        return fn(args)
    padded = -(-num_rays // tile) * tile
    if padded != num_rays:
        args = tuple(torch.cat([a, a[:1].expand(padded - num_rays,
                                                *a.shape[1:])])
                     for a in args)
    outs = [fn(tuple(a[i:i + tile] for a in args))
            for i in range(0, padded, tile)]
    return torch.cat(outs)[:num_rays]


def accumulate_samples(scene: Scene, xs, ys, spp: int, jitter_mode: str,
                       ray_tile: int = DEFAULT_RAY_TILE,
                       sample_offset: int = 0, trace=None) -> torch.Tensor:
    """Sum over ``spp`` samples of the per-sample radiance of the pixels
    ``xs``, ``ys`` through the staged integrator -> (N, 3).

    Sample ``s`` seeds its rays ``make_rng_seed(x, y, s + sample_offset)``
    (``query.h:44-48``) and jitters them by ``jitter_mode``: ``"wang"``
    (``query.cu:36-43``); ``"reference_cpu"``, one host-side mt19937(42)
    offset per sample shared by every pixel (``query.cu:137-146``),
    indexed ``min(s + sample_offset, spp - 1)`` as the JAX package does;
    ``"center"``, the pixel center.  Any split of the pixels, and any
    ``ray_tile``, gives the same sums.  ``trace(origins, dirs, seeds) ->
    (N, 3)`` traces one tile of ``ray_tile`` of one sample's rays, by
    default ``trace_rays`` (``parallel.sharded`` passes its own)."""
    cam = scene.camera
    num_rays = int(xs.shape[0])
    dev = xs.device
    if jitter_mode == "reference_cpu":
        offsets = torch.as_tensor(rnglib.jittered_samples(spp, 42, True),
                                  device=dev)
    elif jitter_mode not in ("wang", "center"):
        raise ValueError(f"unknown jitter_mode {jitter_mode!r}")
    if trace is None:
        from ..ops.integrator import trace_rays

        def trace(o, d, st):
            return trace_rays(o, d, st, scene, shared_origin0=cam.is_pinhole)

    accum = torch.zeros(num_rays, 3, device=dev)
    for s in range(int(spp)):
        s_abs = s + int(sample_offset)
        if jitter_mode == "wang":
            jx, jy = rnglib.pixel_jitter(xs, ys, s_abs)
        elif jitter_mode == "reference_cpu":
            jx, jy = offsets[min(s_abs, spp - 1)]
        else:
            jx = jy = 0.5
        origins, dirs = cam.get_rays(xs.to(torch.float32) + jx,
                                     ys.to(torch.float32) + jy)
        seeds = rnglib.make_rng_seed(xs, ys, s_abs)
        accum = accum + _tile_map(lambda a: trace(*a), (origins, dirs, seeds),
                                  num_rays, ray_tile)
    return accum


def render_stream(scene: Scene, route: Route, xs, ys, spp: int,
                  sample_offset: int = 0,
                  ray_tile: int = DEFAULT_RAY_TILE) -> torch.Tensor:
    """Per-ray radiance SUM over ``spp`` samples of the pixels ``xs``,
    ``ys``, (N, 3) in their order, on ``route``: the staged wavefront,
    the monolithic render kernel or the staged integrator (which takes
    the frame's own pixels, ``_route_rays``)."""
    with span("rt.glue.frame"):
        if route.staged:
            return accumulate_samples(scene, xs, ys, spp, route.jitter,
                                      ray_tile, sample_offset)
        if route.name == "wavefront":
            from ..ops.wavefront import render_tiles_wavefront

            return render_tiles_wavefront(
                scene, xs, ys, spp, sample_offset,
                capacity_tiles=route.capacity, cand_plan=route.cand_plan,
                **route.kwargs)
        from ..ops.megakernel import render_tiles

        return render_tiles(scene, xs, ys, spp, sample_offset,
                            cand_plan=route.cand_plan, **route.kwargs)


def _route_rays(stream, route: Route):
    """The stream's rays for ``route``: the fused kernels take whole
    groups, the staged integrator the frame's own ``n`` pixels."""
    xs, ys, n, _ = stream
    return (xs[:n], ys[:n]) if route.staged else (xs, ys)


def render_scene_frames(scene: Scene, frames: int, jitter_mode: str = "auto",
                        sample_offset: int = 0, cand_plan=None,
                        capacity_tiles: Optional[int] = None,
                        ray_tile: int = DEFAULT_RAY_TILE) -> torch.Tensor:
    """Render ``frames`` consecutive spp-1 frames -> (frames, H, W, 3);
    frame f uses sample index ``sample_offset + f``.  On the staged
    wavefront all frames share one merged compaction sort and bounce
    ladder; otherwise each frame is one render-kernel call or, for a
    scene the fused kernels do not take, one staged-integrator call
    (the same images as single-frame renders).  ``capacity_tiles``
    forces the wavefront at that capacity where the fused kernels take
    a bouncing scene; ``ray_tile`` as in ``accumulate_samples``."""
    with span("rt.dispatch.frames"):
        w, h = scene.camera.width, scene.camera.height
        stream = pixel_stream(w, h, scene.device)
        route = resolve_route(scene, stream, jitter_mode, 1, cand_plan,
                              capacity_tiles)
        xs, ys = _route_rays(stream, route)
        if route.name == "wavefront":
            from ..ops.wavefront import render_tiles_wavefront_frames

            accum = render_tiles_wavefront_frames(
                scene, xs, ys, frames, sample_offset,
                capacity_tiles=route.capacity, cand_plan=route.cand_plan,
                **route.kwargs)
        else:
            accum = torch.stack([
                render_stream(scene, route, xs, ys, 1,
                              int(sample_offset) + f, ray_tile)
                for f in range(int(frames))])
        return unswizzle(accum, w, h, *stream[3])


def render_scene(scene: Scene, jitter_mode: str = "auto",
                 spp_override: Optional[int] = None, sample_offset: int = 0,
                 normalize: bool = True, cand_plan=None,
                 capacity_tiles: Optional[int] = None,
                 ray_tile: int = DEFAULT_RAY_TILE) -> torch.Tensor:
    """Render a scene to a linear (H, W, 3) float32 image: the mean (or,
    with ``normalize=False``, the sum) over spp samples of the per-sample
    radiance, clipped per sample in the gpu dialect and accumulated in
    sample order per pixel.  ``jitter_mode``: "wang", "reference_cpu"
    (the oracle-parity mode), "center" or "auto" (gpu or spp > 1:
    "wang", else "center"); ``capacity_tiles`` as in
    ``render_scene_frames``; ``ray_tile`` as in ``accumulate_samples``."""
    spp = spp_override if spp_override is not None else scene.spp
    with span("rt.dispatch.scene"):
        w, h = scene.camera.width, scene.camera.height
        stream = pixel_stream(w, h, scene.device)
        route = resolve_route(scene, stream, jitter_mode, spp, cand_plan,
                              capacity_tiles)
        accum = render_stream(scene, route, *_route_rays(stream, route), spp,
                              sample_offset, ray_tile)
        img = unswizzle(accum, w, h, *stream[3])
        return img / float(spp) if normalize else img


def render_hw1(vertices, normals, camera, light_position, light_color,
               width: int, height: int, spp: int = 1, offsets=None,
               ray_tile: int = DEFAULT_RAY_TILE) -> torch.Tensor:
    """The HW1 pipeline (``HW1/src/render.cpp:72-116``): one brute-force
    closest hit per sample over all triangles, t >= 0 with the
    FLT_EPSILON det cutoff, the raw interpolated normal
    (``make_hit_frame(mode="hw1")``) and ``shade_hw1`` -> (H, W, 3) on the
    triangles' device.

    The reference's jitter quirk is kept: render.cpp builds ``i + offset``
    but HW1's camera has only an ``(int, int)`` ``get_pixel_position``
    (``HW1/include/camera.h:33-35``), so the offsets truncate away.
    ``offsets`` (spp, 2) in [0, 1), default the reference's mt19937(42)
    stream, are floored (all to 0)."""
    from ..ops import shading
    from ..ops.intersect import FLT_EPSILON, intersect_closest, make_hit_frame

    dev = vertices.device
    if offsets is None:
        offsets = rnglib.jittered_samples(spp, 42, centered=False)
    offsets = torch.floor(torch.as_tensor(offsets, dtype=torch.float32,
                                          device=dev))
    ys, xs = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1).to(torch.float32), ys.reshape(-1).to(torch.float32)
    num_rays = width * height

    def tile_fn(args):
        o, d = args
        hits = intersect_closest(o, d, vertices, tmin=0.0,
                                 det_eps=FLT_EPSILON)
        p, n, _ = make_hit_frame(o, d, hits, vertices, normals, mode="hw1")
        return shading.shade_hw1(o, d, p, n, hits.hit, light_position,
                                 light_color)

    accum = torch.zeros(num_rays, 3, device=dev)
    for s in range(int(spp)):
        o, d = camera.get_rays(xs + offsets[s, 0], ys + offsets[s, 1])
        accum = accum + _tile_map(tile_fn, (o, d), num_rays, ray_tile)
    return (accum / float(spp)).reshape(height, width, 3)

def frog_scene(width=256, height=144, spp=1, max_bounces=8,
               diffuse_bounce=True, device="cuda") -> Scene:
    """The reference's headline workload (``GPUandCPU/assets/json_files/
    frog.json``): frog mesh, one point light, 8 bounces, diffuse."""
    from ..scene.build import build_scene
    from ..scene.config import SceneConfig, SceneNodeConfig
    from ..scene.transform import Transform

    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    config = SceneConfig(
        max_bounces=max_bounces, spp=spp, diffuse_bounce=diffuse_bounce,
        camera_position=(0.0, -0.2, 0.2), camera_look_at=(0.0, 0.1, 0.0),
        camera_up=(0.0, 0.0, 1.0), focal_length_mm=45.0,
        sensor_height_mm=24.0, sensor_width_mm=None,
        pixel_width=width, pixel_height=height,
        background=("miss", (0.5, 0.7, 1.0)),
        lights=[dict(position=(-3.0, 0.0, 1.0), color=(1.0, 1.0, 0.0),
                     intensity=5.0, radius=0.0, shadow_samples=1)],
        nodes=[SceneNodeConfig(
            name="frog", type="mesh",
            path=os.path.join(repo, "tests/assets/meshes/frog.obj"),
            transform=Transform(),
            material=dict(albedo=(0.8, 0.2, 0.2), kd=1.0, ks=0.5,
                          specular_color=(0.04, 0.04, 0.04),
                          shininess=32.0, kr=0.0))],
        dialect="gpu")
    return build_scene(config, device=device)


def entry(device="cuda"):
    """(fn, example_args): one forward render of the frog scene, the
    counterpart of ``__graft_entry__.entry``, on ``device``; raises when
    the card is asked for and CUDA is missing."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry(): no CUDA device (pass device='cpu' to "
                           "run the plain versions)")
    scene = frog_scene(device=device)

    def forward(s):
        return render_scene(s, jitter_mode="wang")

    return forward, (scene,)
