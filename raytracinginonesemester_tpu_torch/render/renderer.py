"""Top-level render drivers.

PyTorch port of ``raytracinginonesemester_tpu.render.renderer``'s
dispatch: the swizzled 16x16 pixel-tile stream, the wavefront and
capacity resolve, the binned camera plan with its bounded cache, and
``render_scene`` / ``render_scene_frames``.  As in the JAX package,
scenes the fused kernels take render on the staged wavefront
(``ops.wavefront``) or the monolithic render kernel
(``ops.megakernel.render_tiles``); every other scene renders through the
staged integrator (``accumulate_samples`` -> ``ops.integrator.trace_rays``:
kernels E and F, or G and I for a scene over the plane budget), with a
one-time warning that names the reason.
Differentiable scenes render there too, without a warning (the fused
kernels have no gradient): through kernel B's oracle rows and kernel J
in the backward pass (``ops.integrator``).  ``render_hw1`` is the HW1
brute-force pipeline, in plain PyTorch on the triangles' device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..core import rng as rnglib
from ..ops.megakernel import megakernel_ineligible_reason, megakernel_kwargs
from ..scene.build import Scene
from ..utils.timing import span

__all__ = ["render_scene", "render_scene_frames", "render_hw1",
           "resolve_wavefront",
           "resolve_candidate_plan", "resolve_jitter_mode",
           "accumulate_samples", "DEFAULT_RAY_TILE", "frog_scene", "entry"]

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

    with span("rt.dispatch.grid"):
        xs = torch.arange(wp, dtype=torch.int32, device=device)
        ys = torch.arange(hp, dtype=torch.int32, device=device)
        return (xs.view(1, wp // tile, 1, tile).expand(shape).reshape(-1),
                ys.view(hp // tile, 1, tile, 1).expand(shape).reshape(-1),
                (hp, wp))


def _unswizzle(accum: torch.Tensor, width: int, height: int, hp: int, wp: int,
               tile: int = 16) -> torch.Tensor:
    """(..., hp*wp, C) tile-major -> (..., height, width, C) scanline."""
    lead = accum.shape[:-2]
    c = accum.shape[-1]
    with span("rt.dispatch.unswizzle"):
        img = (accum.reshape(*lead, hp // tile, wp // tile, tile, tile, c)
               .transpose(-4, -3)
               .reshape(*lead, hp, wp, c))
        return img[..., :height, :width, :]


def resolve_jitter_mode(scene: Scene, jitter_mode: str, spp: int) -> str:
    if jitter_mode != "auto":
        return jitter_mode
    return "wang" if (scene.dialect == "gpu" or spp > 1) else "center"


def _fused(scene: Scene, jitter_mode: str) -> bool:
    """Whether the fused kernels (A-D) take the scene, as the JAX
    package decides (``megakernel_eligible``)."""
    return megakernel_ineligible_reason(scene, jitter_mode) is None


def _warn_if_fallback(scene: Scene, jitter_mode: str, spp: int) -> None:
    """One warning per reason when a scene falls off the fused kernels
    onto the staged integrator, as the JAX package warns; none for a
    differentiable scene, which has no faster option."""
    from ..utils.logging import warn_once

    reason = megakernel_ineligible_reason(
        scene, resolve_jitter_mode(scene, jitter_mode, spp))
    if reason is not None and not reason.startswith("differentiable"):
        warn_once(f"mk-fallback:{reason}",
                  f"scene falls off the fused kernels ({reason}); rendering "
                  "via the staged integrator")


def _bouncing(scene: Scene) -> bool:
    return bool(scene.diffuse_bounce) or not scene.terminal_only


def _kernel_kwargs(scene: Scene, jitter_mode: str) -> dict:
    kw = megakernel_kwargs(scene, jitter_mode)
    kw.setdefault("jitter", jitter_mode)
    return kw


def resolve_wavefront(scene: Scene, jitter_mode: str = "auto",
                      spp_override: Optional[int] = None):
    """(wavefront, capacity) for a scene, as the JAX package resolves it.

    ``RT_WAVEFRONT``: "auto" (default) takes the staged wavefront when a
    capacity is calibrated, else the monolithic render kernel; "1"
    always takes the wavefront, "0" never.  ``RT_WAVEFRONT_CAP``: "auto"
    (calibrate, cached in memory and on disk) or a tile count.  Terminal
    scenes (no diffuse bounce, every kr == 0) and scenes the fused
    kernels do not take never take the wavefront."""
    spp_eff = spp_override if spp_override is not None else scene.spp
    jm = resolve_jitter_mode(scene, jitter_mode, spp_eff)
    wf_env = os.environ.get("RT_WAVEFRONT", "auto")
    wavefront = wf_env in ("1", "auto")
    cap = None
    cap_env = os.environ.get("RT_WAVEFRONT_CAP", "auto")
    if wavefront and cap_env:
        if not (_bouncing(scene) and _fused(scene, jm)):
            wavefront = False
        elif cap_env == "auto":
            from ..ops.wavefront import auto_capacity_tiles

            cap = auto_capacity_tiles(scene, **_kernel_kwargs(scene, jm))
        else:
            cap = int(cap_env)
    if wf_env == "auto" and cap is None:
        # no staged capacity (the scene never bounces, or its alive
        # wavefront is about the whole frame): the monolithic kernel
        wavefront = False
    return wavefront, cap


# (scene, camera) fingerprint -> binned camera plan (ops.binned).  The
# plan decides which triangles a tile tests, so the key holds the camera
# frame's and the triangle planes' tensors by identity and in-place
# version (ops.binned.plan_fingerprint: exact, and no device copy).
# Bounded: each plan pins a device stream, so a camera animation evicts
# the oldest entries beyond the cap.
_CAND_PLAN_CACHE: dict = {}
_CAND_PLAN_CACHE_MAX = 8


def resolve_candidate_plan(scene: Scene, jitter_mode: str = "auto",
                           spp_override: Optional[int] = None,
                           align_tiles: int = 1):
    """Binned camera-candidate plan of a scene, built on its device once
    per (scene, camera) and cached.  ``RT_BINNED``: "auto"/"1" (default
    on), "0" off (returns None); ``RT_BINNED_CHUNK``: candidate lanes
    per chunk (default 256).  The depth-0 walk of emit and render then
    tests each tile's candidates instead of the block grid.  None for a
    scene the fused kernels do not take.  ``align_tiles``: the plan's
    tiles are padded to a multiple of ``align_tiles`` 8-tile groups, with
    padding rays at pixel (0, 0), so that its meta rows split evenly over
    that many data ranks (``parallel.sharded``; the chunk stream, whose
    starts are global, is shared)."""
    if os.environ.get("RT_BINNED", "auto") == "0":
        return None
    spp_eff = spp_override if spp_override is not None else scene.spp
    if not _fused(scene, resolve_jitter_mode(scene, jitter_mode, spp_eff)):
        return None
    from ..ops.binned import build_camera_candidate_plan, plan_fingerprint
    from ..ops.megakernel import RAY_TILE, _pad_tiles

    chunk = int(os.environ.get("RT_BINNED_CHUNK", "256"))
    fp = (plan_fingerprint(scene.camera, scene.accel, RAY_TILE, 1, chunk),
          int(align_tiles))
    if fp in _CAND_PLAN_CACHE:
        plan = _CAND_PLAN_CACHE.pop(fp)
        _CAND_PLAN_CACHE[fp] = plan  # LRU: refresh the insertion order
        return plan
    w, h = int(scene.camera.width), int(scene.camera.height)
    xs, ys, _ = _swizzled_grid(w, h, device=scene.device)
    xs_p, ys_p, _, _ = _pad_tiles(xs, ys)
    extra = (-(xs_p.shape[0] // RAY_TILE)) % (int(align_tiles) * 8)
    if extra:
        xs_p = torch.cat([xs_p, xs_p.new_zeros(extra * RAY_TILE)])
        ys_p = torch.cat([ys_p, ys_p.new_zeros(extra * RAY_TILE)])
    plan = build_camera_candidate_plan(scene.camera, xs_p, ys_p, scene.accel,
                                       RAY_TILE, chunk=chunk)
    while len(_CAND_PLAN_CACHE) >= _CAND_PLAN_CACHE_MAX:
        _CAND_PLAN_CACHE.pop(next(iter(_CAND_PLAN_CACHE)))
    _CAND_PLAN_CACHE[fp] = plan
    return plan


def _tile_map(fn, args, num_rays: int, tile: int):
    """``fn`` over consecutive ray tiles of ``args`` (tensors with leading
    dim ``num_rays``), the tail tile padded with copies of ray 0;
    ``tile <= 0`` is one whole-batch tile.  Results keep ``num_rays``."""
    tile = num_rays if tile <= 0 else min(tile, num_rays)
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
    (N, 3)`` traces one sample's rays, by default ``trace_rays`` over
    tiles of ``ray_tile`` rays (``parallel.sharded`` passes its own)."""
    cam = scene.camera
    num_rays = int(xs.shape[0])
    dev = xs.device
    if jitter_mode == "reference_cpu":
        offsets = torch.as_tensor(rnglib.jittered_samples(spp, 42, True),
                                  device=dev)
    elif jitter_mode not in ("wang", "center"):
        raise ValueError(f"unknown jitter_mode {jitter_mode!r}")
    from ..ops.integrator import trace_rays

    def tile_fn(args):
        o, d, st = args
        return trace_rays(o, d, st, scene, shared_origin0=cam.is_pinhole)

    if trace is None:
        def trace(o, d, st):
            return _tile_map(tile_fn, (o, d, st), num_rays, ray_tile)

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
        accum = accum + trace(origins, dirs, seeds)
    return accum


def _frame_accum(scene: Scene, xs, ys, spp: int, sample_offset: int,
                 jitter_mode: str, wavefront: bool, cap, cand_plan,
                 ray_tile: int = DEFAULT_RAY_TILE):
    """Per-ray radiance SUM over ``spp`` samples, (N, 3) in swizzled
    order: for a scene the fused kernels take, the staged wavefront for
    bouncing scenes when it is taken, else the monolithic render kernel;
    for any other scene the staged integrator."""
    jm = resolve_jitter_mode(scene, jitter_mode, spp)
    with span("rt.glue.frame"):
        if not _fused(scene, jm):
            return accumulate_samples(scene, xs, ys, spp, jm, ray_tile,
                                      sample_offset)
        kw = _kernel_kwargs(scene, jm)
        if _bouncing(scene) and wavefront:
            from ..ops.wavefront import render_tiles_wavefront

            return render_tiles_wavefront(scene, xs, ys, spp, sample_offset,
                                          capacity_tiles=cap,
                                          cand_plan=cand_plan, **kw)
        from ..ops.megakernel import render_tiles

        return render_tiles(scene, xs, ys, spp, sample_offset,
                            cand_plan=cand_plan, **kw)


def _dispatch(scene, jitter_mode, spp, cand_plan, capacity_tiles):
    with span("rt.dispatch.resolve"):
        if capacity_tiles is not None:
            wavefront, cap = True, int(capacity_tiles)
        else:
            wavefront, cap = resolve_wavefront(scene, jitter_mode, spp)
        if cand_plan is None:
            cand_plan = resolve_candidate_plan(scene, jitter_mode, spp)
        _warn_if_fallback(scene, jitter_mode, spp)
        return wavefront, cap, cand_plan


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
    the scene; ``ray_tile`` as in ``accumulate_samples``."""
    with span("rt.dispatch.frames"):
        wavefront, cap, cand_plan = _dispatch(scene, jitter_mode, 1,
                                              cand_plan, capacity_tiles)
        w, h = scene.camera.width, scene.camera.height
        xs, ys, (hp, wp) = _swizzled_grid(w, h, device=scene.device)
        jm = resolve_jitter_mode(scene, jitter_mode, 1)
        if (_fused(scene, jm) and _bouncing(scene) and wavefront
                and cap is not None):
            from ..ops.wavefront import render_tiles_wavefront_frames

            accum = render_tiles_wavefront_frames(
                scene, xs, ys, frames, sample_offset, capacity_tiles=cap,
                cand_plan=cand_plan, **_kernel_kwargs(scene, jm))
        else:
            accum = torch.stack([
                _frame_accum(scene, xs, ys, 1, int(sample_offset) + f,
                             jitter_mode, wavefront, cap, cand_plan,
                             ray_tile)
                for f in range(int(frames))])
        return _unswizzle(accum, w, h, hp, wp)


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
    "wang", else "center"); ``ray_tile`` as in ``accumulate_samples``."""
    spp = spp_override if spp_override is not None else scene.spp
    with span("rt.dispatch.scene"):
        wavefront, cap, cand_plan = _dispatch(scene, jitter_mode, spp,
                                              cand_plan, capacity_tiles)
        w, h = scene.camera.width, scene.camera.height
        xs, ys, (hp, wp) = _swizzled_grid(w, h, device=scene.device)
        accum = _frame_accum(scene, xs, ys, spp, sample_offset, jitter_mode,
                             wavefront, cap, cand_plan, ray_tile)
        img = _unswizzle(accum, w, h, hp, wp)
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
