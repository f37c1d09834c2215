"""Top-level render drivers.

PyTorch port of the wavefront route of
``raytracinginonesemester_tpu.render.renderer``: the swizzled 16x16
pixel-tile stream, the wavefront capacity resolve, and
``render_scene`` / ``render_scene_frames`` on top of
``ops.wavefront.render_tiles_wavefront_frames``.  Scenes the port does
not cover raise ``NotImplementedError`` with the reason; nothing falls
back to another path.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..ops.megakernel import megakernel_ineligible_reason
from ..scene.build import Scene

__all__ = ["render_scene", "render_scene_frames", "resolve_wavefront",
           "resolve_jitter_mode", "frog_scene", "entry"]


def _swizzled_grid(width: int, height: int, tile: int = 16, device="cpu"):
    """Pixel indices in tile-major (16x16) order over a tile-padded frame
    -> (xs, ys, (hp, wp)).  Seeds derive from absolute (x, y), so any
    pixel order gives the same image."""
    wp = -(-width // tile) * tile
    hp = -(-height // tile) * tile
    ys, xs = np.mgrid[0:hp, 0:wp]

    def swz(a):
        return (a.reshape(hp // tile, tile, wp // tile, tile)
                .transpose(0, 2, 1, 3).ravel())

    return (torch.as_tensor(swz(xs).astype(np.int32), device=device),
            torch.as_tensor(swz(ys).astype(np.int32), device=device),
            (hp, wp))


def _unswizzle(accum: torch.Tensor, width: int, height: int, hp: int, wp: int,
               tile: int = 16) -> torch.Tensor:
    """(..., hp*wp, C) tile-major -> (..., height, width, C) scanline."""
    lead = accum.shape[:-2]
    c = accum.shape[-1]
    img = (accum.reshape(*lead, hp // tile, wp // tile, tile, tile, c)
           .transpose(-4, -3)
           .reshape(*lead, hp, wp, c))
    return img[..., :height, :width, :]


def resolve_jitter_mode(scene: Scene, jitter_mode: str, spp: int) -> str:
    if jitter_mode != "auto":
        return jitter_mode
    return "wang" if (scene.dialect == "gpu" or spp > 1) else "center"


def _require_ported(scene: Scene, jitter_mode: str) -> None:
    reason = megakernel_ineligible_reason(scene, jitter_mode)
    if reason is not None:
        raise NotImplementedError(f"scene not covered by the port: {reason}")


def resolve_wavefront(scene: Scene, jitter_mode: str = "auto",
                      spp_override: Optional[int] = None):
    """(wavefront, capacity) for a scene.  ``RT_WAVEFRONT=0`` (the
    monolithic kernel) is not ported and raises; ``RT_WAVEFRONT_CAP``
    is "auto" (calibrate, cached on disk) or an integer tile count.
    A capacity of None means the ladder runs at full width."""
    if os.environ.get("RT_WAVEFRONT", "auto") == "0":
        raise NotImplementedError(
            "RT_WAVEFRONT=0: the monolithic render kernel is not ported yet")
    spp_eff = spp_override if spp_override is not None else scene.spp
    jm = resolve_jitter_mode(scene, jitter_mode, spp_eff)
    _require_ported(scene, jm)
    cap_env = os.environ.get("RT_WAVEFRONT_CAP", "auto")
    if cap_env == "auto":
        from ..ops.wavefront import auto_capacity_tiles

        return True, auto_capacity_tiles(scene, jitter=jm)
    return True, (int(cap_env) if cap_env else None)


def render_scene_frames(scene: Scene, frames: int, jitter_mode: str = "auto",
                        sample_offset: int = 0, cand_plan=None,
                        capacity_tiles: Optional[int] = None) -> torch.Tensor:
    """Render ``frames`` consecutive spp-1 frames -> (frames, H, W, 3);
    frame f uses sample index ``sample_offset + f``.  All frames share one
    merged compaction sort and bounce ladder.  ``capacity_tiles``
    overrides the calibrated capacity."""
    if cand_plan is not None:
        raise NotImplementedError(
            "binned camera-candidate plans are not ported yet")
    from ..ops.wavefront import render_tiles_wavefront_frames

    jm = resolve_jitter_mode(scene, jitter_mode, 1)
    if capacity_tiles is None:
        _, capacity_tiles = resolve_wavefront(scene, jitter_mode, 1)
    else:
        _require_ported(scene, jm)
    w, h = scene.camera.width, scene.camera.height
    xs, ys, (hp, wp) = _swizzled_grid(w, h, device=scene.device)
    accum = render_tiles_wavefront_frames(
        scene, xs, ys, frames, sample_offset, jitter=jm,
        capacity_tiles=capacity_tiles)
    return _unswizzle(accum, w, h, hp, wp)


def render_scene(scene: Scene, jitter_mode: str = "auto",
                 spp_override: Optional[int] = None, sample_offset: int = 0,
                 normalize: bool = True, cand_plan=None,
                 capacity_tiles: Optional[int] = None) -> torch.Tensor:
    """Render a scene to a linear (H, W, 3) float32 image: the mean (or,
    with ``normalize=False``, the sum) over spp samples of the clipped
    per-sample radiance, accumulated in sample order per pixel."""
    spp = spp_override if spp_override is not None else scene.spp
    frames = render_scene_frames(scene, spp, jitter_mode, sample_offset,
                                 cand_plan, capacity_tiles)
    acc = torch.zeros_like(frames[0])
    for f in range(spp):
        acc = acc + frames[f]
    return acc / float(spp) if normalize else acc


def frog_scene(width=256, height=144, spp=1, max_bounces=8,
               diffuse_bounce=True, device="cpu") -> Scene:
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


def entry():
    """(fn, example_args): one forward render of the frog scene, the
    counterpart of ``__graft_entry__.entry``; on the card when one is
    present."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    scene = frog_scene(device=device)

    def forward(s):
        return render_scene(s, jitter_mode="wang")

    return forward, (scene,)
