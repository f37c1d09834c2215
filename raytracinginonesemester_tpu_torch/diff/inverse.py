"""Differentiable rendering and inverse-rendering optimisation.

PyTorch port of ``raytracinginonesemester_tpu.diff.inverse``: pixel
losses and their gradients with respect to scene parameters, and a
gradient-descent loop that recovers parameters from a target image.

- Parameters are a dict of leaf tensors that require grad
  (``extract_params``, ``params_from_numpy``); ``apply_params`` returns
  a scene that renders with them, and ``render_loss`` is differentiable
  in every one of them.
- A scene with a block grid is differentiated in the detached way
  (``Scene.differentiable``, ``ops.integrator``): the grid only picks
  the winner triangles, and the gradients flow through a per-winner
  recompute.  With vertices among the parameters the grid is rebuilt
  from the detached vertices on every ``apply_params``.  A scene
  without a grid is differentiated through the brute-force intersector.
- Sample directions of diffuse bounces are constants to the gradient
  (the detached-sampling estimator); visibility edges carry no gradient.
- ``make_train_step`` and ``optimize`` run a ``torch.optim`` optimizer,
  which updates the parameter tensors in place (the JAX package returns
  new arrays); ``optimize`` takes ``torch.optim.Adam`` with the defaults
  of ``optax.adam`` (betas 0.9/0.999, eps 1e-8, bias-corrected).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..ops.binned import CHUNK
from ..render.renderer import pixel_stream, render_scene
from ..scene.build import Scene
from ..utils.timing import span

__all__ = [
    "apply_params",
    "camera_candidate_context",
    "extract_params",
    "make_train_step",
    "optimize",
    "params_from_numpy",
    "render_loss",
]


def _leaf(v: torch.Tensor) -> torch.Tensor:
    return v.detach().clone().requires_grad_(True)


def extract_params(scene: Scene, keys=("albedo", "emission")
                   ) -> Dict[str, torch.Tensor]:
    """The optimisable leaves of a scene, as copies that require grad.

    Keys: material fields (``albedo``, ``specular_color``, ``emission``,
    ``kd``, ``ks``, ``kr``, ``shininess``), light fields (``light_color``,
    ``light_intensity``, ``light_position``), ``vertices`` (the (T, 3, 3)
    world-space triangle soup) and ``camera_center`` (a rigid translation
    of the camera)."""
    out: Dict[str, torch.Tensor] = {}
    for k in keys:
        if k.startswith("light_"):
            v = getattr(scene.lights, k[len("light_"):])
        elif k == "vertices":
            v = scene.geometry.vertices
        elif k == "camera_center":
            v = scene.camera.center
        else:
            v = getattr(scene.materials, k)
        out[k] = _leaf(v)
    return out


def params_from_numpy(arrays: Mapping[str, np.ndarray],
                      scene: Scene) -> Dict[str, torch.Tensor]:
    """A parameter dict of numpy arrays (for example the JAX package's
    ``extract_params``, through ``np.asarray``) -> float32 leaf tensors
    that require grad, on the scene's device."""
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            .to(scene.device).requires_grad_(True)
            for k, v in arrays.items()}


def apply_params(scene: Scene, params: Mapping[str, torch.Tensor]) -> Scene:
    """The scene with the given parameter leaves substituted.

    ``vertices`` needs a scene without a block grid or one built
    differentiable: a grid bakes triangle copies at build time, so it
    would render stale geometry.  A differentiable scene's grid is rebuilt
    from the detached vertices (it only picks the winners; the gradients
    flow through the integrator's recompute).  ``camera_center`` moves
    ``pixel00_loc`` with it, so the viewing directions do not change."""
    with span("rt.dispatch.apply_params"):
        mat_updates, light_updates, scene_updates = {}, {}, {}
        for k, v in params.items():
            if k.startswith("light_"):
                light_updates[k[len("light_"):]] = v
            elif k == "vertices":
                if scene.accel is not None and not scene.differentiable:
                    raise ValueError(
                        "vertex parameters need accel='none' (or a scene "
                        "built with differentiable=True, which rebuilds the "
                        "grid): acceleration structures bake triangle copies "
                        "at build time")
                scene_updates["geometry"] = dataclasses.replace(
                    scene.geometry, vertices=v)
                if scene.accel is not None:
                    from ..ops.accel import build_block_grid

                    with torch.no_grad():
                        scene_updates["accel"] = build_block_grid(
                            v.detach(), scene.geometry.num_triangles,
                            block_size=scene.accel.block_size,
                            normals=scene.geometry.normals,
                            obj_ids=scene.geometry.obj_id)
            elif k == "camera_center":
                delta = v - scene.camera.center
                scene_updates["camera"] = dataclasses.replace(
                    scene.camera, center=v,
                    pixel00_loc=scene.camera.pixel00_loc + delta)
            else:
                mat_updates[k] = v
        materials = (dataclasses.replace(scene.materials, **mat_updates)
                     if mat_updates else scene.materials)
        lights = (dataclasses.replace(scene.lights, **light_updates)
                  if light_updates else scene.lights)
        return dataclasses.replace(scene, materials=materials, lights=lights,
                                   **scene_updates)


def render_loss(params: Mapping[str, torch.Tensor], scene: Scene,
                target: torch.Tensor, jitter_mode: str = "center",
                spp_override: Optional[int] = None,
                ray_tile: Optional[int] = None) -> torch.Tensor:
    """Mean squared pixel difference between the render with ``params``
    and ``target`` (H, W, 3).  ``ray_tile``: rays per integrator batch,
    default (None) the whole frame in one batch, as in the JAX package."""
    img = render_scene(apply_params(scene, params), jitter_mode=jitter_mode,
                       spp_override=spp_override,
                       ray_tile=0 if ray_tile is None else int(ray_tile))
    return torch.mean((img - target) ** 2)


def camera_candidate_context(scene: Scene, slack: float = 0.05,
                             chunk: int = CHUNK):
    """Binned depth-0 context for training loops on a differentiable scene
    with a block grid: builds the binned camera plan
    (``ops.binned.build_camera_candidate_plan``) of this scene's camera and
    triangles, every box inflated by ``slack``, and returns an
    ``ops.integrator.diff_candidate_plan`` to enter around the steps.

    The candidate set stays conservative while every vertex stays within
    ``slack`` of its position in ``scene``: build from the scene with the
    initial parameters applied, and rebuild when the optimiser has moved
    vertices further.  The plane values are regathered from the current
    grid on every trace; only the set is frozen."""
    from ..ops.binned import build_camera_candidate_plan
    from ..ops.integrator import diff_candidate_plan
    from ..ops.megakernel import RAY_TILE

    if scene.accel is None:
        raise ValueError("the binned context needs a block grid")
    xs, ys, _, _ = pixel_stream(int(scene.camera.width),
                                int(scene.camera.height), scene.device)
    with torch.no_grad():
        plan = build_camera_candidate_plan(scene.camera, xs, ys, scene.accel,
                                           RAY_TILE, chunk=chunk, slack=slack)
    return diff_candidate_plan(plan)


def make_train_step(optimizer: torch.optim.Optimizer,
                    jitter_mode: str = "center",
                    spp_override: Optional[int] = None,
                    ray_tile: Optional[int] = None):
    """``step(params, scene, target) -> loss``: one gradient step of
    ``optimizer``, whose parameters are the tensors of ``params``,
    on ``render_loss``.  The parameters are updated in place; the loss
    (a 0-d tensor, detached) is the one before the update."""

    def step(params, scene, target):
        with span("rt.dispatch.step"):
            optimizer.zero_grad(set_to_none=True)
            loss = render_loss(params, scene, target,
                               jitter_mode=jitter_mode,
                               spp_override=spp_override, ray_tile=ray_tile)
            with span("rt.glue.backward"):
                loss.backward()
            with span("rt.glue.adam"):
                optimizer.step()
            return loss.detach()

    return step


def optimize(scene: Scene, target: torch.Tensor, keys=("albedo",),
             steps: int = 100, learning_rate: float = 0.05,
             jitter_mode: str = "center", spp_override: Optional[int] = 1,
             init_params: Optional[Dict[str, torch.Tensor]] = None,
             ray_tile: Optional[int] = None):
    """Gradient-descent inverse rendering with Adam -> (params, losses)."""
    if init_params is not None:
        params = {k: _leaf(v) for k, v in init_params.items()}
    else:
        params = extract_params(scene, keys)
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    step = make_train_step(opt, jitter_mode, spp_override, ray_tile)
    losses = [float(step(params, scene, target)) for _ in range(steps)]
    return params, losses
