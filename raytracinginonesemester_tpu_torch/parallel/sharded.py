"""Multi-process rendering: pixel data parallelism and triangle model
parallelism.

PyTorch port of ``raytracinginonesemester_tpu.parallel.sharded``.  A mesh
is a grid of processes (``make_mesh``):

- **data axis**: the pixels are split over the data ranks; each renders
  its share and the shares are all-gathered, so every rank returns the
  whole image;
- **model axis**: the block grid is split over the model ranks; each
  tests its own blocks, and the closest hits and occlusion flags merge by
  collectives in the integrator (``ops.integrator.merge_hits_over_axis``).

Rays are seeded by absolute (pixel, sample), so any mesh renders the
image of ``render_scene``: bit for bit under pure data parallelism on the
same device, since every rank runs the kernels the unsharded render runs
on its share of the tile stream.

Every rank calls every function here with the same arguments (the same
scene, replicated), as the ranks of one ``torch.distributed`` job; the
scene's device is the rank's device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import comm
from ..ops.megakernel import GROUP_TILES, RAY_TILE
from ..render.renderer import (DEFAULT_RAY_TILE, Route, accumulate_samples,
                               pixel_stream, render_stream, resolve_jitter_mode,
                               resolve_route, unswizzle)
from ..scene.build import Scene

__all__ = ["Mesh", "make_mesh", "make_train_step_sharded",
           "render_scene_sharded", "shard_scene_blocks"]


class Mesh:
    """A process mesh as one rank sees it: each axis's size (ranks are
    laid out row-major over the axes, as a reshaped device array is),
    this rank's coordinate on it, and the process group of the ranks
    that differ from this one along that axis alone (None without a
    process group)."""

    def __init__(self, shape: dict, coords: dict, groups: dict):
        self.shape, self.coords, self.groups = shape, coords, groups

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        return self.groups.get(axis)


def make_mesh(shape=None, axis_names=("data",)) -> Mesh:
    """The mesh of this job's ranks; default 1-D over all of them.

    Without an initialised process group the job is one rank, and the
    mesh's axes are of size 1 with no groups.  Every rank must call it,
    in the same order as its other group creations."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != world:
        raise ValueError(f"mesh {shape} over axes {tuple(axis_names)} does "
                         f"not hold the job's {world} ranks")
    coords = dict(zip(axis_names, (int(c) for c in
                                   np.unravel_index(me, shape))))
    groups = {}
    for k, name in enumerate(axis_names):
        if not dist.is_initialized():
            groups[name] = None
            continue
        lists = []
        for rest in itertools.product(*(range(n) for j, n in
                                        enumerate(shape) if j != k)):
            lists.append([int(np.ravel_multi_index(
                rest[:k] + (i,) + rest[k:], shape)) for i in range(shape[k])])
        groups[name], _ = dist.new_subgroups_by_enumeration(lists)
    return Mesh(dict(zip(axis_names, shape)), coords, groups)


def shard_scene_blocks(scene: Scene, num_shards: int) -> Scene:
    """Pad the block grid to a multiple of ``num_shards`` blocks so it
    splits evenly: padding blocks have zero planes, ids and objects -1 and
    an empty AABB (+inf/-inf), which no slab test passes."""
    grid = scene.accel
    if grid is None:
        return scene
    pad = (-grid.num_blocks) % int(num_shards)
    if pad == 0:
        return scene
    b, dev = grid.block_size, grid.tri.device
    inf = float("inf")
    grid = dataclasses.replace(
        grid,
        tri=torch.cat([grid.tri, grid.tri.new_zeros(9, pad, b)], dim=1),
        norm=torch.cat([grid.norm, grid.norm.new_zeros(12, pad, b)], dim=1),
        tri_index=torch.cat([grid.tri_index,
                             grid.tri_index.new_full((pad, b), -1)]),
        obj=torch.cat([grid.obj, grid.obj.new_full((pad, b), -1)]),
        aabb=torch.cat([grid.aabb, torch.cat([
            torch.full((3, pad), inf, device=dev),
            torch.full((3, pad), -inf, device=dev)])], dim=1))
    return dataclasses.replace(scene, accel=grid)


def _local_blocks(scene: Scene, shard: int, num_shards: int) -> Scene:
    """Shard ``shard``'s contiguous slice of a padded block grid (the JAX
    package's ``P(None, model, None)``); triangle ids stay global, which
    the merge's tie-break needs."""
    grid = scene.accel
    if grid is None:
        return scene
    n = grid.num_blocks // num_shards
    sl = slice(shard * n, (shard + 1) * n)
    grid = dataclasses.replace(
        grid, tri=grid.tri[:, sl].contiguous(),
        norm=grid.norm[:, sl].contiguous(),
        tri_index=grid.tri_index[sl].contiguous(),
        obj=grid.obj[sl].contiguous(), aabb=grid.aabb[:, sl].contiguous())
    return dataclasses.replace(scene, accel=grid)


def _pixel_grid(width: int, height: int, device):
    """Scanline pixel indices (xs, ys), int32."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.int32, device=device),
        torch.arange(width, dtype=torch.int32, device=device), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1)


def _pad_to(xs, ys, quantum: int):
    pad = (-int(xs.shape[0])) % quantum
    if pad:
        xs = torch.cat([xs, xs.new_zeros(pad)])
        ys = torch.cat([ys, ys.new_zeros(pad)])
    return xs, ys


def _render_sharded_fast(scene: Scene, mesh: Mesh, stream, route: Route,
                         spp: int, sample_offset: int = 0):
    """The fused kernels on each data rank's share of the tile stream
    (``pixel_stream`` over the data ranks), then gathered.  The stream's
    groups of ``GROUP_TILES`` tiles are dealt round-robin (group g to rank
    g mod S): an object in the middle of the frame then lights up about
    the mean share of every rank's tiles, as the capacity divided over
    the ranks assumes (contiguous bands of the frame gave the middle
    ranks more alive tiles than their capacity on the headline frog).
    Each rank takes its groups' meta rows of the route's binned plan and
    the shared chunk stream."""
    xs, ys, _, (hp, wp) = stream
    n_data, d = mesh.size("data"), mesh.index("data")
    q = GROUP_TILES * RAY_TILE
    groups = int(xs.shape[0]) // (n_data * q)
    plan = route.cand_plan
    if plan is not None:
        plan = dataclasses.replace(plan, meta=plan.meta.reshape(
            groups, n_data, GROUP_TILES, -1)[:, d].reshape(
                groups * GROUP_TILES, -1).contiguous())

    def mine(a):
        return a.reshape(groups, n_data, q)[:, d].reshape(-1)

    accum = render_stream(scene, dataclasses.replace(route, cand_plan=plan),
                          mine(xs), mine(ys), spp, sample_offset)
    accum = comm.gather_rows(accum, mesh.group("data")).reshape(
        n_data, groups, q, 3).transpose(0, 1).reshape(-1, 3)
    w, h = scene.camera.width, scene.camera.height
    return unswizzle(accum, w, h, hp, wp) / float(spp)


def _render_sharded_staged(scene: Scene, mesh: Mesh, jitter_mode: str,
                           ray_tile: int, spp: int,
                           model_axis: Optional[str], compacted: bool = False,
                           sample_offset: int = 0,
                           capacity: Optional[int] = None):
    """The staged integrator on each data rank's share of the scanline
    pixels (padded to a multiple of the data size), with the block grid
    split over ``model_axis``; ``compacted`` takes the compacted
    scheduler (``wavefront_sharded.trace_rays_compacted``, at
    ``capacity`` rows if given)."""
    from ..ops.integrator import trace_rays
    from .wavefront_sharded import trace_rays_compacted

    w, h = scene.camera.width, scene.camera.height
    num_rays = w * h
    n_data, d = mesh.size("data"), mesh.index("data")
    xs, ys = _pad_to(*_pixel_grid(w, h, scene.device), n_data)
    n_l = int(xs.shape[0]) // n_data
    xs, ys = xs[d * n_l:(d + 1) * n_l], ys[d * n_l:(d + 1) * n_l]
    group_m = None
    if model_axis is not None:
        m = mesh.size(model_axis)
        scene = _local_blocks(shard_scene_blocks(scene, m),
                              mesh.index(model_axis), m)
        group_m = mesh.group(model_axis)
    group_d = mesh.group("data")
    shared = scene.camera.is_pinhole

    def trace(o, dirs, seeds):
        if compacted:
            return trace_rays_compacted(o, dirs, seeds, scene, group_m,
                                        group_d, capacity)
        return trace_rays(o, dirs, seeds, scene, group_m,
                          shared_origin0=shared)

    # the compacted scheduler takes a sample's rays in one batch
    accum = accumulate_samples(scene, xs, ys, spp, jitter_mode,
                               0 if compacted else ray_tile, sample_offset,
                               trace=trace)
    accum = comm.gather_rows(accum, group_d)[:num_rays]
    return (accum / float(spp)).reshape(h, w, 3)


def render_scene_sharded(scene: Scene, mesh: Mesh, jitter_mode: str = "auto",
                         ray_tile: int = DEFAULT_RAY_TILE,
                         spp_override: Optional[int] = None,
                         model_axis: Optional[str] = None,
                         sample_offset: int = 0) -> torch.Tensor:
    """Render with the pixels split over ``mesh``'s axis "data" (and the
    block grid over ``model_axis``) -> the whole (H, W, 3) linear image
    on every rank, differentiable for a differentiable scene.

    Without a model axis of more than one rank, the route is
    ``render_scene``'s (``resolve_route`` over the mesh), and a scene the
    fused kernels take renders on them as ``render_scene`` would (staged
    wavefront or kernel D, the binned plan); the capacity is calibrated
    on data rank 0 and divided over the data ranks.  Any other scene
    takes the staged integrator; with a model axis of more than one rank,
    a block grid and more than one bounce, through the compacted
    scheduler.  ``sample_offset`` as in ``render_scene``."""
    spp = spp_override if spp_override is not None else scene.spp
    jm = resolve_jitter_mode(scene, jitter_mode, spp)
    tp = model_axis is not None and mesh.size(model_axis) > 1
    if not tp:
        stream = pixel_stream(scene.camera.width, scene.camera.height,
                              scene.device, mesh.size("data"))
        route = resolve_route(scene, stream, jm, spp, mesh=mesh)
        if not route.staged:
            return _render_sharded_fast(scene, mesh, stream, route, spp,
                                        sample_offset)
    compacted = (tp and scene.accel is not None
                 and int(scene.max_bounces) > 1)
    return _render_sharded_staged(scene, mesh, jm, ray_tile, spp, model_axis,
                                  compacted, sample_offset)


def make_train_step_sharded(optimizer: torch.optim.Optimizer, mesh: Mesh,
                            jitter_mode: str = "center",
                            spp_override: Optional[int] = None,
                            ray_tile: int = DEFAULT_RAY_TILE):
    """``step(params, scene, target) -> loss``: one step of ``optimizer``
    on the mean squared difference of ``render_scene_sharded`` from
    ``target``, on every rank of the mesh.

    Each rank back-propagates through its own pixels' share of the loss
    (``comm.gather_rows``), the gradients are summed over the data ranks
    (the JAX package's gradient psum), and every rank then takes the same
    optimizer step.  ``params`` and ``target`` must be equal on every
    rank."""
    from ..diff.inverse import apply_params

    def step(params, scene, target):
        optimizer.zero_grad(set_to_none=True)
        img = render_scene_sharded(apply_params(scene, params), mesh,
                                   jitter_mode, ray_tile, spp_override)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        for p in params.values():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            p.grad = comm.all_reduce(g, mesh.group("data"))
        optimizer.step()
        return loss.detach()

    return step
