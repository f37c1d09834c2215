"""Scene building: configs + OBJ files -> tensors on one device.

PyTorch port of ``raytracinginonesemester_tpu.scene.build``
(``GPUandCPU/src/main.cu:164-190``): load each mesh node, bake its
transform into world space, assign object ids, concatenate everything
into one padded triangle soup, and build the block grid.

``scene_from_numpy`` rebuilds a ``Scene`` from another package's arrays
(camera, materials, lights, block-grid planes) handed over as numpy, so
that two renderers can be fed the very same planes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Mapping, Optional

import numpy as np
import torch

from ..core.camera import Camera
from ..io.obj import MeshArrays, append_mesh, mesh_to_triangles
from ..ops.accel import BlockGrid, build_block_grid
from .config import SceneConfig, load_scene_config, resolve_mesh_path
from .material import Lights, MaterialTable
from .transform import apply_transform

__all__ = ["Geometry", "Scene", "build_scene", "load_scene",
           "geometry_from_mesh", "scene_from_numpy"]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Geometry:
    """World-space triangle soup padded to a multiple of 512 with
    degenerate point triangles at the first vertex (zero edges never
    hit, ``query.h:84-88``)."""

    vertices: torch.Tensor  # (T, 3, 3) float32
    normals: torch.Tensor  # (T, 3, 3) float32
    obj_id: torch.Tensor  # (T,) int32, -1 padding
    num_triangles: int

    @property
    def padded_triangles(self) -> int:
        return int(self.vertices.shape[0])


def geometry_from_mesh(verts: np.ndarray, normals: np.ndarray,
                       obj_ids: Optional[np.ndarray] = None,
                       pad_to: int = 512, device="cuda") -> Geometry:
    t = int(verts.shape[0])
    padded = max(_round_up(t, pad_to), pad_to)
    if obj_ids is None:
        obj_ids = np.zeros(t, dtype=np.int32)
    if padded > t:
        anchor = verts[0, 0] if t > 0 else np.zeros(3, dtype=np.float32)
        pad_v = np.broadcast_to(anchor, (padded - t, 3, 3))
        verts = np.concatenate([verts, pad_v.astype(np.float32)])
        normals = np.concatenate([normals, np.zeros((padded - t, 3, 3), np.float32)])
        obj_ids = np.concatenate([obj_ids, np.full(padded - t, -1, np.int32)])

    def t_(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=dt), device=device)

    return Geometry(vertices=t_(verts, np.float32), normals=t_(normals, np.float32),
                    obj_id=t_(obj_ids, np.int32), num_triangles=t)


@dataclasses.dataclass(frozen=True)
class Scene:
    """Fully built render input: geometry, materials, lights, camera and
    the block grid, all on ``camera.device``.  ``terminal_only`` is True
    when no material has kr > 0.  ``differentiable`` scenes are not
    supported by the port yet (renderers raise)."""

    geometry: Geometry
    materials: MaterialTable
    lights: Lights
    camera: Camera
    max_bounces: int
    spp: int
    diffuse_bounce: bool
    background_kind: str  # "sky" | "miss"
    dialect: str
    miss_color: torch.Tensor
    accel: Optional[BlockGrid] = None
    terminal_only: bool = False
    differentiable: bool = False

    @property
    def device(self) -> torch.device:
        return self.camera.device


def build_scene(config: SceneConfig, scene_path: str = ".",
                accel: str = "blocks", device="cuda") -> Scene:
    """Load meshes, bake transforms and assemble the scene on ``device``.
    ``RT_BLOCK_SIZE`` (default 512) sets the block grid's block size."""
    global_mesh: Optional[MeshArrays] = None
    materials: List[dict] = []
    next_object_id = 0

    for node in config.nodes:
        if node.type and node.type != "mesh":
            continue
        path = resolve_mesh_path(scene_path, node.path)
        obj_id_begin = next_object_id
        from ..io.fast_obj import load_obj_fast

        mesh, next_object_id = load_obj_fast(path, next_object_id)
        mesh = apply_transform(mesh, node.transform)
        while len(materials) < next_object_id:
            materials.append(dict(node.material))
        for oid in range(obj_id_begin, next_object_id):
            materials[oid] = dict(node.material)
        global_mesh = append_mesh(global_mesh, mesh)

    if global_mesh is None:
        raise ValueError("scene contains no mesh nodes")

    verts, normals = mesh_to_triangles(global_mesh)
    geometry = geometry_from_mesh(verts, normals, global_mesh.triangle_obj_ids,
                                  device=device)
    camera = Camera.create(
        position=config.camera_position,
        look_at=config.camera_look_at,
        up=config.camera_up,
        focal_length_mm=config.focal_length_mm,
        sensor_height_mm=config.sensor_height_mm,
        sensor_width_mm=config.sensor_width_mm,
        width=config.pixel_width,
        height=config.pixel_height,
        device=device,
    )

    accel_struct = None
    if accel == "blocks":
        block_size = int(os.environ.get("RT_BLOCK_SIZE", "512"))
        if os.environ.get("RT_BLOCK_LAYOUT", "runs") != "runs":
            raise NotImplementedError(
                "only the Morton-run block layout is ported "
                "(RT_BLOCK_LAYOUT=treelet is not)")
        accel_struct = build_block_grid(
            geometry.vertices, geometry.num_triangles,
            normals=geometry.normals, obj_ids=geometry.obj_id,
            block_size=block_size)
    elif accel not in (None, "none", "bruteforce"):
        raise ValueError(f"unknown accel {accel!r}")

    bg_kind, bg_color = config.background
    terminal_only = all(
        float(np.ravel(m.get("kr", 0.0))[0]) == 0.0 for m in materials)
    return Scene(
        terminal_only=terminal_only,
        accel=accel_struct,
        geometry=geometry,
        materials=MaterialTable.from_dicts(materials, device=device),
        lights=Lights.from_dicts(config.lights, device=device),
        camera=camera,
        max_bounces=max(1, config.max_bounces),
        spp=config.spp,
        diffuse_bounce=config.diffuse_bounce,
        background_kind=bg_kind,
        dialect=config.dialect,
        miss_color=torch.as_tensor(
            np.asarray(bg_color if bg_color is not None else (0.0, 0.0, 0.0),
                       np.float32), device=device),
    )


def load_scene(path: str, dialect: str = "auto", accel: str = "blocks",
               device="cuda") -> Scene:
    """JSON path -> Scene on ``device``."""
    config = load_scene_config(path, dialect=dialect)
    return build_scene(config, scene_path=path, accel=accel, device=device)


def scene_from_numpy(arrays: Mapping[str, np.ndarray], statics: Mapping,
                     device="cuda") -> Scene:
    """Scene from numpy arrays under the JAX package's field names.

    ``arrays`` keys: ``camera.{center,pixel00_loc,pixel_delta_u,
    pixel_delta_v}``, ``materials.<field>``, ``lights.{position,color,
    intensity,radius}``, ``miss_color``, ``geometry.{vertices,normals,
    obj_id}`` and, for a block grid, ``accel.{tri,norm,tri_index,obj,
    aabb}``.  ``statics``: ``width``, ``height``, ``max_bounces``, ``spp``,
    ``diffuse_bounce``, ``background_kind``, ``dialect``,
    ``terminal_only``, ``differentiable``, ``num_triangles``,
    ``shadow_samples`` and, with a grid, ``block_size``."""

    def t_(key, dtype):
        # a copy: the arrays may be read-only views of another package's
        # buffers
        return torch.from_numpy(np.array(arrays[key], dtype=dtype,
                                         order="C")).to(device)

    camera = Camera(
        center=t_("camera.center", np.float32),
        pixel00_loc=t_("camera.pixel00_loc", np.float32),
        pixel_delta_u=t_("camera.pixel_delta_u", np.float32),
        pixel_delta_v=t_("camera.pixel_delta_v", np.float32),
        width=int(statics["width"]), height=int(statics["height"]))
    materials = MaterialTable(**{
        f.name: t_(f"materials.{f.name}", np.float32)
        for f in dataclasses.fields(MaterialTable)})
    lights = Lights(
        position=t_("lights.position", np.float32),
        color=t_("lights.color", np.float32),
        intensity=t_("lights.intensity", np.float32),
        radius=t_("lights.radius", np.float32),
        shadow_samples=tuple(int(s) for s in statics["shadow_samples"]))
    geometry = Geometry(vertices=t_("geometry.vertices", np.float32),
                        normals=t_("geometry.normals", np.float32),
                        obj_id=t_("geometry.obj_id", np.int32),
                        num_triangles=int(statics["num_triangles"]))
    grid = None
    if "accel.tri" in arrays:
        grid = BlockGrid(tri=t_("accel.tri", np.float32),
                         norm=t_("accel.norm", np.float32),
                         tri_index=t_("accel.tri_index", np.int32),
                         obj=t_("accel.obj", np.int32),
                         aabb=t_("accel.aabb", np.float32),
                         block_size=int(statics["block_size"]))
    return Scene(
        geometry=geometry, materials=materials, lights=lights, camera=camera,
        max_bounces=int(statics["max_bounces"]), spp=int(statics["spp"]),
        diffuse_bounce=bool(statics["diffuse_bounce"]),
        background_kind=str(statics["background_kind"]),
        dialect=str(statics["dialect"]),
        miss_color=t_("miss_color", np.float32), accel=grid,
        terminal_only=bool(statics["terminal_only"]),
        differentiable=bool(statics["differentiable"]))
