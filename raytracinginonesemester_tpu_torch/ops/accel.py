"""Block grid: Morton-ordered triangle blocks in plane-SoA layout.

PyTorch port of ``BlockGrid``, ``build_block_grid`` and ``super_aabbs``
from ``raytracinginonesemester_tpu.ops.accel``.  Triangles are sorted by
centroid Morton code (stable, so equal codes keep their input order) and
cut into runs of ``block_size``; each block's AABB is the union of its
members'.  The plane layout is kept as it is, so the planes of the two
packages can be compared element for element and handed across.
"""

from __future__ import annotations

import dataclasses

import torch

from .lbvh import morton_codes, triangle_aabbs

__all__ = ["BlockGrid", "build_block_grid", "super_aabbs", "SUPER"]

# blocks per superblock (the camera plan's coarse level)
SUPER = 8


@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """``tri`` (9, L, B): [v0 xyz, e1 xyz, e2 xyz]; ``norm`` (12, L, B):
    vertex normals [n0 n1 n2 xyz] and the unit geometric normal [g xyz];
    ``tri_index`` (L, B) original triangle ids (-1 padding); ``obj``
    (L, B) object ids (-1 padding); ``aabb`` (6, L) [min xyz, max xyz]."""

    tri: torch.Tensor
    norm: torch.Tensor
    tri_index: torch.Tensor
    obj: torch.Tensor
    aabb: torch.Tensor
    block_size: int

    @property
    def num_blocks(self) -> int:
        return int(self.tri.shape[1])


def build_block_grid(vertices: torch.Tensor, num_valid: int,
                     block_size: int = 128, normals: torch.Tensor = None,
                     obj_ids: torch.Tensor = None) -> BlockGrid:
    """Build the block grid from (T, 3, 3) float32 triangles; T must be a
    multiple of ``block_size``.  Triangles at or past ``num_valid`` are
    padding: they sort to the tail and never hit."""
    t = int(vertices.shape[0])
    if t % block_size:
        raise ValueError("triangle count must be padded to block_size")
    l = t // block_size
    dev = vertices.device
    if normals is None:
        normals = torch.zeros_like(vertices)

    leaf_min, leaf_max = triangle_aabbs(vertices)
    valid = torch.arange(t, device=dev) < int(num_valid)
    inf = torch.tensor(float("inf"), device=dev)
    scene_min = torch.where(valid[:, None], leaf_min, inf).amin(dim=0)
    scene_max = torch.where(valid[:, None], leaf_max, -inf).amax(dim=0)

    centroid = 0.5 * (leaf_min + leaf_max)
    extent = scene_max - scene_min
    unit = (centroid - scene_min) / torch.where(
        extent == 0, torch.ones_like(extent), extent)
    codes = morton_codes(unit)
    codes = torch.where(valid, codes, torch.full_like(codes, 0xFFFFFFFF))
    order = torch.argsort(codes, stable=True)

    sv = vertices[order]
    v0 = sv[:, 0]
    e1 = sv[:, 1] - v0
    e2 = sv[:, 2] - v0
    tri = torch.stack(
        [v0[:, 0], v0[:, 1], v0[:, 2],
         e1[:, 0], e1[:, 1], e1[:, 2],
         e2[:, 0], e2[:, 1], e2[:, 2]]
    ).reshape(9, l, block_size)

    sn = normals[order]
    g = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    g_len_sq = g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1] + g[:, 2] * g[:, 2]
    g = g / torch.sqrt(torch.clamp(g_len_sq, min=1e-38))[:, None]
    norm = torch.stack(
        [sn[:, 0, 0], sn[:, 0, 1], sn[:, 0, 2],
         sn[:, 1, 0], sn[:, 1, 1], sn[:, 1, 2],
         sn[:, 2, 0], sn[:, 2, 1], sn[:, 2, 2],
         g[:, 0], g[:, 1], g[:, 2]]
    ).reshape(12, l, block_size)

    sorted_valid = valid[order]
    minus1 = torch.full_like(order, -1)
    tri_index = torch.where(sorted_valid, order, minus1).to(
        torch.int32).reshape(l, block_size)
    if obj_ids is None:
        obj_ids = torch.zeros(t, dtype=torch.int32, device=dev)
    obj_plane = torch.where(sorted_valid, obj_ids.to(torch.int64)[order],
                            minus1).to(torch.int32).reshape(l, block_size)

    bmin = torch.where(sorted_valid[:, None], leaf_min[order], inf)
    bmax = torch.where(sorted_valid[:, None], leaf_max[order], -inf)
    block_min = bmin.reshape(l, block_size, 3).amin(dim=1)
    block_max = bmax.reshape(l, block_size, 3).amax(dim=1)
    aabb = torch.cat([block_min.T, block_max.T]).contiguous()  # (6, L)

    return BlockGrid(tri=tri.contiguous(), norm=norm.contiguous(),
                     tri_index=tri_index.contiguous(),
                     obj=obj_plane.contiguous(), aabb=aabb,
                     block_size=int(block_size))


def super_aabbs(grid: BlockGrid) -> torch.Tensor:
    """Union AABBs of consecutive SUPER-block groups -> (6, LS)."""
    l = grid.num_blocks
    ls = -(-l // SUPER)
    pad = ls * SUPER - l
    aabb = grid.aabb
    if pad:
        dev = aabb.device
        pad_cols = torch.cat([
            torch.full((3, pad), float("inf"), device=dev),
            torch.full((3, pad), float("-inf"), device=dev)])
        aabb = torch.cat([aabb, pad_cols], dim=1)
    smin = aabb[:3].reshape(3, ls, SUPER).amin(dim=2)
    smax = aabb[3:].reshape(3, ls, SUPER).amax(dim=2)
    return torch.cat([smin, smax])
