"""Morton codes and triangle AABBs (the parts of the LBVH the block grid uses).

PyTorch port of ``morton_codes``, ``triangle_aabbs`` and ``_bit_expand``
from ``raytracinginonesemester_tpu.ops.lbvh`` (``GPUandCPU/include/
bvh.h:57-151``).  uint32 values live in int64 tensors, as in
``core.rng``; every step stays below 2**32, so no mask is needed.
The Karras tree itself is not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["morton_codes", "triangle_aabbs"]


def _bit_expand(v: torch.Tensor) -> torch.Tensor:
    """Spread 10 bits to every 3rd position (``bitExpansion``, bvh.h:131-138)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(points: torch.Tensor, resolution: float = 1024.0) -> torch.Tensor:
    """30-bit Morton codes (int64) of (N, 3) float32 points in the unit
    cube (``ComputeMortonCode``, bvh.h:141-151)."""
    scaled = torch.clamp(points * resolution, 0.0, resolution - 1.0)
    q = scaled.to(torch.int64)  # truncation, as the uint32 cast
    return (_bit_expand(q[..., 0]) * 4 + _bit_expand(q[..., 1]) * 2
            + _bit_expand(q[..., 2]))


def triangle_aabbs(vertices: torch.Tensor):
    """Per-triangle AABBs from (T, 3, 3) vertices (``bvh.h:57-77``)."""
    return vertices.amin(dim=1), vertices.amax(dim=1)
