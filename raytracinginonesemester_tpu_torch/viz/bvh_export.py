"""BVH / block-grid visualization: AABB wireframe OBJ export.

Port of ``raytracinginonesemester_tpu.viz.bvh_export`` (the reference's
``GPUandCPU/include/visualizer.h:10-80``): every AABB becomes 8 vertices
and 12 ``l`` (line) records in an OBJ file, viewable with
``viz/view_bvh.py`` or any OBJ tool.  numpy only: tensors on any device
are copied to the host first.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["export_aabbs_to_obj", "export_lbvh_to_obj", "export_block_grid_to_obj"]

_CORNERS = [
    (0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1),
]
_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),  # bottom
    (4, 5), (5, 6), (6, 7), (7, 4),  # top
    (0, 4), (1, 5), (2, 6), (3, 7),  # pillars
]


def _host(a) -> np.ndarray:
    """numpy view of an array or a tensor on any device."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def export_aabbs_to_obj(
    path: str,
    aabb_min,
    aabb_max,
    offset: int = 0,
    count: Optional[int] = None,
) -> int:
    """Write AABBs [offset, offset+count) as wireframe boxes; returns the
    number of valid boxes written.  Inverted boxes (min > max) and boxes
    with a non-finite corner are skipped (``ExportAABBsToOBJ``,
    visualizer.h:33-35)."""
    aabb_min = _host(aabb_min).astype(np.float64)
    aabb_max = _host(aabb_max).astype(np.float64)
    n = aabb_min.shape[0]
    if count is None:
        count = n - offset
    valid = 0
    v_idx = 1  # OBJ is 1-based
    with open(path, "w") as out:
        for i in range(offset, min(offset + count, n)):
            lo, hi = aabb_min[i], aabb_max[i]
            if not np.all(np.isfinite(lo)) or not np.all(np.isfinite(hi)):
                continue
            if np.any(lo > hi):
                continue
            valid += 1
            for cx, cy, cz in _CORNERS:
                x = hi[0] if cx else lo[0]
                y = hi[1] if cy else lo[1]
                z = hi[2] if cz else lo[2]
                out.write(f"v {x:.9g} {y:.9g} {z:.9g}\n")
            for a, b in _EDGES:
                out.write(f"l {v_idx + a} {v_idx + b}\n")
            v_idx += 8
    return valid


def export_lbvh_to_obj(path: str, bvh, internal_only: bool = False) -> int:
    """Export an ``ops.lbvh.Lbvh``'s node AABBs as wireframes."""
    amin = _host(bvh.aabb_min)
    amax = _host(bvh.aabb_max)
    if internal_only:
        p = bvh.num_leaves
        amin, amax = amin[: p - 1], amax[: p - 1]
    return export_aabbs_to_obj(path, amin, amax)


def export_block_grid_to_obj(path: str, grid) -> int:
    """Export an ``ops.accel.BlockGrid``'s block AABBs as wireframes."""
    aabb = _host(grid.aabb)  # (6, L)
    return export_aabbs_to_obj(path, aabb[:3].T, aabb[3:].T)
