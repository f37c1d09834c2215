"""Midpoint (1 -> 4) triangle subdivision for scale testing.

Numpy copy of ``raytracinginonesemester_tpu.scene.subdivide``: each
triangle splits at its edge midpoints into 4 coplanar children, so the
surface (and the image, up to shading-normal interpolation) is unchanged
while the triangle count grows 4x per level.  This is how scenes larger
than the kernels' plane budget are made from a real mesh (``bench.py
--large``): the frog subdivided 3 levels is 1,270,912 triangles, which the
staged integrator renders through the streamed kernels G and I
(``ops.block_kernels``).

Vertex normals at the midpoints are the average of the edge endpoints'
normals, left un-normalised: the renderer normalises the interpolated
normal anyway.
"""

from __future__ import annotations

import numpy as np

__all__ = ["subdivide_tris", "subdivide_geometry"]


def subdivide_tris(verts: np.ndarray, normals: np.ndarray,
                   obj_ids: np.ndarray, levels: int = 1):
    """Subdivide (T, 3, 3) triangle soup ``levels`` times -> 4^levels x.

    Returns (verts, normals, obj_ids) as numpy arrays; children keep
    their parent's object id and come in parent-major order (corner0,
    corner1, corner2, center), so the spatial locality the Morton block
    layout consumes is kept."""
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    obj_ids = np.asarray(obj_ids, np.int32)
    for _ in range(levels):
        v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
        n0, n1, n2 = normals[:, 0], normals[:, 1], normals[:, 2]
        m01, m12, m02 = (v0 + v1) * 0.5, (v1 + v2) * 0.5, (v0 + v2) * 0.5
        k01, k12, k02 = (n0 + n1) * 0.5, (n1 + n2) * 0.5, (n0 + n2) * 0.5
        verts = np.stack([
            np.stack([v0, m01, m02], 1),
            np.stack([m01, v1, m12], 1),
            np.stack([m02, m12, v2], 1),
            np.stack([m01, m12, m02], 1),
        ], 1).reshape(-1, 3, 3)
        normals = np.stack([
            np.stack([n0, k01, k02], 1),
            np.stack([k01, n1, k12], 1),
            np.stack([k02, k12, n2], 1),
            np.stack([k01, k12, k02], 1),
        ], 1).reshape(-1, 3, 3)
        obj_ids = np.repeat(obj_ids, 4)
    return verts, normals, obj_ids


def subdivide_geometry(geom, levels: int = 1, device=None):
    """Subdivided copy of a built ``Geometry`` (padding re-applied), on
    ``device`` (default: the geometry's own)."""
    from .build import geometry_from_mesh

    t = int(geom.num_triangles)
    v, n, o = subdivide_tris(
        geom.vertices[:t].cpu().numpy(), geom.normals[:t].cpu().numpy(),
        geom.obj_id[:t].cpu().numpy(), levels)
    return geometry_from_mesh(
        v, n, o, device=geom.vertices.device if device is None else device)
