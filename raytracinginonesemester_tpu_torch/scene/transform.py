"""Object-to-world transforms: scale -> rotate X,Y,Z (degrees) -> translate.

Host-side (numpy) port of ``CPUOnly/include/transform.h:11-85`` and the GPU
inline equivalent ``GPUandCPU/src/main.cu:53-96``.  Transforms are baked
into mesh vertices at scene-build time, exactly like the reference
(``ApplyTransformToMeshSOA``, ``transform.h:76-85``): the renderer itself
never sees object frames, only world-space triangle soup.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Transform", "transform_points", "transform_normals", "apply_transform"]


@dataclasses.dataclass
class Transform:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    rotation_deg: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, dtype=np.float32)
    )
    scale: np.ndarray = dataclasses.field(
        default_factory=lambda: np.ones(3, dtype=np.float32)
    )


def _rotation_matrix(rotation_deg: np.ndarray) -> np.ndarray:
    """Combined Rz @ Ry @ Rx for XYZ-order Euler angles in degrees.

    Equivalent to chaining ``rotate_x_rad``/``rotate_y_rad``/``rotate_z_rad``
    (``transform.h:22-46``) — the reference applies X, then Y, then Z.
    """
    rx, ry, rz = np.deg2rad(np.asarray(rotation_deg, dtype=np.float64))
    cx, sx = np.cos(rx), np.sin(rx)
    cy, sy = np.cos(ry), np.sin(ry)
    cz, sz = np.cos(rz), np.sin(rz)
    mx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    my = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    mz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return mz @ my @ mx


def _safe_inv(x: np.ndarray) -> np.ndarray:
    """``safe_inv`` (``transform.h:49-53``): 1/x, or 0 when |x| < 1e-12."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    nz = np.abs(x) >= 1e-12
    out[nz] = 1.0 / x[nz]
    return out


def transform_points(t: Transform, points: np.ndarray) -> np.ndarray:
    """Full transform of (N, 3) points (``transform_point``, transform.h:56-60)."""
    r = _rotation_matrix(t.rotation_deg)
    p = np.asarray(points, dtype=np.float64) * np.asarray(t.scale, dtype=np.float64)
    return (p @ r.T + np.asarray(t.position, dtype=np.float64)).astype(np.float32)


def transform_normals(t: Transform, normals: np.ndarray) -> np.ndarray:
    """Inverse-transpose transform of (N, 3) normals, re-normalized.

    Port of ``transform_normal`` (``transform.h:65-71``): for linear = R*S,
    normal' = normalize(R @ (n / S)).  Degenerate results fall back to
    +Z like the GPU variant (``main.cu:88-92``).
    """
    r = _rotation_matrix(t.rotation_deg)
    inv_s = _safe_inv(np.asarray(t.scale))
    n = np.asarray(normals, dtype=np.float64) * inv_s
    n = n @ r.T
    len_sq = np.sum(n * n, axis=-1, keepdims=True)
    ok = len_sq > 1e-12
    n = np.where(ok, n / np.sqrt(np.maximum(len_sq, 1e-300)), [0.0, 0.0, 1.0])
    return n.astype(np.float32)


def apply_transform(mesh, t: Transform):
    """In-place-style transform of a :class:`~...io.obj.MeshArrays`.

    Port of ``ApplyTransformToMeshSOA`` (``transform.h:76-85``).  Returns a
    new MeshArrays with transformed positions/normals.
    """
    import dataclasses as _dc

    new_pos = transform_points(t, mesh.positions)
    new_nrm = (
        transform_normals(t, mesh.normals) if mesh.has_normals() else mesh.normals
    )
    return _dc.replace(mesh, positions=new_pos, normals=new_nrm)
