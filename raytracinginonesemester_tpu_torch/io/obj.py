"""Wavefront OBJ loading into flat SoA numpy arrays.

Re-design of the reference loaders:

- ``HW1/src/MeshOBJ.cpp:143-281`` — v/vt/vn/f parsing, quad->2 tris,
  vertex dedup by (position, texcoord, normal) index triple.
- ``HW2/HW2/GPUandCPU/include/MeshOBJ.h:260-427`` — adds negative
  (relative) index support, ``o``/``g`` tags mapped to per-triangle object
  IDs, and ``AppendMesh`` multi-object concatenation with normal/uv padding
  (``MeshOBJ.h:429-466``).

The output is a :class:`MeshArrays` of contiguous numpy arrays — the layout
a TPU renderer wants (uploaded once, indexed with gathers), matching the
reference's SoA ``MeshSOA``/``Mesh`` structs (``HW1/include/MeshOBJ.h:12-21``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["MeshArrays", "load_obj", "append_mesh", "mesh_to_triangles"]


@dataclasses.dataclass
class MeshArrays:
    """Unified indexed mesh in SoA layout (all numpy, host-side)."""

    positions: np.ndarray  # (V, 3) float32
    indices: np.ndarray  # (3T,) uint32
    normals: Optional[np.ndarray] = None  # (V, 3) float32 or None
    uvs: Optional[np.ndarray] = None  # (V, 2) float32 or None
    triangle_obj_ids: Optional[np.ndarray] = None  # (T,) int32 or None

    @property
    def num_vertices(self) -> int:
        return int(self.positions.shape[0])

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0]) // 3

    def has_normals(self) -> bool:
        return self.normals is not None and len(self.normals) > 0

    def has_uvs(self) -> bool:
        return self.uvs is not None and len(self.uvs) > 0


def _parse_face_vertex(token: str, n_pos: int, n_uv: int, n_nrm: int) -> Tuple[int, int, int]:
    """Parse one ``v[/vt][/vn]`` face token into 0-based (p, t, n) indices.

    Negative indices are relative to the current end of each list
    (``GPUandCPU/include/MeshOBJ.h:172-218``); missing entries are -1.
    """
    parts = token.split("/")
    p = int(parts[0])
    p = n_pos + p if p < 0 else p - 1
    t = n = -1
    if len(parts) >= 2 and parts[1] != "":
        t = int(parts[1])
        t = n_uv + t if t < 0 else t - 1
    if len(parts) >= 3 and parts[2] != "":
        n = int(parts[2])
        n = n_nrm + n if n < 0 else n - 1
    return p, t, n


def load_obj(path: str, next_object_id: int = 0) -> Tuple[MeshArrays, int]:
    """Load an OBJ file; returns (mesh, next_object_id).

    Mirrors ``LoadOBJ_ToMesh`` (``GPUandCPU/include/MeshOBJ.h:260-427``):

    - supports ``v``, ``vt``, ``vn``, ``f`` (tri + quad, quad split
      fan-style as (0,1,2),(0,2,3)), negative indices,
    - dedups vertices by exact (p, t, n) reference triple,
    - every ``o``/``g`` tag after the first face group bumps the running
      object id; all triangles carry their object id
      (``MeshOBJ.h:292-311``),
    - on return ``next_object_id`` has been advanced past all ids used.

    Raises ``ValueError`` on malformed input and ``FileNotFoundError`` if
    the path doesn't exist (the reference returns ``false``).
    """
    raw_pos: List[Tuple[float, float, float]] = []
    raw_uv: List[Tuple[float, float]] = []
    raw_nrm: List[Tuple[float, float, float]] = []

    file_has_uv = False
    file_has_nrm = False

    dedup: Dict[Tuple[int, int, int], int] = {}
    out_pos: List[Tuple[float, float, float]] = []
    out_uv: List[Tuple[float, float]] = []
    out_nrm: List[Tuple[float, float, float]] = []
    indices: List[int] = []
    tri_obj_ids: List[int] = []

    current_obj_id = next_object_id
    first_tag_found = False

    def get_or_create(key: Tuple[int, int, int]) -> int:
        idx = dedup.get(key)
        if idx is not None:
            return idx
        idx = len(out_pos)
        dedup[key] = idx
        p, t, n = key
        out_pos.append(raw_pos[p])
        if file_has_uv:
            out_uv.append(raw_uv[t] if 0 <= t < len(raw_uv) else (0.0, 0.0))
        if file_has_nrm:
            out_nrm.append(raw_nrm[n] if 0 <= n < len(raw_nrm) else (0.0, 0.0, 0.0))
        return idx

    with open(path, "r", errors="replace") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            tag, _, rest = s.partition(" ")
            if tag in ("o", "g") or s[0] in ("o", "g"):
                # Object/group tag semantics of MeshOBJ.h:292-311: the first
                # tag names the current object unless faces already exist;
                # later tags always start a new object id.
                if first_tag_found:
                    next_object_id += 1
                    current_obj_id = next_object_id
                else:
                    if indices:
                        next_object_id += 1
                        current_obj_id = next_object_id
                    first_tag_found = True
                continue
            if tag == "v":
                vals = rest.split()
                if len(vals) < 3:
                    raise ValueError(f"{path}: bad vertex line: {line!r}")
                raw_pos.append((float(vals[0]), float(vals[1]), float(vals[2])))
            elif tag == "vt":
                vals = rest.split()
                if len(vals) < 2:
                    raise ValueError(f"{path}: bad texcoord line: {line!r}")
                raw_uv.append((float(vals[0]), float(vals[1])))
                file_has_uv = True
            elif tag == "vn":
                vals = rest.split()
                if len(vals) < 3:
                    raise ValueError(f"{path}: bad normal line: {line!r}")
                raw_nrm.append((float(vals[0]), float(vals[1]), float(vals[2])))
                file_has_nrm = True
            elif tag == "f":
                tokens = rest.split()[:4]  # tri or quad, extra verts ignored
                keys = []
                for tok in tokens:
                    k = _parse_face_vertex(tok, len(raw_pos), len(raw_uv), len(raw_nrm))
                    if k[1] >= 0:
                        file_has_uv = True
                    if k[2] >= 0:
                        file_has_nrm = True
                    keys.append(k)
                if len(keys) < 3:
                    raise ValueError(f"{path}: face with <3 vertices: {line!r}")
                i0 = get_or_create(keys[0])
                i1 = get_or_create(keys[1])
                i2 = get_or_create(keys[2])
                indices += [i0, i1, i2]
                tri_obj_ids.append(current_obj_id)
                if len(keys) == 4:
                    i3 = get_or_create(keys[3])
                    indices += [i0, i2, i3]
                    tri_obj_ids.append(current_obj_id)
            # other tags (s, mtllib, usemtl, ...) ignored

    if not out_pos or not indices:
        raise ValueError(f"{path}: no geometry")
    next_object_id += 1

    mesh = MeshArrays(
        positions=np.asarray(out_pos, dtype=np.float32),
        indices=np.asarray(indices, dtype=np.uint32),
        normals=np.asarray(out_nrm, dtype=np.float32) if file_has_nrm else None,
        uvs=np.asarray(out_uv, dtype=np.float32) if file_has_uv else None,
        triangle_obj_ids=np.asarray(tri_obj_ids, dtype=np.int32),
    )
    return mesh, next_object_id


def append_mesh(dst: Optional[MeshArrays], src: MeshArrays) -> MeshArrays:
    """Concatenate two meshes, padding optional streams with zeros.

    Port of ``AppendMesh`` (``GPUandCPU/include/MeshOBJ.h:429-466``).
    """
    if dst is None:
        return src
    v_off = dst.num_vertices
    positions = np.concatenate([dst.positions, src.positions])
    indices = np.concatenate([dst.indices, src.indices + np.uint32(v_off)])

    def _merge(a, b, n_a, n_b, width):
        if a is None and b is None:
            return None
        a = a if a is not None else np.zeros((n_a, width), dtype=np.float32)
        b = b if b is not None else np.zeros((n_b, width), dtype=np.float32)
        return np.concatenate([a, b])

    normals = _merge(dst.normals, src.normals, dst.num_vertices, src.num_vertices, 3)
    uvs = _merge(dst.uvs, src.uvs, dst.num_vertices, src.num_vertices, 2)

    def _ids(m: MeshArrays):
        if m.triangle_obj_ids is not None:
            return m.triangle_obj_ids
        return np.zeros(m.num_triangles, dtype=np.int32)

    obj_ids = np.concatenate([_ids(dst), _ids(src)])
    return MeshArrays(positions, indices, normals, uvs, obj_ids)


def mesh_to_triangles(mesh: MeshArrays) -> Tuple[np.ndarray, np.ndarray]:
    """Gather indexed mesh into per-triangle arrays.

    Returns (vertices (T,3,3), normals (T,3,3)).  Missing normals become
    zeros, matching ``buildTrianglesKernel``
    (``GPUandCPU/src/main.cu:19-41``) — downstream intersection substitutes
    the geometric normal for zero-length shading normals
    (``GPUandCPU/include/query.h:117-122``).
    """
    idx = mesh.indices.reshape(-1, 3).astype(np.int64)
    verts = mesh.positions[idx]  # (T, 3, 3)
    if mesh.has_normals():
        normals = mesh.normals[idx]
    else:
        normals = np.zeros_like(verts)
    return verts.astype(np.float32), normals.astype(np.float32)
