"""ctypes binding for the native OBJ tokenizer (io/csrc/fast_obj.c).

The shared library is built on demand with the system C compiler and
cached next to the source; every entry point degrades gracefully to the
pure-Python loader when no compiler is available.  Semantic assembly
(vertex dedup by (p, t, n) key, quad fan split, object-id bookkeeping)
happens here in vectorized numpy, so the semantics match ``io.obj``
exactly — tests assert equality on every mesh.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

from .obj import MeshArrays

__all__ = ["load_obj_fast", "native_available"]

_SRC = os.path.join(os.path.dirname(__file__), "csrc", "fast_obj.c")
_LIB_PATH = os.path.join(os.path.dirname(__file__), "csrc", "_fast_obj.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        try:
            return ctypes.CDLL(_LIB_PATH)
        except OSError:
            pass  # corrupt/ABI-stale cache: fall through and rebuild
    for cc in ("cc", "gcc", "clang"):
        # compile to a private temp file then os.replace (atomic on
        # POSIX), so concurrent processes never load a half-written .so
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                [cc, "-O2", "-fPIC", "-shared", "-o", tmp, _SRC],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB_PATH)
            return ctypes.CDLL(_LIB_PATH)
        except (OSError, subprocess.CalledProcessError):
            continue
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
    _build_failed = True
    return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            lib = _build()
            if lib is not None:
                lib.fo_parse.restype = ctypes.c_int64
                lib.fo_parse.argtypes = [
                    ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
                    ctypes.POINTER(ctypes.c_int64),
                ]
            _lib = lib
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def load_obj_fast(path: str, next_object_id: int = 0) -> Tuple[MeshArrays, int]:
    """Drop-in replacement for ``io.obj.load_obj`` using the native
    tokenizer; falls back to the Python implementation transparently."""
    lib = _get_lib()
    if lib is None:
        from .obj import load_obj

        return load_obj(path, next_object_id)

    size = os.path.getsize(path)
    # generous capacity bounds from file size (records are >= 7 bytes)
    cap = max(1024, size // 7 + 16)
    positions = np.empty((cap, 3), np.float32)
    normals = np.empty((cap, 3), np.float32)
    uvs = np.empty((cap, 2), np.float32)
    face_vertex = np.empty((4 * cap, 3), np.int32)
    face_sizes = np.empty(cap, np.int32)
    face_obj = np.empty(cap, np.int32)
    counts = np.zeros(5, np.int64)

    rc = lib.fo_parse(
        path.encode(),
        _fptr(positions), cap,
        _fptr(normals), cap,
        _fptr(uvs), cap,
        _iptr(face_vertex), 4 * cap,
        _iptr(face_sizes), _iptr(face_obj), cap,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise ValueError(f"{path}: native OBJ parse failed (code {rc})")
    np_, nn, nt, nfv, nf = (int(c) for c in counts)
    if np_ == 0 or nf == 0:
        raise ValueError(f"{path}: no geometry")

    positions = positions[:np_]
    normals = normals[:nn]
    uvs = uvs[:nt]
    face_vertex = face_vertex[:nfv]
    face_sizes = face_sizes[:nf]
    face_obj = face_obj[:nf]

    has_nrm = bool((face_vertex[:, 2] >= 0).any()) or nn > 0 and bool((face_vertex[:, 2] >= 0).any())
    has_uv = bool((face_vertex[:, 1] >= 0).any())
    has_nrm = bool((face_vertex[:, 2] >= 0).any())

    # --- vectorized dedup by (p, t, n) reference triple (MeshOBJ.cpp:105-141)
    keys = face_vertex.astype(np.int64)
    packed = (keys[:, 0] + 1) * (nt + 2) * (nn + 2) + (keys[:, 1] + 1) * (nn + 2) + (keys[:, 2] + 1)
    uniq, first_pos, inverse = np.unique(packed, return_index=True, return_inverse=True)
    # preserve first-appearance order like the sequential reference
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    vert_of_corner = rank[inverse].astype(np.uint32)
    rep = face_vertex[np.sort(first_pos)]  # representative (p,t,n) per new vertex

    out_positions = positions[rep[:, 0]]
    out_normals = None
    out_uvs = None
    if has_nrm:
        out_normals = np.zeros((len(rep), 3), np.float32)
        valid = (rep[:, 2] >= 0) & (rep[:, 2] < nn)
        out_normals[valid] = normals[rep[valid, 2]]
    if has_uv:
        out_uvs = np.zeros((len(rep), 2), np.float32)
        valid = (rep[:, 1] >= 0) & (rep[:, 1] < nt)
        out_uvs[valid] = uvs[rep[valid, 1]]

    # --- triangulate (quad -> (0,1,2),(0,2,3), MeshOBJ.cpp:252-262)
    corner_start = np.concatenate([[0], np.cumsum(face_sizes)[:-1]])
    tri_list = []
    obj_list = []
    c0 = vert_of_corner[corner_start]
    c1 = vert_of_corner[corner_start + 1]
    c2 = vert_of_corner[corner_start + 2]
    tri_list.append(np.stack([c0, c1, c2], axis=1))
    obj_list.append(face_obj)
    quads = face_sizes == 4
    if quads.any():
        qs = corner_start[quads]
        q0 = vert_of_corner[qs]
        q2 = vert_of_corner[qs + 2]
        q3 = vert_of_corner[qs + 3]
        quad_tris = np.stack([q0, q2, q3], axis=1)
        # interleave in face order: tri for quad i comes right after its
        # first half — rebuild by sorting emission keys
        keys_a = np.arange(nf) * 2
        keys_b = np.nonzero(quads)[0] * 2 + 1
        all_tris = np.concatenate([tri_list[0], quad_tris])
        all_objs = np.concatenate([face_obj, face_obj[quads]])
        emit = np.argsort(np.concatenate([keys_a, keys_b]), kind="stable")
        tri_idx = all_tris[emit]
        obj_ids = all_objs[emit]
    else:
        tri_idx = tri_list[0]
        obj_ids = face_obj

    mesh = MeshArrays(
        positions=out_positions,
        indices=tri_idx.reshape(-1).astype(np.uint32),
        normals=out_normals,
        uvs=out_uvs,
        triangle_obj_ids=(obj_ids + np.int32(next_object_id)).astype(np.int32),
    )
    next_id = next_object_id + int(obj_ids.max()) + 1 if len(obj_ids) else next_object_id + 1
    return mesh, next_id
