"""The benchmark's own scene loader: a configuration file and the OBJ files
it names -> plain numpy arrays.

It reads the same raw files as the program under test but shares no code
with it: OBJ parsing (``v``, ``vn``, ``f`` with triangles and quads, negative
indices, ``o``/``g`` object tags), the transform (scale, rotate X then Y
then Z in degrees, translate, in float64), the triangle soup padded to a
multiple of 512 with point triangles at the first vertex, the material and
light tables and the pinhole camera frame (float64 on the host, stored as
float32), all in the gpu dialect of the course renderer
(``GPUandCPU/include/scene.h``, ``camera.h``, ``MeshOBJ.h``).
"""

from __future__ import annotations

import dataclasses
import os
from fractions import Fraction

import numpy as np

PAD = 512
MATERIAL_DEFAULTS = dict(albedo=(0.8, 0.8, 0.8), kd=1.0,
                         specular_color=(0.04, 0.04, 0.04), ks=0.0,
                         shininess=32.0, kr=0.0, emission=(0.0, 0.0, 0.0))


@dataclasses.dataclass
class SceneArrays:
    vertices: np.ndarray  # (T, 3, 3) float32, T a multiple of 512
    normals: np.ndarray  # (T, 3, 3) float32
    obj_id: np.ndarray  # (T,) int32, -1 on padding
    num_triangles: int
    materials: dict  # field -> (M, ...) float32
    lights: dict  # position (L, 3), color (L, 3), intensity (L,)
    camera: dict  # center, pixel00, du, dv (3,) float32; width, height
    miss_color: np.ndarray  # (3,) float32
    max_bounces: int
    diffuse_bounce: bool


def _f32(tokens) -> np.ndarray:
    """Decimal strings -> float32, each rounded once from its exact value,
    as ``strtof`` rounds: a double that lands on a float32 midpoint is
    decided from the exact decimal."""
    text = np.asarray(tokens, dtype=str)
    d = text.astype(np.float64)
    f = d.astype(np.float32)
    g = np.nextafter(f, np.where(d > f, np.inf, -np.inf).astype(np.float32))
    mid = (f.astype(np.float64) + g.astype(np.float64)) / 2
    for i in zip(*np.nonzero((d == mid) & (f != d))):
        exact = Fraction(str(text[i]))
        lo, hi = sorted((f[i], g[i]))
        gap = (exact - Fraction(float(lo))) - (Fraction(float(hi)) - exact)
        even = lo if int(lo.view(np.int32)) % 2 == 0 else hi
        f[i] = lo if gap < 0 else hi if gap > 0 else even
    return f


def _obj(path: str, next_id: int):
    """(positions (T, 3, 3), normals (T, 3, 3) or None, object ids (T,),
    next object id) of one OBJ file."""
    pos, nrm, faces, ids = [], [], [], []
    has_nrm = False
    current, tagged = next_id, False
    with open(path, errors="replace") as f:
        for line in f:
            s = line.strip()
            if not s or s[0] == "#":
                continue
            tag, _, rest = s.partition(" ")
            if s[0] in ("o", "g"):
                # the first tag names the object unless faces came before
                if tagged or faces:
                    next_id += 1
                    current = next_id
                tagged = True
            elif tag == "v":
                pos.append(rest.split()[:3])
            elif tag == "vn":
                nrm.append(rest.split()[:3])
                has_nrm = True
            elif tag == "f":
                corners = []
                for tok in rest.split()[:4]:
                    parts = tok.split("/")
                    p = int(parts[0])
                    p = len(pos) + p if p < 0 else p - 1
                    n = -1
                    if len(parts) >= 3 and parts[2]:
                        has_nrm = True
                        n = int(parts[2])
                        n = len(nrm) + n if n < 0 else n - 1
                    corners.append((p, n))
                tris = [corners[:3]]
                if len(corners) == 4:
                    tris.append([corners[0], corners[2], corners[3]])
                for tri in tris:
                    faces.append(tri)
                    ids.append(current)
    pos = _f32(pos)
    nrm_arr = _f32(nrm).reshape(-1, 3)
    p_idx = np.array([[c[0] for c in t] for t in faces], np.int64)
    n_idx = np.array([[c[1] for c in t] for t in faces], np.int64)
    tri = pos[p_idx]
    normals = None
    if has_nrm:
        ok = (n_idx >= 0) & (n_idx < len(nrm_arr))
        normals = np.where(ok[..., None], nrm_arr[np.clip(n_idx, 0, None)]
                           if len(nrm_arr) else 0.0, 0.0).astype(np.float32)
    return tri, normals, np.asarray(ids, np.int32), next_id + 1


def _rotation(deg) -> np.ndarray:
    rx, ry, rz = np.deg2rad(np.asarray(deg, np.float64))
    mx = np.array([[1, 0, 0], [0, np.cos(rx), -np.sin(rx)],
                   [0, np.sin(rx), np.cos(rx)]])
    my = np.array([[np.cos(ry), 0, np.sin(ry)], [0, 1, 0],
                   [-np.sin(ry), 0, np.cos(ry)]])
    mz = np.array([[np.cos(rz), -np.sin(rz), 0], [np.sin(rz), np.cos(rz), 0],
                   [0, 0, 1]])
    return mz @ my @ mx


def _transform(tri, normals, tr: dict):
    pos = np.asarray(tr.get("position", (0, 0, 0)), np.float32)
    rot = np.asarray(tr.get("rotation", (0, 0, 0)), np.float32)
    scale = np.asarray(tr.get("scale", (1, 1, 1)), np.float32)
    r = _rotation(rot)
    p = tri.astype(np.float64) * scale.astype(np.float64)
    tri = (p @ r.T + pos.astype(np.float64)).astype(np.float32)
    if normals is not None:
        s = scale.astype(np.float64)
        inv = np.where(np.abs(s) >= 1e-12, 1.0 / np.where(s == 0, 1, s), 0.0)
        n = (normals.astype(np.float64) * inv) @ r.T
        len_sq = np.sum(n * n, axis=-1, keepdims=True)
        n = np.where(len_sq > 1e-12, n / np.sqrt(np.maximum(len_sq, 1e-300)),
                     [0.0, 0.0, 1.0])
        normals = n.astype(np.float32)
    return tri, normals


def _camera(c: dict, width: int, height: int) -> dict:
    center = np.asarray(c["position"], np.float64)
    look_at = np.asarray(c["look_at"], np.float64)
    up = np.asarray(c.get("up", (0, 0, 1)), np.float64)

    def unit_or(v):
        n = float(np.sqrt(np.dot(v, v)))
        return np.array([0.0, 0.0, 1.0]) if n < 1e-12 else v / n

    forward = unit_or(look_at - center)
    right = unit_or(np.cross(forward, up))
    up2 = np.cross(right, forward)
    vh = float(c.get("sensor_height_mm", 24.0)) / 1000.0
    vw = vh * (float(width) / float(height))
    vu, vv = vw * right, -vh * up2
    du, dv = vu / float(width), vv / float(height)
    corner = (center + float(c["focal_length_mm"]) / 1000.0 * forward
              - 0.5 * vu - 0.5 * vv)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(center=f32(center), pixel00=f32(corner + 0.5 * (du + dv)),
                du=f32(du), dv=f32(dv), width=int(width), height=int(height))


def screen_box(arrays: SceneArrays):
    """(x0, y0, x1, y1), the pixels that the scene's triangles project to,
    inclusive; the whole frame where a vertex lies behind the camera."""
    cam = arrays.camera
    w, h = cam["width"], cam["height"]
    c = cam["center"].astype(np.float64)
    du, dv = cam["du"].astype(np.float64), cam["dv"].astype(np.float64)
    corner = cam["pixel00"].astype(np.float64) - c
    normal = np.cross(du, dv)
    r = arrays.vertices[:arrays.num_triangles].reshape(-1, 3) - c
    depth = r @ normal / (corner @ normal)
    if not (depth > 0).all():
        return 0, 0, w - 1, h - 1
    q = r / depth[:, None] - corner
    x, y = q @ du / (du @ du), q @ dv / (dv @ dv)
    return (max(0, int(np.floor(x.min()))), max(0, int(np.floor(y.min()))),
            min(w - 1, int(np.ceil(x.max()))), min(h - 1, int(np.ceil(y.max()))))


def build(cfg: dict, settings: dict, root: str) -> SceneArrays:
    """``cfg``: a configuration file's contents (the course's gpu scene
    JSON with ``scene_dir``, the directory its mesh paths start from,
    relative to ``root``); ``settings``: the traffic's ``max_bounces`` and
    ``diffuse_bounce``."""
    if cfg.get("dialect", "gpu") != "gpu":
        raise ValueError("the reference renders the gpu dialect only")
    scene_dir = os.path.join(root, cfg["scene_dir"])
    tris, norms, ids, mats = [], [], [], []
    next_id = 0
    for node in cfg["scene"]:
        first = next_id
        tri, nrm, oid, next_id = _obj(
            os.path.join(scene_dir, node["path"]), next_id)
        tri, nrm = _transform(tri, nrm, node.get("transform", {}))
        tris.append(tri)
        norms.append(nrm)
        ids.append(oid)
        mat = {**MATERIAL_DEFAULTS, **node.get("material", {})}
        mats += [mat] * (next_id - first)
    tri = np.concatenate(tris)
    if any(n is None for n in norms) and not all(n is None for n in norms):
        norms = [np.zeros_like(t) if n is None else n
                 for t, n in zip(tris, norms)]
    nrm = (np.zeros_like(tri) if norms[0] is None
           else np.concatenate(norms))
    oid = np.concatenate(ids)
    t = tri.shape[0]
    padded = max(-(-t // PAD) * PAD, PAD)
    if padded > t:
        tri = np.concatenate([tri, np.broadcast_to(tri[0, 0], (padded - t, 3, 3))])
        nrm = np.concatenate([nrm, np.zeros((padded - t, 3, 3), np.float32)])
        oid = np.concatenate([oid, np.full(padded - t, -1, np.int32)])
    cam = cfg["camera"]
    lights = cfg.get("lights") or [cfg["light"]]
    return SceneArrays(
        vertices=np.ascontiguousarray(tri, np.float32),
        normals=np.ascontiguousarray(nrm, np.float32),
        obj_id=oid.astype(np.int32), num_triangles=t,
        materials={k: np.array([m[k] for m in mats], np.float32)
                   for k in MATERIAL_DEFAULTS},
        lights=dict(
            position=np.array([l["position"] for l in lights], np.float32),
            color=np.array([l.get("color", (1, 1, 1)) for l in lights],
                           np.float32),
            # the gpu dialect truncates the intensity (scene.h:315)
            intensity=np.array([float(int(l.get("intensity", 1.0)))
                                for l in lights], np.float32)),
        camera=_camera(cam, cam["pixel_width"], cam["pixel_height"]),
        miss_color=np.asarray(cfg.get("miss_color", (0, 0, 0)), np.float32),
        max_bounces=max(1, int(settings["max_bounces"])),
        diffuse_bounce=bool(settings["diffuse_bounce"]))
