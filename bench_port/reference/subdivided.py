"""Reference of the subdivided-mesh cells: a configuration's scene as the
benchmark's own loader reads it (``scene.build``), its triangles
subdivided ``subdivide_levels`` times by this file's own code, and the
sampled pixels traced by brute force (``tracer.py``).

The subdivision follows the description of the program's
``scene/subdivide.py``, not its code.  Each level splits every triangle
(v0, v1, v2) at its edge midpoints, each ``(a + b) * 0.5`` in float32,
into four coplanar children in parent-major order: corner 0 (v0, m01,
m02), corner 1 (m01, v1, m12), corner 2 (m02, m12, v2), the centre (m01,
m12, m02).  The vertex normals split alike, averaged and left
unnormalised (the tracer normalises the interpolated normal), and each
child keeps its parent's object id.  So a triangle's index, and with it
the tracer's rule that a tie goes to the lower index, is the program's
global triangle id.  The soup is padded again to a multiple of 512.

Departures from ``render_frames.pixels``, none of which changes a ray's
result: each bounce is traced for the rays still alive only (a ray's
computation is its own, and a dead ray's radiance and random state do
not change); and a pass over few rays tests more triangles a chunk, so
that a chunk keeps the tracer's ``RAY_BLOCK`` x ``CHUNK`` pairs (the
closest hit within a chunk is its first minimum and across chunks a
strictly smaller t, so a tie goes to the lower index at any chunk
size).  At 1.27M triangles the tracer's fixed chunks would make each
bounce of a few rays thousands of small launches.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from . import scene, tracer

# (ray, triangle) pairs of one of the tracer's chunks
PAIRS = tracer.RAY_BLOCK * tracer.CHUNK


def subdivide(vertices, normals, obj_id, levels: int):
    """(T, 3, 3) triangles and vertex normals and (T,) object ids, split
    ``levels`` times -> the 4^levels T children, parent-major."""
    v = np.asarray(vertices, np.float32)
    n = np.asarray(normals, np.float32)
    o = np.asarray(obj_id, np.int32)
    half = np.float32(0.5)

    def split(x):
        a, b, c = x[:, 0], x[:, 1], x[:, 2]
        ab, bc, ac = (a + b) * half, (b + c) * half, (a + c) * half
        return np.stack([a, ab, ac, ab, b, bc, ac, bc, c, ab, bc, ac],
                        axis=1).reshape(-1, 3, 3)

    for _ in range(int(levels)):
        v, n, o = split(v), split(n), np.repeat(o, 4)
    return v, n, o


def build(cfg: dict, settings: dict, root: str) -> scene.SceneArrays:
    """``scene.build`` of ``cfg`` with its triangles subdivided
    ``cfg["subdivide_levels"]`` times."""
    arrays = scene.build(cfg, settings, root)
    t = arrays.num_triangles
    v, n, o = subdivide(arrays.vertices[:t], arrays.normals[:t],
                        arrays.obj_id[:t], cfg["subdivide_levels"])
    total = v.shape[0]
    pad = -(-total // scene.PAD) * scene.PAD - total
    return dataclasses.replace(
        arrays, num_triangles=total,
        vertices=np.ascontiguousarray(np.concatenate(
            [v, np.broadcast_to(v[0, 0], (pad, 3, 3))]), np.float32),
        normals=np.ascontiguousarray(np.concatenate(
            [n, np.zeros((pad, 3, 3), np.float32)]), np.float32),
        obj_id=np.concatenate([o, np.full(pad, -1, np.int32)]))


@contextlib.contextmanager
def _chunks_for(rays: int):
    """The tracer's triangles a chunk, while a pass over ``rays`` rays
    runs: whole multiples of its own chunk, ``PAIRS`` pairs a chunk."""
    base = tracer.CHUNK
    tracer.CHUNK = max(1, PAIRS // max(int(rays), 1) // base) * base
    try:
        yield
    finally:
        tracer.CHUNK = base


def trace(sc, o, d, seeds):
    """``tracer.trace``, each bounce given the rays still alive."""
    r, dev, dt = o.shape[0], o.device, sc["dtype"]
    carry = (o, d, torch.ones(r, 3, dtype=dt, device=dev),
             torch.zeros(r, 3, dtype=dt, device=dev), seeds & tracer.MASK,
             torch.ones(r, dtype=torch.bool, device=dev))
    for _ in range(sc["max_bounces"]):
        live = carry[5].nonzero().squeeze(1)
        if not live.numel():
            break
        with _chunks_for(live.numel()):
            out = tracer._bounce(sc, *(c[live] for c in carry))
        carry = tuple(c.index_put((live,), x) for c, x in zip(carry, out))
    return torch.clamp(carry[3], 0.0, 1.0)


def pixels(arrays, samples, jitter: str, device, dtype=torch.float32,
           block: int = tracer.RAY_BLOCK) -> torch.Tensor:
    """Radiance (N, 3) float32 on the host of ``samples`` (int64 (N, 3):
    sample index, x, y), computed in ``dtype``."""
    sc = tracer.scene_tensors(arrays, device, dtype)
    out = []
    with torch.no_grad():
        for a in range(0, samples.shape[0], block):
            s, x, y = samples[a:a + block].to(device).unbind(1)
            o, d, seeds = tracer.pixel_rays(sc, x, y, s, jitter)
            out.append(trace(sc, o, d, seeds).float().cpu())
    return torch.cat(out)
