"""Plain path tracer of the course renderer's gpu dialect: the reference
that the render and training cells are compared with.

``TraceRayIterative`` (``GPUandCPU/include/query.h:156-220``): per bounce
the closest hit against every triangle (Moller-Trumbore, ties to the
lower triangle index), the miss colour, the shading frame, direct light
from each point light with one hard shadow ray (``shader.h:44-110``,
normalised Lambert + Blinn-Phong, ``brdf.h``), then the Russian-roulette
split between a diffuse bounce (a uniform hemisphere sample) and the
mirror, the throughput update and the early-out; the radiance is clamped
to [0, 1].  The random numbers are the reference's uint32 LCG with its
Wang-hash mix, held in int64.

Brute force, in blocks of rays and chunks of triangles so that it fits.
Every float is computed in ``dtype``: float32 for the reference, a lower
precision for the control.  For training, ``trace`` differentiates
through the winners' triangles, the materials and the light intensity;
the winners themselves and the shadow tests carry no gradient.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
DET_EPS = 1e-8
TMIN = 1e-4
EPS = 1e-3  # the shadow and bounce offset of the gpu dialect (shader.h:22)
INV_PI = 0.31830988618
INV_2PI = 0.15915494309
CHUNK = 512
RAY_BLOCK = 32768


# --- random numbers (query.h:32-71, antialias.h:30-37) ---------------------

def _mix(h):
    h = (h ^ 61) ^ (h >> 16)
    h = (h * 9) & MASK
    h = h ^ (h >> 4)
    h = (h * 0x27D4EB2D) & MASK
    return h ^ (h >> 15)


def _lcg(s):
    return (s * 1664525 + 1013904223) & MASK


def _unit(h, dtype):
    return h.to(dtype) * 2.0 ** -32


def rng_next(state, dtype):
    state = _lcg(state)
    return state, _unit(_mix(state), dtype)


def make_seed(x, y, s):
    return (((x & MASK) * 73856093) & MASK) ^ (((y & MASK) * 19349663) & MASK) \
        ^ (((s & MASK) * 83492791) & MASK)


def wang_jitter(x, y, s, dtype):
    h = make_seed(x, y, s)
    return _unit(_mix(h), dtype) - 0.5, _unit(_mix(_lcg(h)), dtype) - 0.5


def mt19937_offset(seed: int = 42):
    """The first sample's (jx, jy) of ``std::mt19937(seed)`` through
    ``uniform_real_distribution<float>`` (``query.cu:137-146``), centred."""
    draws = np.random.RandomState(seed).randint(0, 2 ** 32, size=2,
                                                dtype=np.uint32)
    off = (draws.astype(np.float64) * 2.0 ** -32).astype(np.float32)
    return off - np.float32(0.5)


def _hemisphere(normal, state, dtype, rounds: int = 64):
    vec = torch.zeros(normal.shape, dtype=dtype, device=normal.device)
    done = torch.zeros(state.shape, dtype=torch.bool, device=state.device)
    for _ in range(rounds):
        s1, x = rng_next(state, dtype)
        s2, y = rng_next(s1, dtype)
        s3, z = rng_next(s2, dtype)
        x, y, z = 2.0 * x - 1.0, 2.0 * y - 1.0, 2.0 * z - 1.0
        lensq = x * x + y * y + z * z
        ok = (lensq > 1e-10) & (lensq <= 1.0)
        inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-10))
        cand = torch.stack([x * inv, y * inv, z * inv], dim=-1)
        vec = torch.where((ok & ~done)[:, None], cand, vec)
        state = torch.where(done, state, s3)
        done = done | ok
        if bool(done.all()):
            break
    flip = (vec * normal).sum(dim=-1, keepdim=True) > 0.0
    return state, torch.where(flip, vec, -vec)


# --- geometry -----------------------------------------------------------------

def _cross(a, b):
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _unitv(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(dim=-1, keepdim=True),
                                      min=1e-24))


def _tuv(o, d, v0, e1, e2):
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / torch.where(det.abs() < DET_EPS, 1.0, det)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    return t, u, v, det.abs() >= DET_EPS


def _chunk_ok(o, d, tri, tmin, tmax):
    v0 = tri[None, :, 0]
    t, u, v, det_ok = _tuv(o[:, None], d[:, None], v0, tri[None, :, 1] - v0,
                           tri[None, :, 2] - v0)
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= tmin[:, None]) & (t <= tmax[:, None]))
    return t, u, v, ok


@torch.no_grad()
def closest(o, d, verts):
    """Closest hit of every ray -> (t, u, v, triangle index or -1)."""
    r, dev, dt = o.shape[0], o.device, o.dtype
    big = torch.finfo(dt).max  # no hit
    out_t = torch.full((r,), big, dtype=dt, device=dev)
    out_u = torch.zeros(r, dtype=dt, device=dev)
    out_v = torch.zeros(r, dtype=dt, device=dev)
    out_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    for a in range(0, r, RAY_BLOCK):
        ob, db = o[a:a + RAY_BLOCK], d[a:a + RAY_BLOCK]
        n = ob.shape[0]
        tmin = torch.full((n,), TMIN, dtype=dt, device=dev)
        tmax = torch.full((n,), big, dtype=dt, device=dev)
        bt, bu, bv = out_t[a:a + n], out_u[a:a + n], out_v[a:a + n]
        bi = out_i[a:a + n]
        rows = torch.arange(n, device=dev)
        for c in range(0, verts.shape[0], CHUNK):
            t, u, v, ok = _chunk_ok(ob, db, verts[c:c + CHUNK], tmin, tmax)
            t = torch.where(ok, t, big)
            ct, j = t.min(dim=1)
            better = ct < bt
            bu.copy_(torch.where(better, u[rows, j], bu))
            bv.copy_(torch.where(better, v[rows, j], bv))
            bi.copy_(torch.where(better, c + j, bi))
            bt.copy_(torch.where(better, ct, bt))
    return out_t, out_u, out_v, out_i


@torch.no_grad()
def occluded(o, d, verts, tmin, tmax):
    r, dev = o.shape[0], o.device
    out = torch.zeros(r, dtype=torch.bool, device=dev)
    for a in range(0, r, RAY_BLOCK):
        ob, db = o[a:a + RAY_BLOCK], d[a:a + RAY_BLOCK]
        lo, hi = tmin[a:a + RAY_BLOCK], tmax[a:a + RAY_BLOCK]
        for c in range(0, verts.shape[0], CHUNK):
            ok = _chunk_ok(ob, db, verts[c:c + CHUNK], lo, hi)[3]
            out[a:a + ob.shape[0]] |= ok.any(dim=1)
    return out


def _passthrough(a, b):
    return a + (b - b.detach())


def _brdf(mat, n, v, l):
    ndotl = torch.clamp((n * l).sum(dim=-1), min=0.0)
    ndotv = torch.clamp((n * v).sum(dim=-1), min=0.0)
    lit = (ndotl > 0.0) & (ndotv > 0.0)
    fd = mat["albedo"] * (mat["kd"] * INV_PI)[:, None]
    h = _unitv(l + v)
    ndoth = torch.clamp((n * h).sum(dim=-1), min=0.0)
    spec_norm = (mat["shininess"] + 2.0) * INV_2PI
    pos = ndoth > 0.0
    lobe = spec_norm * torch.where(
        pos, torch.pow(torch.where(pos, ndoth, 1.0), mat["shininess"]), 0.0)
    fs = mat["specular_color"] * (mat["ks"] * lobe)[:, None]
    return torch.where(lit[:, None], fd + fs, 0.0)


def scene_tensors(arrays, device, dtype, params=None) -> dict:
    """The scene arrays as tensors; ``params`` (``albedo``,
    ``light_intensity``, ``vertices``) replace their fields.  Only the
    scene's own triangles are tested, never the soup's padding."""
    def f(a):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    params = params or {}
    n = arrays.num_triangles
    mats = {k: f(v) for k, v in arrays.materials.items()}
    if "albedo" in params:
        mats["albedo"] = params["albedo"].to(dtype)
    return dict(
        verts=(params["vertices"].to(dtype) if "vertices" in params
               else f(arrays.vertices))[:n],
        normals=f(arrays.normals)[:n],
        obj=torch.as_tensor(arrays.obj_id[:n], device=device).long(),
        mats=mats,
        light_pos=f(arrays.lights["position"]),
        light_col=f(arrays.lights["color"]),
        light_int=(params["light_intensity"].to(dtype)
                   if "light_intensity" in params
                   else f(arrays.lights["intensity"])),
        miss=f(arrays.miss_color),
        cam={k: f(arrays.camera[k]) for k in ("center", "pixel00", "du", "dv")},
        max_bounces=arrays.max_bounces, diffuse=arrays.diffuse_bounce,
        dtype=dtype)


def camera_rays(sc, px, py):
    """Rays through fractional pixel coordinates (``camera.h:49-53``)."""
    cam = sc["cam"]
    pos = cam["pixel00"] + px[:, None] * cam["du"] + py[:, None] * cam["dv"]
    d = pos - cam["center"]
    d = d / torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                       + d[:, 2] * d[:, 2])[:, None]
    return torch.broadcast_to(cam["center"], d.shape), d


def _bounce(sc, o, d, tp, rad, state, alive):
    dt = sc["dtype"]
    verts = sc["verts"]
    r = o.shape[0]
    o = torch.where(alive[:, None], o, 1e30)
    t, u, v, idx = closest(o.detach(), d.detach(), verts.detach())
    hit = idx >= 0
    safe = torch.clamp(idx, min=0)
    tri = verts[safe]
    tn = sc["normals"][safe]
    v0 = tri[:, 0]
    t2, u2, v2, _ = _tuv(o, d, v0, tri[:, 1] - v0, tri[:, 2] - v0)
    t, u, v = _passthrough(t, t2), _passthrough(u, u2), _passthrough(v, v2)
    found = hit & alive

    missed = alive & ~hit
    rad = rad + torch.where(missed[:, None],
                            tp * torch.broadcast_to(sc["miss"], (r, 3)), 0.0)

    # the shading frame (query.h:111-126)
    uu, vv = u[:, None], v[:, None]
    p = o + t[:, None] * d
    interp = (1.0 - uu - vv) * tn[:, 0] + uu * tn[:, 1] + vv * tn[:, 2]
    geom = _cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    geom_n = geom / torch.clamp(torch.sqrt(_dot(geom, geom))[:, None],
                                min=1e-20)
    front = _dot(d, geom_n) < 0.0
    oriented = torch.where(front[:, None], geom_n, -geom_n)
    len_sq = _dot(interp, interp)[:, None]
    shade_n = interp / torch.sqrt(torch.clamp(len_sq, min=1e-24))
    shade_n = torch.where(len_sq < 1e-12, oriented, shade_n)
    n = torch.where(_dot(shade_n, oriented)[:, None] < 0.0, -shade_n, shade_n)
    p = torch.where(found[:, None], p, 1e30)
    m = int(sc["mats"]["kd"].shape[0])
    obj = torch.clamp(sc["obj"][safe], 0, m - 1)
    mat = {k: a[obj] for k, a in sc["mats"].items()}

    # direct light, one hard shadow ray a light (shader.h:44-110)
    view = _unitv(o - p)
    n_unit = _unitv(n)
    direct = mat["albedo"] * 0.05 + mat["emission"]
    for li in range(sc["light_pos"].shape[0]):
        to_l = sc["light_pos"][li] - p
        dist = torch.sqrt(torch.clamp((to_l * to_l).sum(dim=-1), min=1e-24))
        ldir = to_l / dist[:, None]
        ndotl = torch.clamp((n_unit * ldir).sum(dim=-1), min=0.0)
        blocked = occluded((p + n_unit * EPS).detach(), ldir.detach(), verts.detach(),
                           torch.full_like(dist, TMIN).detach(), dist.detach())
        vis = torch.where(blocked, 0.0, 1.0).to(dt)
        f = _brdf(mat, n_unit, view, ldir)
        radiance = sc["light_col"][li] * sc["light_int"][li]
        contrib = radiance * f * (ndotl * vis)[:, None]
        direct = direct + torch.where((ndotl > 0.0)[:, None], contrib, 0.0)
    rad = rad + torch.where(found[:, None], tp * direct, 0.0)

    # the Russian-roulette split (query.h:188-212)
    kd, kr = mat["kd"], mat["kr"]
    total = kd + kr
    can = found & (total > 0.0)
    s_xi, xi = rng_next(state, dt)
    state = torch.where(can, s_xi, state)
    if sc["diffuse"]:
        take_diffuse = can & (xi < kd / torch.where(total > 0, total, 1.0))
        n_det = n_unit.detach()
        hemi = n_det.clone()
        sel = take_diffuse.nonzero().squeeze(1)
        if sel.numel():
            s_h, h_sel = _hemisphere(n_det[sel], state[sel], dt)
            state = state.index_put((sel,), s_h)
            hemi = hemi.index_put((sel,), h_sel)
        ndotl = torch.clamp((n_unit * hemi).sum(dim=-1), min=0.0)
        diff_tp = mat["albedo"] * (2.0 * ndotl)[:, None]
    else:
        take_diffuse = torch.zeros_like(can)
        hemi = n_unit
        diff_tp = torch.ones_like(mat["albedo"])
    take_mirror = can & ~take_diffuse
    d_unit = _unitv(d)
    dn = d_unit * n_unit  # vec3.h's dot: (x + y) + z
    refl = d_unit - 2.0 * (dn[:, 0] + dn[:, 1] + dn[:, 2])[:, None] * n_unit
    mirror_tp = mat["specular_color"] * kr[:, None]
    new_dir = torch.where(take_diffuse[:, None], hemi, refl)
    new_org = p + n_unit * EPS
    scale = torch.where(take_diffuse[:, None], diff_tp,
                        torch.where(take_mirror[:, None], mirror_tp, 1.0))
    bounced = take_diffuse | take_mirror
    o = torch.where(bounced[:, None], new_org, o)
    d = torch.where(bounced[:, None], new_dir, d)
    tp = torch.where(bounced[:, None], tp * scale, tp)
    alive = bounced & ~(tp < 1e-4).all(dim=-1)
    return o, d, tp, rad, state, alive


def trace(sc, o, d, seeds):
    """Radiance (R, 3) of rays ``o``, ``d`` with uint32 ``seeds``."""
    r, dev, dt = o.shape[0], o.device, sc["dtype"]
    carry = (o, d, torch.ones(r, 3, dtype=dt, device=dev),
             torch.zeros(r, 3, dtype=dt, device=dev), seeds & MASK,
             torch.ones(r, dtype=torch.bool, device=dev))
    for _ in range(sc["max_bounces"]):
        if not bool(carry[5].any()):
            break
        carry = _bounce(sc, *carry)
    return torch.clamp(carry[3], 0.0, 1.0)


def pixel_rays(sc, x, y, s, jitter: str):
    """Camera rays and seeds of pixels ``x``, ``y`` at sample indices ``s``
    (int64): ``wang`` jitter (``query.cu:36-43``), ``reference_cpu`` (the
    first mt19937(42) offset, shared by every pixel: the sample index is
    at most spp - 1 = 0) or ``center``."""
    dt = sc["dtype"]
    if jitter == "wang":
        jx, jy = wang_jitter(x, y, s, dt)
    elif jitter == "reference_cpu":
        off = mt19937_offset(42)
        jx, jy = float(off[0]), float(off[1])
    elif jitter == "center":
        jx = jy = 0.5
    else:
        raise ValueError(f"unknown jitter {jitter!r}")
    o, d = camera_rays(sc, x.to(dt) + jx, y.to(dt) + jy)
    return o, d, make_seed(x, y, s)
