"""Plain path tracer of the course renderer's CPUOnly dialect: the
reference that the soft-shadow render cell is compared with.

``TraceRay`` of ``HW2/HW2/CPUOnly`` (``raytracer.h:215-260``), bounce by
bounce: the closest hit against every triangle (Moller-Trumbore with
``FLT_EPSILON`` as the determinant's cut-off, ties to the lower triangle
index), the sky gradient on a miss, the interpolated normal turned to
the side the face normal picks (``ray.h:76-92``), the hit point offset
along it by ``RT_EPS`` 1e-4, then ``ShadeDirect``: ambient 0.05 x albedo
plus emission, and for each light the normalised Lambert + Blinn-Phong
BRDF (``brdf.h``) x N.L x its visibility, ``ShadowVisibility``
(``raytracer.h:121-168``): for an area light ``S`` walks from the offset
point toward samples of a disk of the light's radius facing the point
(the basis of ``raytracer.h:88-93``), each blocked by any triangle on
[RT_EPS, dist - RT_EPS], the visibility their unblocked share; for a
point light one walk toward its centre.  Then the Russian-roulette split
at kd / (kd + kr) between a diffuse bounce (a uniform hemisphere sample,
throughput albedo x (kd + kr) x 2 N.L) and the perfect mirror (only
where kr > 0; throughput specular x (kd + kr), or x kr without diffuse
bounces), the early-out when every channel of the throughput is under
1e-4, and the depth limit.  The radiance is not clamped.

Departures from the C++ code, each the port's too: the random numbers
are the course's GPU stream (the uint32 LCG with its Wang-hash mix, one
stream a ray seeded from its pixel and sample index, ``tracer.py``),
where CPUOnly draws from one unseeded ``std::mt19937``; every area light
takes the most ``shadow_samples`` of any light; the disk draws advance a
ray's stream whenever it hits, its shadow walks face the light or not;
the recursion is a loop over bounces; a ray that finds no disk point in
64 rounds of rejection samples the disk's centre.

Brute force, in blocks of rays and chunks of triangles so that it fits.
Every float is computed in ``dtype``: float32 for the reference, a lower
precision for the control; no matrix product is taken, so no TF32.
"""

from __future__ import annotations

import torch

from . import tracer
from .tracer import CHUNK, INV_2PI, INV_PI, MASK, RAY_BLOCK

FLT_EPSILON = 1.1920929e-7  # the determinant's cut-off (ray.h)
RT_EPS = 1e-4  # CPUOnly's offset and window (raytracer.h:49)


def _hits(o, d, tri, tmin, tmax):
    """(R, C) t, u, v of rays ``o``, ``d`` against triangles ``tri``
    (C, 3, 3) on [tmin, tmax] (R,), t the dtype's largest where none."""
    v0 = tri[None, :, 0]
    e1, e2 = tri[None, :, 1] - v0, tri[None, :, 2] - v0
    dd, oo = d[:, None], o[:, None]
    pvec = tracer._cross(dd, e2)
    det = tracer._dot(e1, pvec)
    cut = det.abs() < FLT_EPSILON
    inv_det = 1.0 / torch.where(cut, 1.0, det)
    tvec = oo - v0
    u = tracer._dot(tvec, pvec) * inv_det
    qvec = tracer._cross(tvec, e1)
    v = tracer._dot(dd, qvec) * inv_det
    t = tracer._dot(e2, qvec) * inv_det
    ok = (~cut & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= tmin[:, None]) & (t <= tmax[:, None]))
    return torch.where(ok, t, torch.finfo(t.dtype).max), u, v


@torch.no_grad()
def closest(o, d, verts):
    """Closest hit of every ray on [RT_EPS, inf) -> (t, u, v, triangle
    index or -1)."""
    r, dev, dt = o.shape[0], o.device, o.dtype
    big = torch.finfo(dt).max
    out_t = torch.full((r,), big, dtype=dt, device=dev)
    out_u = torch.zeros(r, dtype=dt, device=dev)
    out_v = torch.zeros(r, dtype=dt, device=dev)
    out_i = torch.full((r,), -1, dtype=torch.int64, device=dev)
    for a in range(0, r, RAY_BLOCK):
        ob, db = o[a:a + RAY_BLOCK], d[a:a + RAY_BLOCK]
        n = ob.shape[0]
        tmin = torch.full((n,), RT_EPS, dtype=dt, device=dev)
        tmax = torch.full((n,), big, dtype=dt, device=dev)
        rows = torch.arange(n, device=dev)
        bt, bu = out_t[a:a + n], out_u[a:a + n]
        bv, bi = out_v[a:a + n], out_i[a:a + n]
        for c in range(0, verts.shape[0], CHUNK):
            t, u, v = _hits(ob, db, verts[c:c + CHUNK], tmin, tmax)
            ct, j = t.min(dim=1)
            better = ct < bt
            bu.copy_(torch.where(better, u[rows, j], bu))
            bv.copy_(torch.where(better, v[rows, j], bv))
            bi.copy_(torch.where(better, c + j, bi))
            bt.copy_(torch.where(better, ct, bt))
    return out_t, out_u, out_v, out_i


@torch.no_grad()
def occluded(o, d, verts, tmax):
    """Whether any triangle lies on [RT_EPS, tmax] along each ray."""
    r, dev = o.shape[0], o.device
    out = torch.zeros(r, dtype=torch.bool, device=dev)
    for a in range(0, r, RAY_BLOCK):
        ob, db = o[a:a + RAY_BLOCK], d[a:a + RAY_BLOCK]
        hi = tmax[a:a + RAY_BLOCK]
        lo = torch.full_like(hi, RT_EPS)
        for c in range(0, verts.shape[0], CHUNK):
            t = _hits(ob, db, verts[c:c + CHUNK], lo, hi)[0]
            out[a:a + ob.shape[0]] |= (t < torch.finfo(t.dtype).max).any(1)
    return out


def _unit_disk(state, dtype, rounds: int = 64):
    """``random_in_unit_disk`` (``raytracer.h:77-85``): two draws a round
    until x^2 + y^2 lies in (1e-10, 1]; (0, 0) if none is found."""
    x = torch.zeros(state.shape, dtype=dtype, device=state.device)
    y = torch.zeros_like(x)
    done = torch.zeros(state.shape, dtype=torch.bool, device=state.device)
    for _ in range(rounds):
        s1, cx = tracer.rng_next(state, dtype)
        s2, cy = tracer.rng_next(s1, dtype)
        cx, cy = 2.0 * cx - 1.0, 2.0 * cy - 1.0
        r2 = cx * cx + cy * cy
        ok = (r2 > 1e-10) & (r2 <= 1.0) & ~done
        x, y = torch.where(ok, cx, x), torch.where(ok, cy, y)
        state = torch.where(done, state, s2)
        done = done | ok
        if bool(done.all()):
            break
    return state, x, y


def scene_tensors(arrays, device, dtype) -> dict:
    """The scene arrays as tensors; only the scene's own triangles."""
    sc = tracer.scene_tensors(arrays, device, dtype)
    sc["light_radius"] = [float(r) for r in arrays.lights["radius"]]
    sc["samples"] = max(arrays.lights["shadow_samples"])
    return sc


def _visibility(sc, li, p, hit, facing, state):
    """Light ``li``'s visibility of the offset points ``p`` -> (vis,
    state): the disk draws advance the stream of every hit ray."""
    dt, verts = sc["dtype"], sc["verts"]
    lpos = sc["light_pos"][li]
    radius = sc["light_radius"][li]
    to_c = lpos - p
    dist_c = torch.sqrt(torch.clamp((to_c * to_c).sum(-1), min=1e-24))
    if radius > 0.0:
        w = -to_c / dist_c[:, None]
        use_y = (w[:, 0].abs() > 0.9)[:, None]
        axis = torch.where(use_y, torch.tensor([0.0, 1.0, 0.0], dtype=dt,
                                               device=p.device),
                           torch.tensor([1.0, 0.0, 0.0], dtype=dt,
                                        device=p.device))
        t_ax = tracer._cross(axis, w)
        t_ax = t_ax / torch.sqrt((t_ax * t_ax).sum(-1, keepdim=True))
        b_ax = tracer._cross(w, t_ax)
        targets = []
        for _ in range(sc["samples"]):
            s_d, dx, dy = _unit_disk(state, dt)
            state = torch.where(hit, s_d, state)
            targets.append(lpos + (t_ax * dx[:, None] + b_ax * dy[:, None])
                           * radius)
        targets = torch.stack(targets, dim=1)  # (R, S, 3)
    else:
        targets = lpos.expand(p.shape[0], 1, 3)
    s = targets.shape[1]
    sel = facing.nonzero().squeeze(1)
    unblocked = torch.ones(p.shape[0], s, dtype=dt, device=p.device)
    if sel.numel():
        ps = p[sel, None].expand(-1, s, 3).reshape(-1, 3)
        st = targets[sel].reshape(-1, 3) - ps
        d_s = torch.sqrt(torch.clamp((st * st).sum(-1), min=1e-24))
        blocked = occluded(ps, st * (1.0 / d_s)[:, None], verts,
                           d_s - RT_EPS)
        unblocked[sel] = torch.where(blocked, 0.0, 1.0).to(dt).reshape(-1, s)
    return unblocked.sum(-1) / float(s), state


def _bounce(sc, o, d, tp, rad, state):
    """One bounce of live rays -> (o, d, tp, rad, state, alive)."""
    dt, verts = sc["dtype"], sc["verts"]
    t, u, v, idx = closest(o, d, verts)
    hit = idx >= 0
    safe = torch.clamp(idx, min=0)
    tri, tn = verts[safe], sc["normals"][safe]

    # the shading normal: the interpolation, turned to the face's side
    uu, vv = u[:, None], v[:, None]
    interp = (1.0 - uu - vv) * tn[:, 0] + uu * tn[:, 1] + vv * tn[:, 2]
    geom = tracer._cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    side = torch.where(tracer._dot(d, geom) < 0.0, 1.0, -1.0).to(dt)
    len_sq = tracer._dot(interp, interp)
    n = interp * (side / torch.sqrt(torch.clamp(len_sq, min=1e-24)))[:, None]
    p = o + t[:, None] * d + n * RT_EPS
    p = torch.where(hit[:, None], p, 1e30)
    m = int(sc["mats"]["kd"].shape[0])
    obj = torch.clamp(sc["obj"][safe], 0, m - 1)
    mat = {k: a[obj] for k, a in sc["mats"].items()}

    # ShadeDirect
    view = -d
    ndotv = torch.clamp(tracer._dot(n, view), min=0.0)
    direct = mat["albedo"] * 0.05 + mat["emission"]
    for li in range(sc["light_pos"].shape[0]):
        to_l = sc["light_pos"][li] - p
        dist = torch.sqrt(torch.clamp((to_l * to_l).sum(-1), min=1e-24))
        ldir = to_l / dist[:, None]
        ndotl = torch.clamp(tracer._dot(n, ldir), min=0.0)
        lit = (ndotl > 0.0) & (ndotv > 0.0)
        vis, state = _visibility(sc, li, p, hit, hit & lit, state)
        half = ldir + view
        hlen = torch.sqrt(torch.clamp(tracer._dot(half, half), min=1e-38))
        ndoth = torch.clamp(tracer._dot(n, half) / hlen, min=0.0)
        shin = mat["shininess"]
        lobe = torch.pow(ndoth, shin) * ((shin + 2.0) * INV_2PI * mat["ks"])
        brdf = (mat["albedo"] * (mat["kd"] * INV_PI)[:, None]
                + mat["specular_color"] * lobe[:, None])
        radiance = sc["light_col"][li] * sc["light_int"][li]
        scale = torch.where(lit, ndotl * vis, 0.0)
        direct = direct + scale[:, None] * radiance * brdf

    # the sky gradient on a miss (raytracer.h:226-229)
    sky_t = (0.5 * (d[:, 2] + 1.0))[:, None]
    sky = (1.0 - sky_t) + sky_t * torch.tensor([0.5, 0.7, 1.0], dtype=dt,
                                               device=d.device)
    rad = rad + tp * torch.where(hit[:, None], direct, sky)

    # the Russian-roulette split (raytracer.h:236-256)
    kd, kr = mat["kd"], mat["kr"]
    total = kd + kr
    can = hit & (total > 0.0)
    s_xi, xi = tracer.rng_next(state, dt)
    state = torch.where(can, s_xi, state)
    if sc["diffuse"]:
        take_diffuse = can & (xi < kd / torch.where(total > 0, total, 1.0))
    else:
        take_diffuse = torch.zeros_like(can)
    take_mirror = can & ~take_diffuse & (kr > 0.0)
    hemi = n.clone()
    sel = take_diffuse.nonzero().squeeze(1)
    if sel.numel():
        s_h, h_sel = tracer._hemisphere(n[sel], state[sel], dt)
        state = state.index_put((sel,), s_h)
        hemi = hemi.index_put((sel,), h_sel)
    ndotl_h = torch.clamp(tracer._dot(n, hemi), min=0.0)
    diff_tp = mat["albedo"] * (total * (2.0 * ndotl_h))[:, None]
    mirror_tp = mat["specular_color"] * (total if sc["diffuse"]
                                         else kr)[:, None]
    refl = d - 2.0 * tracer._dot(d, n)[:, None] * n
    bounced = take_diffuse | take_mirror
    new_tp = torch.where(take_diffuse[:, None], tp * diff_tp, tp * mirror_tp)
    o = torch.where(bounced[:, None], p, o)
    d = torch.where(bounced[:, None],
                    torch.where(take_diffuse[:, None], hemi, refl), d)
    tp = torch.where(bounced[:, None], new_tp, tp)
    alive = bounced & ~(tp < 1e-4).all(dim=-1)
    return o, d, tp, rad, state, alive


def trace(sc, o, d, seeds):
    """Radiance (R, 3) of rays ``o``, ``d`` with uint32 ``seeds``; each
    bounce traces the rays still alive."""
    r, dev, dt = o.shape[0], o.device, sc["dtype"]
    carry = [o.clone(), d.clone(), torch.ones(r, 3, dtype=dt, device=dev),
             torch.zeros(r, 3, dtype=dt, device=dev), seeds & MASK]
    live = torch.arange(r, device=dev)
    for _ in range(sc["max_bounces"]):
        if live.numel() == 0:
            break
        out = _bounce(sc, *(c[live] for c in carry))
        for c, new in zip(carry, out[:5]):
            c[live] = new
        live = live[out[5]]
    return carry[3]


def pixels(arrays, samples, jitter: str, device, dtype=torch.float32,
           block: int = 16384) -> torch.Tensor:
    """Radiance (N, 3) float32 on the host of ``samples`` (int64 (N, 3):
    sample index, x, y) at ``jitter`` ("center" or "wang"), computed in
    ``dtype``."""
    if jitter not in ("center", "wang"):
        raise ValueError(f"the CPUOnly dialect takes center or wang jitter, "
                         f"not {jitter!r}")
    sc = scene_tensors(arrays, device, dtype)
    out = []
    with torch.no_grad():
        for a in range(0, samples.shape[0], block):
            s, x, y = samples[a:a + block].to(device).unbind(1)
            o, d, seeds = tracer.pixel_rays(sc, x, y, s, jitter)
            out.append(trace(sc, o, d, seeds).float().cpu())
    return torch.cat(out) if out else torch.zeros(0, 3)


