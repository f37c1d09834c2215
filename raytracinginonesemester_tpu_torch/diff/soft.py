"""Edge-aware differentiable rendering: soft visibility and soft depth.

PyTorch port of ``raytracinginonesemester_tpu.diff.soft``.  The hard
renderer's pixel is a step function of geometry at silhouettes, so its
gradients miss the boundary terms.  ``render_soft`` replaces the two
discontinuous selections with smooth ones, in the style of soft
rasterization (SoftRas, Liu et al. 2019) restated for ray tracing:

- the inside-triangle test ``u>=0 & v>=0 & u+v<=1``
  (``GPUandCPU/include/query.h:104-108``) becomes the coverage
  ``sigmoid(min(u, v, 1-u-v) / sigma)``;
- the closest-hit argmin over t (``query.h:254-263``) becomes a depth
  softmin among candidates, weight ``cov_i * exp(-(t_i - m)/gamma)``,
  and the hit attributes their weighted mean;
- foreground and background blend by the coverage union
  ``alpha = 1 - prod_i (1 - cov_i)``, accumulated in log space.  The
  background is not a softmin candidate.

The triangles stream in chunks (a Python loop in place of the JAX
``lax.scan``) with a running-minimum reference depth, so no exponent is
positive (an online softmax).  Under autograd each chunk is
checkpointed: the backward pass recomputes a chunk's (R, C)
intermediates instead of keeping every chunk's.  Gradients come from
``torch.autograd``.  Scope: primary visibility and direct light; shadows
are off (``"none"``) or hard with no gradient (``"hard_detached"``).
Cost is O(R * T), so keep training resolutions small.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..ops import shading
from ..ops.intersect import chunk_tuv, occluded
from ..scene.build import Scene
from ..scene.material import MaterialTable

__all__ = ["render_soft", "soft_render_loss"]

# aggregated attributes: [n (3) | albedo (3) | kd | spec (3) | ks |
# shininess | emission (3) | t]
_N_ATTR = 16


def _chunk(o, d, tri, nrm, mat_c, dead, m, s_w, log_tr, acc, t_bg, gamma,
           sigma: float, tmin: float, det_eps: float):
    """One chunk of candidates folded into the running (m, s_w, log_tr,
    acc); the masking order is the JAX package's, which keeps NaN out of
    the gradients."""
    t, u, v, det_ok = chunk_tuv(o, d, tri, det_eps)  # (R, C)
    # near-parallel rays make |u|, |v| ~ 1/det explode; the clip keeps
    # interp**2 finite (such candidates have zero coverage anyway)
    u = torch.clamp(u, -1e3, 1e3)
    v = torch.clamp(v, -1e3, 1e3)

    sd = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    cov = torch.sigmoid(sd / sigma)
    ok = det_ok & (t >= tmin) & ~dead[None, :]
    cov = torch.where(ok, cov, 0.0)
    # log(1 - cov) = log_sigmoid(-sd/sigma), stable where cov saturates
    log_tr = log_tr + torch.where(ok, F.logsigmoid(-sd / sigma), 0.0).sum(-1)
    # candidates of negligible coverage are parked at the background
    # depth BEFORE the running min, or a near plane crossing far outside
    # its triangle makes an exponent positive (0 * inf = NaN)
    t = torch.where(cov > 1e-6, t, t_bg)

    new_m = torch.minimum(m, t.amin(dim=-1))
    rescale = torch.exp((new_m - m) / gamma)  # <= 1
    w_c = cov * torch.exp(-(t - new_m[:, None]) / gamma)  # (R, C)

    # the shading normal at the candidate's own (u, v) (query.h:113-121)
    w_b = 1.0 - u - v
    interp = (w_b[..., None] * nrm[None, :, 0] + u[..., None] * nrm[None, :, 1]
              + v[..., None] * nrm[None, :, 2])  # (R, C, 3)
    # a normal-range clamp: zero-length padding normals stay 0, not NaN
    ilen = torch.sqrt(torch.clamp((interp * interp).sum(-1, keepdim=True),
                                  min=1e-24))
    sn = interp / ilen
    sn = torch.where((sn * d[:, None, :]).sum(-1, keepdim=True) > 0.0, -sn, sn)

    agg_n = (w_c[..., None] * sn).sum(dim=1)  # (R, 3)
    agg_mat = w_c @ mat_c  # (R, 12)
    agg_t = (w_c * t).sum(dim=-1)
    acc = acc * rescale[:, None] + torch.cat([agg_n, agg_mat, agg_t[:, None]],
                                             dim=-1)
    s_w = s_w * rescale + w_c.sum(dim=-1)
    return new_m, s_w, log_tr, acc


def render_soft(scene: Scene, *, sigma: float = 0.01,
                gamma: Optional[torch.Tensor] = None,
                t_background: Optional[torch.Tensor] = None,
                shadows: str = "hard_detached", chunk: int = 512,
                det_eps: float = 1e-8, tmin: float = 1e-4) -> torch.Tensor:
    """Soft render of ``scene``: (H, W, 3) linear radiance.

    sigma: coverage softness in barycentric units.
    gamma: depth-aggregation temperature in world units; default 1e-2 x
      the scene's AABB diagonal.
    t_background: depth at which irrelevant candidates are parked;
      default the camera-to-scene-center distance plus one diagonal.
    shadows: "none" (no shadow rays) or "hard_detached" (hard occlusion
      at the expected hit point, without gradient)."""
    if shadows not in ("none", "hard_detached"):
        raise ValueError(f"unknown shadows mode {shadows!r}")
    geom = scene.geometry
    cam = scene.camera
    verts = geom.vertices  # (T, 3, 3)
    dev = verts.device
    t_count = int(verts.shape[0])
    chunk = min(chunk, t_count)
    if t_count % chunk:
        raise ValueError("triangle count must be padded to the chunk size")

    vflat = verts.reshape(-1, 3)
    lo = vflat.amin(dim=0)
    hi = vflat.amax(dim=0)
    diag = torch.sqrt(((hi - lo) ** 2).sum()) + 1e-6
    gamma = 1e-2 * diag if gamma is None else torch.as_tensor(
        gamma, dtype=verts.dtype, device=dev)
    if t_background is None:
        t_bg = torch.sqrt(((0.5 * (lo + hi) - cam.center) ** 2).sum()) + diag
    else:
        t_bg = torch.as_tensor(t_background, dtype=verts.dtype, device=dev)

    w, h = int(cam.width), int(cam.height)
    jj, ii = torch.meshgrid(torch.arange(h, dtype=verts.dtype, device=dev),
                            torch.arange(w, dtype=verts.dtype, device=dev),
                            indexing="ij")
    o_img, d_img = cam.get_rays(ii, jj)  # (H, W, 3)
    o = o_img.reshape(-1, 3)
    d = d_img.reshape(-1, 3)
    r = o.shape[0]

    mats = scene.materials
    obj = torch.clamp(geom.obj_id.long(), 0, mats.kd.shape[0] - 1)
    dead_all = geom.obj_id < 0  # padding triangles never contribute
    mat_all = torch.cat([
        mats.albedo[obj], mats.kd[obj][:, None], mats.specular_color[obj],
        mats.ks[obj][:, None], mats.shininess[obj][:, None],
        mats.emission[obj]], dim=-1)  # (T, 12)

    kw = dict(dtype=verts.dtype, device=dev)
    carry = (torch.full((r,), 1.0, **kw) * t_bg, torch.zeros(r, **kw),
             torch.zeros(r, **kw), torch.zeros(r, _N_ATTR, **kw))
    remat = torch.is_grad_enabled() and any(
        x.requires_grad for x in (o, d, verts, geom.normals, mat_all, t_bg,
                                  gamma))
    for c0 in range(0, t_count, chunk):
        sl = slice(c0, c0 + chunk)
        args = (o, d, verts[sl], geom.normals[sl], mat_all[sl], dead_all[sl],
                *carry, t_bg, gamma, sigma, tmin, det_eps)
        if remat:
            carry = torch.utils.checkpoint.checkpoint(_chunk, *args,
                                                      use_reentrant=False)
        else:
            carry = _chunk(*args)
    _, s_w, log_tr, acc = carry

    alpha = 1.0 - torch.exp(log_tr)  # log_tr <= 0
    # the floor keeps denom**2 a normal float32 in the division's
    # backward (a 1e-20 floor underflows to 0 and gives inf * 0 = NaN)
    denom = torch.clamp(s_w, min=1e-12)
    n_bar = acc[:, 0:3] / denom[:, None]
    n_bar = n_bar / torch.sqrt(torch.clamp(
        (n_bar * n_bar).sum(-1, keepdim=True), min=1e-24))
    mat_bar = acc[:, 3:15] / denom[:, None]
    t_bar = acc[:, 15] / denom
    p_bar = o + t_bar[:, None] * d

    mat_r = MaterialTable(
        albedo=mat_bar[:, 0:3], kd=mat_bar[:, 3],
        specular_color=mat_bar[:, 4:7], ks=mat_bar[:, 7],
        shininess=torch.clamp(mat_bar[:, 8], min=1.0),
        kr=torch.zeros_like(mat_bar[:, 3]), emission=mat_bar[:, 9:12])

    if shadows == "hard_detached":
        def occlude_fn(oo, dd, lo_, hi_):
            with torch.no_grad():
                return occluded(oo.detach(), dd.detach(), verts.detach(),
                                torch.as_tensor(lo_).detach(),
                                torch.as_tensor(hi_).detach(), det_eps=det_eps)
    else:
        def occlude_fn(oo, dd, lo_, hi_):
            return torch.zeros(oo.shape[0], dtype=torch.bool, device=dev)

    lo_rgb, _ = shading.shade_direct(
        o, d, p_bar, n_bar, mat_r, scene.lights, occlude_fn,
        torch.zeros(r, dtype=torch.int64, device=dev), dialect="gpu")

    if scene.background_kind == "miss":
        bg = torch.broadcast_to(scene.miss_color.to(verts.dtype), (r, 3))
    else:
        bg = shading.sky_gradient(d)

    img = alpha[:, None] * lo_rgb + (1.0 - alpha)[:, None] * bg
    img = torch.clamp(img, 0.0, 1.0)  # per-sample clamp (query.h:219)
    return img.reshape(h, w, 3)


def soft_render_loss(params, scene: Scene, target: torch.Tensor, *,
                     sigma: float = 0.01,
                     shadows: str = "hard_detached") -> torch.Tensor:
    """MSE pixel loss of the soft render with ``params`` substituted
    (``inverse.apply_params``): material and light fields, ``vertices``
    and ``camera_center``, with silhouette (edge) terms in the
    gradients."""
    from .inverse import apply_params

    img = render_soft(apply_params(scene, params), sigma=sigma,
                      shadows=shadows)
    return torch.mean((img - target) ** 2)
