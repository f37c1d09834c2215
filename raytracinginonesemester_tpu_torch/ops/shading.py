"""Direct lighting with shadows: the staged integrator's shading glue.

PyTorch port of ``raytracinginonesemester_tpu.ops.shading``:
``ShadeDirect`` with ``IsInShadow`` (``GPUandCPU/include/shader.h:44-110``)
and with CPUOnly's disk-sampled ``ShadowVisibility``
(``CPUOnly/include/raytracer.h:96-211``), the sky-gradient miss shader,
and HW1's fixed shader ``shade_hw1`` (``HW1/include/raytracer.h:21-48``,
for ``render.renderer.render_hw1``).  Each light is one batched
shadow-ray wavefront through the caller's ``occlude_fn`` (kernel F on the
card).
"""

from __future__ import annotations

import torch

from ..core import rng as rnglib
from ..core.vecmath import unit
from ..scene.material import Lights, MaterialTable
from ..utils.timing import span
from .brdf import evaluate_brdf

__all__ = ["RT_EPS_CPUONLY", "RT_EPS_GPU", "sky_gradient", "shade_hw1",
           "shade_direct"]

# shadow-acne offsets: CPUOnly/include/raytracer.h:49, GPUandCPU/include/shader.h:22
RT_EPS_CPUONLY = 1e-4
RT_EPS_GPU = 1e-3


def sky_gradient(dirs) -> torch.Tensor:
    """Miss shader (``CPUOnly/include/raytracer.h:226-229``): white to
    (0.5, 0.7, 1.0) on the z of the unit direction."""
    t = 0.5 * (dirs[..., 2] + 1.0)
    blue = torch.tensor([0.5, 0.7, 1.0], dtype=dirs.dtype, device=dirs.device)
    return (1.0 - t)[..., None] * torch.ones_like(blue) + t[..., None] * blue



def shade_hw1(origins, dirs, p, normal, hit, light_position,
              light_color) -> torch.Tensor:
    """HW1's fixed shader: ambient 0.1 + Lambert + Blinn-Phong, clamped
    at 1, with the hardcoded metal of ``HW1/include/ray.h:111-114``
    (albedo (0.8, 0.2, 0.2), shininess 64); misses get the sky gradient."""
    albedo = torch.tensor([0.8, 0.2, 0.2], device=p.device)
    light_position = torch.as_tensor(light_position, dtype=torch.float32,
                                     device=p.device)
    light_color = torch.as_tensor(light_color, dtype=torch.float32,
                                  device=p.device)
    ambient = albedo * 0.1
    l = unit(light_position - p)
    diff = torch.clamp((normal * l).sum(dim=-1), min=0.0)
    diffuse = (albedo * light_color) * diff[..., None]
    half = unit(l + unit(origins - p))
    spec = torch.pow(torch.clamp((normal * half).sum(dim=-1), min=0.0), 64.0)
    specular = light_color * spec[..., None]
    lit = torch.clamp(ambient + diffuse + specular, max=1.0)  # raytracer.h:12-18
    return torch.where(hit[..., None], lit, sky_gradient(dirs))

def _shadow_visibility_soft(p, n, light_pos, radius: float, num_samples: int,
                            occlude_fn, state, rt_eps: float):
    """Fraction of unoccluded shadow rays toward a light (point, or an
    area light's disk facing the shaded point), ``ShadowVisibility``
    (``raytracer.h:121-168``): ``num_samples`` walks, offset by
    ``N * RT_EPS``, on [RT_EPS, dist - RT_EPS].  An area light's samples
    draw from the rng; a point light counts sample 0 only and draws
    nothing.  Returns (visibility (R,), new rng state)."""
    to_c = light_pos - p
    dist_c = torch.sqrt(torch.clamp((to_c * to_c).sum(dim=-1), min=1e-24))
    w = (p - light_pos) / dist_c[:, None]
    t_axis, b_axis = rnglib.make_basis(w)
    is_area = radius > 0.0
    unoccluded = torch.zeros(p.shape[0], device=p.device)
    for s in range(num_samples):
        if is_area:
            state, disk = rnglib.random_in_unit_disk(state)
            sample_pos = light_pos + (t_axis * (disk[:, 0] * radius)[:, None]
                                      + b_axis * (disk[:, 1] * radius)[:, None])
        else:
            sample_pos = torch.broadcast_to(light_pos, p.shape)
        to_l = sample_pos - p
        dist = torch.sqrt(torch.clamp((to_l * to_l).sum(dim=-1), min=1e-24))
        ldir = to_l / dist[:, None]
        blocked = occlude_fn(p + n * rt_eps, ldir, rt_eps, dist - rt_eps)
        if is_area or s == 0:
            unoccluded = unoccluded + torch.where(blocked, 0.0, 1.0)
    return unoccluded / (float(num_samples) if is_area else 1.0), state


def shade_direct(origins, dirs, p, n, mat: MaterialTable, lights: Lights,
                 occlude_fn, state, *, dialect: str = "gpu",
                 vis_precomputed=None):
    """Per-hit direct radiance; returns (Lo (R, 3), new rng state).

    ``occlude_fn(origins, dirs, tmin, tmax) -> (R,) bool`` is the shadow
    primitive.  gpu: one hard shadow ray per light on [1e-4, dist] from
    ``p + N * 1e-3``, or the visibility the closest-hit kernel already
    traced (``vis_precomputed`` (R, NL)).  cpuonly: soft shadows with
    ``max(lights.shadow_samples)`` disk samples per area light, RT_EPS
    1e-4.  Distance attenuation stays off (the reference's default)."""
    gpu = dialect == "gpu"
    rt_eps = RT_EPS_GPU if gpu else RT_EPS_CPUONLY
    view = unit(origins - p)
    n_unit = unit(n)
    lo = mat.albedo * 0.05 + mat.emission  # ambient + emission (shader.h:82-87)
    max_s = 1 if gpu else max(lights.shadow_samples)
    with span("rt.sync.light_radii"):
        radii = lights.radius.tolist()
    for li in range(lights.num_lights):
        lpos = lights.position[li]
        to_l = lpos - p
        dist = torch.sqrt(torch.clamp((to_l * to_l).sum(dim=-1), min=1e-24))
        ldir = to_l / dist[:, None]
        ndotl = torch.clamp((n_unit * ldir).sum(dim=-1), min=0.0)
        if vis_precomputed is not None:
            vis = vis_precomputed[:, li]
        elif gpu:
            # IsInShadow: any hit on [kRayTMin, dist] (shader.h:44-62)
            blocked = occlude_fn(p + n_unit * rt_eps, ldir, 1e-4, dist)
            vis = torch.where(blocked, 0.0, 1.0)
        else:
            vis, state = _shadow_visibility_soft(
                p, n_unit, lpos, radii[li], max_s, occlude_fn, state, rt_eps)
        f = evaluate_brdf(mat, n_unit, view, ldir)
        radiance = lights.color[li] * lights.intensity[li]
        contrib = radiance * f * (ndotl * vis)[:, None]
        lo = lo + torch.where((ndotl > 0.0)[:, None], contrib, 0.0)
    return lo, state
