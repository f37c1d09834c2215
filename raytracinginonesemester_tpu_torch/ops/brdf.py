"""BRDF evaluation: normalised Lambert + Blinn-Phong.

PyTorch port of ``raytracinginonesemester_tpu.ops.brdf``
(``EvaluateBRDF``, ``CPUOnly/include/brdf.h:12-37``, the same in
``GPUandCPU/include/brdf.h:12-40``): f(wo, wi), without the N.L factor.
"""

from __future__ import annotations

import torch

from ..core.vecmath import unit
from ..scene.material import MaterialTable

__all__ = ["evaluate_brdf"]

_INV_PI = 0.31830988618
_INV_2PI = 0.15915494309


def evaluate_brdf(mat: MaterialTable, n, v, l) -> torch.Tensor:
    """f(wo, wi) for per-ray gathered materials (``MaterialTable.gather``);
    n, v, l (R, 3) unit normal, to-viewer and to-light directions."""
    ndotl = torch.clamp((n * l).sum(dim=-1), min=0.0)
    ndotv = torch.clamp((n * v).sum(dim=-1), min=0.0)
    lit = (ndotl > 0.0) & (ndotv > 0.0)

    # Lambert: rho / pi (brdf.h:22-23)
    fd = mat.albedo * (mat.kd * _INV_PI)[:, None]

    # normalised Blinn-Phong: (n + 2) / (2 pi) * (N.H)^n (brdf.h:26-35);
    # the clamp is a normal float, so h = 0 gives 0, not 0/0
    h = unit(l + v)
    ndoth = torch.clamp((n * h).sum(dim=-1), min=0.0)
    spec_norm = (mat.shininess + 2.0) * _INV_2PI
    pos = ndoth > 0.0
    spec_lobe = spec_norm * torch.where(
        pos, torch.pow(torch.where(pos, ndoth, 1.0), mat.shininess), 0.0)
    fs = mat.specular_color * (mat.ks * spec_lobe)[:, None]
    return torch.where(lit[:, None], fd + fs, 0.0)
