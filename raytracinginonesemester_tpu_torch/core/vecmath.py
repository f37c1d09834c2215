"""Batched 3-vector math on ``(..., 3)`` tensors.

PyTorch port of ``raytracinginonesemester_tpu.core.vecmath`` (the
reference's ``Vec3`` headers, ``GPUandCPU/include/vec3.h:1-62``): every
function maps over arbitrarily batched float32 tensors whose last axis
has length 3.
"""

from __future__ import annotations

import torch

__all__ = [
    "dot3",
    "cross3",
    "length",
    "length_squared",
    "normalize",
    "normalize_or",
    "reflect",
    "vec3",
]


def vec3(x, y, z, dtype=torch.float32, device=None) -> torch.Tensor:
    """Build a single (3,) vector (``make_vec3``, vec3.h:18-36)."""
    return torch.tensor([x, y, z], dtype=dtype, device=device)


def _sum3(a: torch.Tensor) -> torch.Tensor:
    # explicit left-to-right order: (a0 + a1) + a2
    return a[..., 0] + a[..., 1] + a[..., 2]


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over the last axis: ``(...,3),(...,3) -> (...)``."""
    return _sum3(a * b)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    """Squared length over the last axis (``vec3.h:52``)."""
    return _sum3(v * v)


def length(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length over the last axis (``vec3.h:51``)."""
    return torch.sqrt(length_squared(v))


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis (``vec3.h:47-52``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def normalize(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|``, returning the input unchanged when the length
    underflows (``unit_vector``, ``CPUOnly/include/vec3.h:55``)."""
    len_sq = length_squared(v)
    inv = torch.where(len_sq > 0.0,
                      1.0 / torch.sqrt(torch.clamp(len_sq, min=1e-38)),
                      torch.ones_like(len_sq))
    return v * inv[..., None]


def unit(v: torch.Tensor) -> torch.Tensor:
    """``v / sqrt(max(|v|^2, 1e-24))`` over the last axis: the
    normalisation of the JAX package's integrator and shaders."""
    return v / torch.sqrt(torch.clamp((v * v).sum(dim=-1, keepdim=True),
                                      min=1e-24))


def normalize_or(v: torch.Tensor, fallback: torch.Tensor,
                 eps: float = 1e-12) -> torch.Tensor:
    """Unit vector, or ``fallback`` where ``|v| < eps``
    (``HW1/include/camera.h:48-53``)."""
    ln = length(v)
    safe = v / torch.clamp(ln, min=1e-20)[..., None]
    return torch.where((ln < eps)[..., None], fallback, safe)


def reflect(incident: torch.Tensor, normal: torch.Tensor) -> torch.Tensor:
    """Mirror reflection ``I - 2*(I.N)*N`` (``shader.h:39-43``)."""
    return incident - 2.0 * dot3(incident, normal)[..., None] * normal
