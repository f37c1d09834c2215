"""Counter-free stateless RNG, bit-compatible with the reference renderer.

PyTorch port of ``raytracinginonesemester_tpu.core.rng``: the reference's
uint32 LCG + xorshift mix (``GPUandCPU/include/query.h:32-48``), its
spatial seed hash and its Wang-hash sub-pixel jitter
(``GPUandCPU/include/antialias.h:30-37``), bit for bit.

torch has no general uint32 arithmetic, and its ``>>`` on int32 is an
arithmetic shift.  Every uint32 value here therefore lives in an int64
tensor in ``[0, 2**32)``, and each product or sum is masked back with
``& 0xFFFFFFFF``.  The largest product (``h * 0x27D4EB2D``) stays below
2**62, so int64 never overflows.  ``to_u32`` / ``to_i32`` convert from and
to the int32 bit patterns of the kernels' rng rows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = [
    "to_u32",
    "to_i32",
    "wang_hash_float",
    "rng_next",
    "make_rng_seed",
    "pixel_jitter",
    "random_unit_vector",
    "random_in_unit_disk",
    "random_on_hemisphere",
    "make_basis",
    "jittered_samples",
]

_MASK = 0xFFFFFFFF
# float32(1) / float32(0xFFFFFFFF): the divisor rounds to 2**32 in f32
_INV_U32_MAX = 2.0 ** -32


def to_u32(x) -> torch.Tensor:
    """Any integer tensor (int32 bit patterns included) -> int64 in [0, 2**32)."""
    return torch.as_tensor(x).to(torch.int64) & _MASK


def to_i32(h: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> the int32 tensor with the same bit pattern."""
    h = h & _MASK
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def _mix(h: torch.Tensor) -> torch.Tensor:
    """Wang-hash avalanche shared by ``rng_next`` and ``wang_hash_float``."""
    h = (h ^ 61) ^ (h >> 16)
    h = (h * 9) & _MASK
    h = h ^ (h >> 4)
    h = (h * 0x27D4EB2D) & _MASK
    return h ^ (h >> 15)


def _u32_to_unit(h: torch.Tensor) -> torch.Tensor:
    # int64 -> float32 rounds to nearest, as the reference's uitofp does
    return h.to(torch.float32) * _INV_U32_MAX


def _lcg(state: torch.Tensor) -> torch.Tensor:
    return (state * 1664525 + 1013904223) & _MASK


def wang_hash_float(seed) -> torch.Tensor:
    """uint32 -> float32 in [0, 1) (``antialias.h:30-37``)."""
    return _u32_to_unit(_mix(to_u32(seed)))


def rng_next(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the LCG and return (new_state, float32 in [0, 1))
    (``query.h:32-42``): the output mixes the *new* state."""
    state = _lcg(to_u32(state))
    return state, _u32_to_unit(_mix(state))


def make_rng_seed(x, y, sample) -> torch.Tensor:
    """Spatial-hash seed by (pixel_x, pixel_y, sample) (``query.h:44-48``)."""
    return (((to_u32(x) * 73856093) & _MASK)
            ^ ((to_u32(y) * 19349663) & _MASK)
            ^ ((to_u32(sample) * 83492791) & _MASK))


def pixel_jitter(x, y, sample) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(pixel, sample) sub-pixel jitter in [-0.5, 0.5)
    (``GPUandCPU/include/query.cu:36-43``): Wang hash for jx, one LCG
    step, Wang hash for jy."""
    h = make_rng_seed(x, y, sample)
    jx = wang_hash_float(h) - 0.5
    jy = wang_hash_float(_lcg(h)) - 0.5
    return jx, jy


def random_unit_vector(state, max_rounds: int = 64):
    """Uniform point on the unit sphere by per-element rejection
    (``query.h:51-62``).  Each element draws 3 numbers per round until
    its candidate lands in the unit ball; accepted elements stop
    advancing, exactly like the scalar loop.  ``max_rounds`` caps the
    loop as the kernels do (P(64 rejections) ~ 1e-21).

    ``state`` is a uint32 tensor (int64 storage) of any shape; returns
    (new_state, (..., 3) float32)."""
    state = to_u32(state)
    vec = torch.zeros(state.shape + (3,), dtype=torch.float32,
                      device=state.device)
    accepted = torch.zeros(state.shape, dtype=torch.bool, device=state.device)
    for _ in range(max_rounds):
        s1, x = rng_next(state)
        s2, y = rng_next(s1)
        s3, z = rng_next(s2)
        x = 2.0 * x - 1.0
        y = 2.0 * y - 1.0
        z = 2.0 * z - 1.0
        lensq = x * x + y * y + z * z
        ok = (lensq > 1e-10) & (lensq <= 1.0)
        inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-10))
        take = ok & ~accepted
        cand = torch.stack([x * inv, y * inv, z * inv], dim=-1)
        vec = torch.where(take[..., None], cand, vec)
        state = torch.where(accepted, state, s3)
        accepted = accepted | ok
        if bool(accepted.all()):
            break
    return state, vec


def random_in_unit_disk(state, max_rounds: int = 64):
    """Uniform point in the unit disk by per-element rejection
    (``CPUOnly/include/raytracer.h:77-85``): two draws per round, accepted
    elements stop advancing; capped at ``max_rounds`` as the kernels are.
    Returns (new_state, (..., 2) float32); elements never accepted keep
    (0, 0)."""
    state = to_u32(state)
    vec = torch.zeros(state.shape + (2,), dtype=torch.float32,
                      device=state.device)
    accepted = torch.zeros(state.shape, dtype=torch.bool, device=state.device)
    for _ in range(max_rounds):
        s1, x = rng_next(state)
        s2, y = rng_next(s1)
        x = 2.0 * x - 1.0
        y = 2.0 * y - 1.0
        r2 = x * x + y * y
        ok = (r2 > 1e-10) & (r2 <= 1.0)
        take = ok & ~accepted
        vec = torch.where(take[..., None], torch.stack([x, y], dim=-1), vec)
        state = torch.where(accepted, state, s2)
        accepted = accepted | ok
        if bool(accepted.all()):
            break
    return state, vec


def random_on_hemisphere(normal: torch.Tensor, state):
    """Uniform direction on the hemisphere around ``normal`` (..., 3)
    (``query.h:66-71``): a ``random_unit_vector`` draw, negated unless
    it lies on the normal's side.  Returns (new_state, (..., 3))."""
    state, v = random_unit_vector(state)
    flip = (v * normal).sum(dim=-1, keepdim=True) > 0.0
    return state, torch.where(flip, v, -v)


def make_basis(w: torch.Tensor):
    """Orthonormal (T, B) around the unit direction ``w`` (..., 3)
    (``CPUOnly/include/raytracer.h:88-93``): the helper axis is +Y when
    |w.x| > 0.9, else +X."""
    use_y = w[..., 0].abs() > 0.9
    a0 = torch.where(use_y, 0.0, 1.0)
    a1 = torch.where(use_y, 1.0, 0.0)
    a2 = torch.zeros_like(a0)
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    t = torch.stack([a1 * w2 - a2 * w1, a2 * w0 - a0 * w2, a0 * w1 - a1 * w0],
                    dim=-1)
    t = t / torch.sqrt((t * t).sum(dim=-1, keepdim=True))
    t0, t1, t2 = t[..., 0], t[..., 1], t[..., 2]
    b = torch.stack([w1 * t2 - w2 * t1, w2 * t0 - w0 * t2, w0 * t1 - w1 * t0],
                    dim=-1)
    return t, b


def jittered_samples(spp: int, seed: int = 12345,
                     centered: bool = True) -> np.ndarray:
    """Host-side per-sample jitter offsets, (spp, 2) float32: numpy's
    legacy ``RandomState(seed)`` raw 32-bit draws are ``std::mt19937(seed)``'s,
    and libstdc++'s ``uniform_real_distribution<float>`` maps a draw to
    ``draw * 2**-32``.  ``centered=True``: the GPU repo's [-0.5, 0.5)
    (``GPUandCPU/include/antialias.h:22-25``); else HW1's [0, 1)."""
    rs = np.random.RandomState(seed)
    draws = rs.randint(0, 2**32, size=2 * spp, dtype=np.uint32)
    offsets = (draws.astype(np.float64) * 2.0**-32).astype(np.float32)
    offsets = offsets.reshape(spp, 2)
    if centered:
        offsets = offsets - np.float32(0.5)
    return offsets
