"""Pinhole camera with physical focal-length / sensor-size parameters.

PyTorch port of ``raytracinginonesemester_tpu.core.camera``: the viewport
frame is computed once on the host in float64 (the reference's double
intermediate math, ``HW1/include/camera.h:55-92``) and stored as float32
tensors on the camera's device; ``get_rays`` generates every ray of a
batch in one tensor op.  Both sensor-width conventions are kept:
``sensor_width_mm=None`` derives the width from the pixel aspect ratio
(HW1 / GPUandCPU), a value gives the CPUOnly camera's independent width.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = ["Camera"]


def _unit_or(v: np.ndarray, fallback: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    ln = float(np.sqrt(np.dot(v, v)))
    if ln < eps:
        return fallback
    return v / ln


@dataclasses.dataclass(frozen=True)
class Camera:
    """Immutable camera; (3,) float32 tensors on one device."""

    center: torch.Tensor
    pixel00_loc: torch.Tensor
    pixel_delta_u: torch.Tensor
    pixel_delta_v: torch.Tensor
    width: int
    height: int

    @classmethod
    def create(
        cls,
        position=(0.0, 0.0, 0.0),
        look_at=(0.0, 1.0, 0.0),
        up=(0.0, 0.0, 1.0),
        focal_length_mm: float = 50.0,
        sensor_height_mm: float = 24.0,
        sensor_width_mm: float | None = None,
        width: int = 100,
        height: int = 100,
        device="cuda",
    ) -> "Camera":
        if width < 1:
            raise ValueError("pixel_width must be >= 1")
        if height < 1:
            raise ValueError("pixel_height must be >= 1")

        center = np.asarray(position, dtype=np.float64)
        look_at = np.asarray(look_at, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)

        # camera frame from look-at + up (HW1/include/camera.h:66-69)
        z_up = np.array([0.0, 0.0, 1.0])
        forward = _unit_or(look_at - center, z_up)
        right = _unit_or(np.cross(forward, up), z_up)
        up_corrected = np.cross(right, forward)

        focal_length_m = focal_length_mm / 1000.0
        viewport_height = sensor_height_mm / 1000.0
        if sensor_width_mm is None:
            viewport_width = viewport_height * (float(width) / float(height))
        else:
            viewport_width = sensor_width_mm / 1000.0

        # viewport spans and the upper-left pixel center (camera.h:80-91)
        viewport_u = viewport_width * right
        viewport_v = -viewport_height * up_corrected
        pixel_delta_u = viewport_u / float(width)
        pixel_delta_v = viewport_v / float(height)
        viewport_center = center + focal_length_m * forward
        viewport_upper_left = viewport_center - 0.5 * viewport_u - 0.5 * viewport_v
        pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

        def as_t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)

        return cls(
            center=as_t(center),
            pixel00_loc=as_t(pixel00_loc),
            pixel_delta_u=as_t(pixel_delta_u),
            pixel_delta_v=as_t(pixel_delta_v),
            width=int(width),
            height=int(height),
        )

    @property
    def device(self) -> torch.device:
        return self.center.device

    def pixel_position(self, i, j) -> torch.Tensor:
        """World position of (possibly fractional) pixel coordinates
        (``CPUOnly/include/camera.h:36-43``); output gains a trailing 3."""
        i = torch.as_tensor(i, dtype=torch.float32, device=self.device)
        j = torch.as_tensor(j, dtype=torch.float32, device=self.device)
        return (self.pixel00_loc
                + i[..., None] * self.pixel_delta_u
                + j[..., None] * self.pixel_delta_v)

    @property
    def is_pinhole(self) -> bool:
        """Every ray from ``get_rays`` starts at ``center``
        (``GPUandCPU/include/camera.h:49-53``)."""
        return True

    def get_rays(self, i, j) -> Tuple[torch.Tensor, torch.Tensor]:
        """(origins, unit directions) through fractional pixel coords
        (``Camera::get_ray(float, float)``, ``camera.h:49-53``)."""
        d = self.pixel_position(i, j) - self.center
        d = d / torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]
                           + d[..., 2] * d[..., 2])[..., None]
        return torch.broadcast_to(self.center, d.shape), d
