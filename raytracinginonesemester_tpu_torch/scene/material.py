"""Materials and lights as structure-of-arrays tensors.

PyTorch port of ``raytracinginonesemester_tpu.scene.material``:
``Material`` (``GPUandCPU/include/material.h``) as one tensor per field
indexed by object id, ``Light`` (``CPUOnly/include/raytracer.h:38-46``,
GPU variant ``GPUandCPU/include/scene.h:21-25``) likewise.  The JAX
package's one-hot MXU gather (``gather_table_small``) is a TPU
workaround; here ``gather`` is plain indexing.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

__all__ = ["MaterialTable", "Lights", "MATERIAL_DEFAULTS"]

# defaults from CPUOnly/include/material.h:6-21
MATERIAL_DEFAULTS = dict(
    albedo=(0.8, 0.8, 0.8),
    kd=1.0,
    specular_color=(0.04, 0.04, 0.04),
    ks=0.0,
    shininess=32.0,
    kr=0.0,
    emission=(0.0, 0.0, 0.0),
)


@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Per-object-id material parameters; all tensors share leading dim M."""

    albedo: torch.Tensor  # (M, 3)
    kd: torch.Tensor  # (M,)
    specular_color: torch.Tensor  # (M, 3)
    ks: torch.Tensor  # (M,)
    shininess: torch.Tensor  # (M,)
    kr: torch.Tensor  # (M,)
    emission: torch.Tensor  # (M, 3)

    @classmethod
    def from_dicts(cls, mats: Sequence[dict], device="cuda") -> "MaterialTable":
        """Per-object material dicts; missing keys take the defaults."""
        if not mats:
            mats = [dict()]
        filled = [{**MATERIAL_DEFAULTS, **m} for m in mats]

        def f32(key):
            return torch.as_tensor(
                np.array([m[key] for m in filled], dtype=np.float32),
                device=device)

        return cls(
            albedo=f32("albedo"),
            kd=f32("kd"),
            specular_color=f32("specular_color"),
            ks=f32("ks"),
            shininess=f32("shininess"),
            kr=f32("kr"),
            emission=f32("emission"),
        )

    def gather(self, obj_id: torch.Tensor) -> "MaterialTable":
        """Per-hit materials by object id (``assignMaterialToHit``,
        ``GPUandCPU/include/query.h:134-153``).  Out-of-range ids clamp;
        callers mask misses themselves."""
        idx = torch.clamp(obj_id.long(), 0, int(self.kd.shape[0]) - 1)
        return MaterialTable(**{f.name: getattr(self, f.name)[idx]
                                for f in dataclasses.fields(self)})


@dataclasses.dataclass(frozen=True)
class Lights:
    """Point/area lights; tensors share leading dim L.  ``radius > 0``
    marks a spherical area light (cpuonly dialect); the gpu dialect has
    hard shadows only."""

    position: torch.Tensor  # (L, 3)
    color: torch.Tensor  # (L, 3)
    intensity: torch.Tensor  # (L,)
    radius: torch.Tensor  # (L,)
    shadow_samples: tuple = (1,)

    @classmethod
    def from_dicts(cls, lights: Sequence[dict], device="cuda") -> "Lights":
        defaults = dict(position=(0.0, 0.0, 0.0), color=(1.0, 1.0, 1.0),
                        intensity=1.0, radius=0.0, shadow_samples=1)
        filled = [{**defaults, **l} for l in lights]

        def f32(key):
            return torch.as_tensor(
                np.array([l[key] for l in filled], dtype=np.float32),
                device=device)

        return cls(
            position=f32("position"),
            color=f32("color"),
            intensity=f32("intensity"),
            radius=f32("radius"),
            shadow_samples=tuple(int(l["shadow_samples"]) for l in filled),
        )

    @property
    def num_lights(self) -> int:
        return int(self.position.shape[0])
