"""Materials and lights as structure-of-arrays pytrees.

Device-friendly re-design of the reference's AoS structs:

- ``Material`` (``CPUOnly/include/material.h:6-21`` /
  ``GPUandCPU/include/material.h``): albedo, kd, specularColor, ks,
  shininess, kr, emission — here one array per field, indexed by object id
  (mirroring ``triObjectIds`` -> ``objectMaterials`` mapping,
  ``GPUandCPU/include/query.h:134-153``).
- ``Light`` (``CPUOnly/include/raytracer.h:38-46`` with soft-shadow radius
  and shadow_samples; GPU int-intensity variant
  ``GPUandCPU/include/scene.h:21-25``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = ["MaterialTable", "Lights", "MATERIAL_DEFAULTS"]

# Defaults from CPUOnly/include/material.h:6-21.
MATERIAL_DEFAULTS = dict(
    albedo=(0.8, 0.8, 0.8),
    kd=1.0,
    specular_color=(0.04, 0.04, 0.04),
    ks=0.0,
    shininess=32.0,
    kr=0.0,
    emission=(0.0, 0.0, 0.0),
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MaterialTable:
    """Per-object-id material parameters; all arrays share leading dim M."""

    albedo: Array  # (M, 3)
    kd: Array  # (M,)
    specular_color: Array  # (M, 3)
    ks: Array  # (M,)
    shininess: Array  # (M,)
    kr: Array  # (M,)
    emission: Array  # (M, 3)

    @classmethod
    def from_dicts(cls, mats: Sequence[dict]) -> "MaterialTable":
        """Build from a list of per-object material dicts (missing keys
        take the reference defaults)."""
        if not mats:
            mats = [dict()]
        filled = [{**MATERIAL_DEFAULTS, **m} for m in mats]
        f32 = lambda key: jnp.asarray(
            np.array([m[key] for m in filled], dtype=np.float32)
        )
        return cls(
            albedo=f32("albedo"),
            kd=f32("kd"),
            specular_color=f32("specular_color"),
            ks=f32("ks"),
            shininess=f32("shininess"),
            kr=f32("kr"),
            emission=f32("emission"),
        )

    def gather(self, obj_id: Array) -> "MaterialTable":
        """Gather per-hit materials by object id (``assignMaterialToHit``,
        ``GPUandCPU/include/query.h:134-153``).  Out-of-range ids clamp —
        callers mask misses themselves.

        All 13 features ride ONE row gather of the concatenated (N, 13)
        table; its VJP is XLA's scatter-add."""
        n = self.kd.shape[0]
        table = jnp.concatenate([
            self.albedo,                      # 0:3
            self.kd[:, None],                 # 3
            self.specular_color,              # 4:7
            self.ks[:, None],                 # 7
            self.shininess[:, None],          # 8
            self.kr[:, None],                 # 9
            self.emission,                    # 10:13
        ], axis=1)
        g = table[jnp.clip(obj_id, 0, n - 1)]
        return MaterialTable(
            albedo=g[..., 0:3],
            kd=g[..., 3],
            specular_color=g[..., 4:7],
            ks=g[..., 7],
            shininess=g[..., 8],
            kr=g[..., 9],
            emission=g[..., 10:13],
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Lights:
    """Point/area lights; arrays share leading dim L.

    ``radius > 0`` marks a spherical area light sampled with
    ``shadow_samples`` disk samples (``CPUOnly/include/raytracer.h:121-168``);
    the GPU dialect has hard shadows only (radius 0).
    """

    position: Array  # (L, 3)
    color: Array  # (L, 3)
    intensity: Array  # (L,)
    radius: Array  # (L,)
    # static (config, not data): bounds the unrolled shadow-sample loop
    shadow_samples: tuple = dataclasses.field(
        default=(1,), metadata=dict(static=True)
    )

    @classmethod
    def from_dicts(cls, lights: Sequence[dict]) -> "Lights":
        defaults = dict(
            position=(0.0, 0.0, 0.0),
            color=(1.0, 1.0, 1.0),
            intensity=1.0,
            radius=0.0,
            shadow_samples=1,
        )
        filled = [{**defaults, **l} for l in lights]
        arr = lambda key, dt: jnp.asarray(np.array([l[key] for l in filled], dtype=dt))
        return cls(
            position=arr("position", np.float32),
            color=arr("color", np.float32),
            intensity=arr("intensity", np.float32),
            radius=arr("radius", np.float32),
            shadow_samples=tuple(int(l["shadow_samples"]) for l in filled),
        )

    @property
    def num_lights(self) -> int:
        return int(self.position.shape[0])

    def max_shadow_samples(self) -> int:
        """Static bound for the shadow-sample loop."""
        return max(self.shadow_samples)
