"""Pinhole camera with physical focal-length / sensor-size parameters.

Re-design of the reference cameras:

- ``HW1/include/camera.h:8-93`` — sensor width derived from the pixel
  aspect ratio; integer pixel lookups.
- ``HW2/HW2/CPUOnly/include/camera.h:8-105`` — independent
  ``sensor_width_mm`` plus fractional ``get_pixel_position(double, double)``
  for jittered sampling.
- ``HW2/HW2/GPUandCPU/include/camera.h:8-95`` — device-side
  ``get_ray(float i, float j)``, the per-pixel ray-gen entry point.

Instead of a per-pixel method called in a loop, this camera precomputes the
viewport frame once on the host (in float64, matching the reference's double
intermediate math) and generates *all* W×H×S ray origins/directions as one
batched array op.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = ["Camera"]


def _unit_or(v: np.ndarray, fallback: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    ln = float(np.sqrt(np.dot(v, v)))
    if ln < eps:
        return fallback
    return v / ln


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Immutable camera pytree.

    The derived viewport frame (``pixel00_loc``, ``pixel_delta_u/v``) is
    computed eagerly by :meth:`create`, mirroring ``camera::initialize``
    (``HW1/include/camera.h:55-92``).
    """

    center: Array
    pixel00_loc: Array
    pixel_delta_u: Array
    pixel_delta_v: Array
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))

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
        dtype=jnp.float32,
    ) -> "Camera":
        """Build a camera.

        ``sensor_width_mm=None`` derives the sensor width from the image
        aspect ratio (HW1 / GPUandCPU behavior, ``HW1/include/camera.h:79``);
        passing a value reproduces the CPUOnly camera's independent sensor
        width (``CPUOnly/include/camera.h:91``).
        """
        if width < 1:
            raise ValueError("pixel_width must be >= 1")
        if height < 1:
            raise ValueError("pixel_height must be >= 1")

        center = np.asarray(position, dtype=np.float64)
        look_at = np.asarray(look_at, dtype=np.float64)
        up = np.asarray(up, dtype=np.float64)

        # Camera frame from look-at + up (HW1/include/camera.h:66-69).
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

        # Viewport spans and the upper-left pixel center
        # (HW1/include/camera.h:80-91).
        viewport_u = viewport_width * right
        viewport_v = -viewport_height * up_corrected
        pixel_delta_u = viewport_u / float(width)
        pixel_delta_v = viewport_v / float(height)
        viewport_center = center + focal_length_m * forward
        viewport_upper_left = viewport_center - 0.5 * viewport_u - 0.5 * viewport_v
        pixel00_loc = viewport_upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

        as_dt = lambda a: jnp.asarray(a, dtype=dtype)
        return cls(
            center=as_dt(center),
            pixel00_loc=as_dt(pixel00_loc),
            pixel_delta_u=as_dt(pixel_delta_u),
            pixel_delta_v=as_dt(pixel_delta_v),
            width=int(width),
            height=int(height),
        )

    # ------------------------------------------------------------------
    # Ray generation
    # ------------------------------------------------------------------
    def pixel_position(self, i: Array, j: Array) -> Array:
        """World position of (possibly fractional) pixel coordinates.

        Vectorized counterpart of ``get_pixel_position``
        (``CPUOnly/include/camera.h:36-43``): ``i``/``j`` broadcast, output
        gains a trailing axis of 3.
        """
        i = jnp.asarray(i, dtype=self.pixel00_loc.dtype)
        j = jnp.asarray(j, dtype=self.pixel00_loc.dtype)
        return (
            self.pixel00_loc
            + i[..., None] * self.pixel_delta_u
            + j[..., None] * self.pixel_delta_v
        )

    @property
    def is_pinhole(self) -> bool:
        """Every ray returned by ``get_rays`` originates at ``center``.

        True for this camera model (matching the reference's pinhole
        ``Camera::get_ray``, ``GPUandCPU/include/camera.h:49-53``); the
        shared-origin fast paths (``trace_rays(..., shared_origin0)``,
        ``pallas_block_closest(shared_origin=...)``) gate on this so a
        future lens/aperture camera cannot silently render every ray
        from ``origins[0]``."""
        return True

    def get_rays(self, i: Array, j: Array) -> Tuple[Array, Array]:
        """Ray (origins, unit directions) through fractional pixel coords.

        Vectorized ``Camera::get_ray(float, float)``
        (``GPUandCPU/include/camera.h:49-53``).
        """
        pixel = self.pixel_position(i, j)
        d = pixel - self.center
        d = d / jnp.sqrt(jnp.sum(d * d, axis=-1, keepdims=True))
        origins = jnp.broadcast_to(self.center, d.shape)
        return origins, d

    def image_rays(self, offsets: Array | None = None) -> Tuple[Array, Array]:
        """Rays for every pixel: ``(H, W, 3)`` origins and directions.

        ``offsets`` is an optional ``(2,)`` or ``(H, W, 2)`` sub-pixel
        offset added to the integer pixel indices (the jitter analog of
        ``jittered_samples``, ``GPUandCPU/include/antialias.h:12-27``).
        """
        jj, ii = jnp.meshgrid(
            jnp.arange(self.height, dtype=self.pixel00_loc.dtype),
            jnp.arange(self.width, dtype=self.pixel00_loc.dtype),
            indexing="ij",
        )
        if offsets is not None:
            offsets = jnp.asarray(offsets, dtype=self.pixel00_loc.dtype)
            ii = ii + offsets[..., 0]
            jj = jj + offsets[..., 1]
        return self.get_rays(ii, jj)
