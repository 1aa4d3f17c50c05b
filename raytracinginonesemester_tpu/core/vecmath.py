"""Batched 3-vector math on ``(..., 3)`` arrays.

Batched replacement for the reference's scalar ``Vec3`` headers
(``HW1/include/vec3.h``, ``HW2/HW2/CPUOnly/include/vec3.h``,
``HW2/HW2/GPUandCPU/include/vec3.h:1-62``).  Instead of a struct with
operator overloads, every function here maps over arbitrarily-batched
float32 arrays whose last axis has length 3, so an entire wavefront of
rays/normals is one op.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

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


def vec3(x, y, z, dtype=jnp.float32) -> Array:
    """Build a single (3,) vector. Counterpart of ``make_vec3`` (vec3.h:18-36)."""
    return jnp.array([x, y, z], dtype=dtype)


def dot3(a: Array, b: Array) -> Array:
    """Dot product over the last axis: ``(...,3),(...,3) -> (...)``."""
    return jnp.sum(a * b, axis=-1)


def length_squared(v: Array) -> Array:
    """Squared length over last axis (``GPUandCPU/include/vec3.h:52``)."""
    return jnp.sum(v * v, axis=-1)


def length(v: Array) -> Array:
    """Euclidean length over last axis (``GPUandCPU/include/vec3.h:51``)."""
    return jnp.sqrt(length_squared(v))


def cross3(a: Array, b: Array) -> Array:
    """Cross product over the last axis (``vec3.h:47-52``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-1
    )


def normalize(v: Array) -> Array:
    """Unit vector, ``v / |v|`` with a zero-length guard.

    Matches ``unit_vector`` in ``CPUOnly/include/vec3.h:55`` (returns the
    input unchanged when the length underflows rather than producing NaN).
    """
    len_sq = length_squared(v)
    inv = jnp.where(len_sq > 0.0, 1.0 / jnp.sqrt(jnp.maximum(len_sq, 1e-38)), 1.0)
    return v * inv[..., None]


def normalize_or(v: Array, fallback: Array, eps: float = 1e-12) -> Array:
    """Unit vector with an explicit fallback for degenerate inputs.

    Matches the camera's private ``unit_vector(v, fallback)`` helper
    (``HW1/include/camera.h:48-53``): lengths below ``eps`` return
    ``fallback`` instead of a normalized vector.
    """
    ln = length(v)
    safe = v / jnp.maximum(ln, 1e-20)[..., None]  # 1e-38 flushes to 0 on XLA
    return jnp.where((ln < eps)[..., None], fallback, safe)


def reflect(incident: Array, normal: Array) -> Array:
    """Mirror reflection ``I - 2*(I.N)*N``.

    Counterpart of ``reflect_dir`` (``CPUOnly/include/raytracer.h:70-74``,
    ``GPUandCPU/include/shader.h:39-43``). ``incident`` points from the ray
    origin toward the surface.
    """
    return incident - 2.0 * dot3(incident, normal)[..., None] * normal
