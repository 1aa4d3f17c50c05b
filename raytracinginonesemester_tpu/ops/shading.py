"""Direct lighting, shadows, and the HW1 fixed-function shader.

Vectorized ports of:

- ``shade`` — HW1's non-recursive sky + ambient + Lambert + Blinn-Phong
  shader (``HW1/include/raytracer.h:21-48``),
- ``ShadeDirect`` + ``ShadowVisibility`` — CPUOnly's per-light BRDF direct
  lighting with disk-sampled soft shadows
  (``CPUOnly/include/raytracer.h:96-211``),
- ``ShadeDirect`` + ``IsInShadow`` — the GPU path's hard-shadow variant
  (``GPUandCPU/include/shader.h:44-110``).

The light loop is a static Python loop (light counts are tiny); every
light iteration is one fully-batched shadow-ray wavefront.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import Array

from ..core import rng as rnglib
from ..scene.material import Lights, MaterialTable
from . import brdf as brdflib

__all__ = ["sky_gradient", "shade_hw1", "shade_direct"]

# Shadow-acne offsets: CPUOnly/include/raytracer.h:49 vs GPUandCPU/include/shader.h:22
RT_EPS_CPUONLY = 1e-4
RT_EPS_GPU = 1e-3


def sky_gradient(dirs: Array) -> Array:
    """Miss-shader sky gradient (``HW1/include/raytracer.h:22-26``,
    ``CPUOnly/include/raytracer.h:226-229``): lerp white -> (0.5,0.7,1.0)
    on the z component of the unit direction."""
    t = 0.5 * (dirs[..., 2] + 1.0)
    white = jnp.ones(3, dtype=dirs.dtype)
    blue = jnp.array([0.5, 0.7, 1.0], dtype=dirs.dtype)
    return (1.0 - t)[..., None] * white + t[..., None] * blue


def shade_hw1(
    origins: Array,
    dirs: Array,
    p: Array,
    normal: Array,
    hit: Array,
    light_position: Array,
    light_color: Array,
) -> Array:
    """HW1 fixed shader: ambient 0.1 + Lambert + Blinn-Phong, clamped.

    Materials are the hardcoded metal of ``HW1/include/ray.h:111-114``
    (albedo (0.8,0.2,0.2), shininess 64).  Misses return the sky gradient.
    """
    albedo = jnp.array([0.8, 0.2, 0.2], dtype=jnp.float32)
    shininess = 64.0

    ambient = albedo * 0.1

    to_l = light_position - p
    l = to_l / jnp.sqrt(jnp.maximum(jnp.sum(to_l * to_l, -1, keepdims=True), 1e-24))
    diff = jnp.maximum(jnp.sum(normal * l, axis=-1), 0.0)
    diffuse = (albedo * light_color) * diff[..., None]

    view = origins - p
    view = view / jnp.sqrt(jnp.maximum(jnp.sum(view * view, -1, keepdims=True), 1e-24))
    half = l + view
    half = half / jnp.sqrt(jnp.maximum(jnp.sum(half * half, -1, keepdims=True), 1e-24))
    spec = jnp.power(jnp.maximum(jnp.sum(normal * half, axis=-1), 0.0), shininess)
    specular = light_color * spec[..., None]

    lit = jnp.minimum(ambient + diffuse + specular, 1.0)  # clamp, raytracer.h:12-18
    return jnp.where(hit[..., None], lit, sky_gradient(dirs))


def _shadow_visibility_soft(
    p: Array,
    n: Array,
    light_pos: Array,
    light_radius: Array,
    num_samples: int,
    occlude_fn,
    state: Array,
    rt_eps: float,
) -> Tuple[Array, Array]:
    """Fraction of unoccluded shadow rays toward a (possibly area) light.

    Port of ``ShadowVisibility`` (``CPUOnly/include/raytracer.h:121-168``):
    the light disk faces the shaded point; each sample jitters the light
    position in the disk; rays offset by ``N * RT_EPS`` test occlusion in
    [RT_EPS, dist - RT_EPS).  Returns (visibility (R,), new rng state).
    """
    to_c = light_pos - p
    dist_c = jnp.sqrt(jnp.maximum(jnp.sum(to_c * to_c, axis=-1), 1e-24))
    w = (p - light_pos) / dist_c[:, None]
    t_axis, b_axis = rnglib.make_basis(w)

    is_area = light_radius > 0.0
    unoccluded = jnp.zeros(p.shape[0], dtype=jnp.float32)

    for s in range(num_samples):
        # Disk sample consumes RNG only for area lights (the reference's
        # point-light path never calls random_in_unit_disk).
        state_d, disk = rnglib.random_in_unit_disk(state)
        state = jnp.where(is_area, state_d, state)
        offset = (
            t_axis * (disk[:, 0] * light_radius)[:, None]
            + b_axis * (disk[:, 1] * light_radius)[:, None]
        )
        sample_pos = jnp.where(is_area[:, None], light_pos + offset, light_pos)

        to_l = sample_pos - p
        dist = jnp.sqrt(jnp.maximum(jnp.sum(to_l * to_l, axis=-1), 1e-24))
        ldir = to_l / dist[:, None]
        blocked = occlude_fn(p + n * rt_eps, ldir, rt_eps, dist - rt_eps)
        # Samples beyond the first only count for area lights (S==1 for
        # point lights, raytracer.h:126-127).
        active = is_area | (s == 0)
        unoccluded = unoccluded + jnp.where(active & ~blocked, 1.0, 0.0)

    denom = jnp.where(is_area, float(num_samples), 1.0)
    return unoccluded / denom, state


def shade_direct(
    origins: Array,
    dirs: Array,
    p: Array,
    n: Array,
    mat: MaterialTable,
    lights: Lights,
    occlude_fn,
    state: Array,
    *,
    dialect: str = "gpu",
    distance_attenuation: bool = False,
) -> Tuple[Array, Array]:
    """Per-hit direct radiance Lo; returns (Lo (R,3), new rng state).

    ``occlude_fn(origins, dirs, tmin, tmax) -> (R,) bool`` is the
    shadow-ray primitive — brute force or an acceleration structure; the
    caller chooses (the analog of the reference passing BVH pointers into
    ``ShadeDirect``, shader.h:65-73).

    - ``dialect="gpu"``: hard shadows via an occlusion ray per light
      (``GPUandCPU/include/shader.h:65-110``), RT_EPS 1e-3 offsets but
      shadow rays traced with the traversal's tmin 1e-4
      (``query.h:230-231``).
    - ``dialect="cpuonly"``: soft shadows with up to
      ``lights.max_shadow_samples()`` disk samples per light
      (``CPUOnly/include/raytracer.h:171-211``), RT_EPS 1e-4.

    ``distance_attenuation`` mirrors the ``RT_USE_DISTANCE_ATTENUATION``
    compile switch (``raytracer.h:52-54``), default off.
    """
    gpu = dialect == "gpu"
    rt_eps = RT_EPS_GPU if gpu else RT_EPS_CPUONLY

    nv = origins - p
    view = nv / jnp.sqrt(jnp.maximum(jnp.sum(nv * nv, -1, keepdims=True), 1e-24))
    n_unit = n / jnp.sqrt(jnp.maximum(jnp.sum(n * n, -1, keepdims=True), 1e-24))

    lo = mat.albedo * 0.05 + mat.emission  # ambient + emission (shader.h:82-87)

    num_lights = lights.num_lights
    max_s = 1 if gpu else lights.max_shadow_samples()
    for li in range(num_lights):
        lpos = lights.position[li]
        to_l = lpos - p
        dist = jnp.sqrt(jnp.maximum(jnp.sum(to_l * to_l, axis=-1), 1e-24))
        ldir = to_l / dist[:, None]
        ndotl = jnp.maximum(jnp.sum(n_unit * ldir, axis=-1), 0.0)

        if gpu:
            # IsInShadow: closest hit with t < dist (shader.h:44-62);
            # traversal tmin is kRayTMin = 1e-4 (query.h:230).
            blocked = occlude_fn(p + n_unit * rt_eps, ldir, 1e-4, dist)
            vis = jnp.where(blocked, 0.0, 1.0)
        else:
            radius = jnp.broadcast_to(lights.radius[li], dist.shape)
            vis, state = _shadow_visibility_soft(
                p, n_unit, lpos, radius, max_s, occlude_fn, state, rt_eps
            )

        f = brdflib.evaluate_brdf(mat, n_unit, view, ldir)
        radiance = lights.color[li] * lights.intensity[li]
        if distance_attenuation:
            radiance = radiance[None, :] / jnp.maximum(dist * dist, 1e-6)[:, None]
        else:
            radiance = jnp.broadcast_to(radiance, f.shape)

        contrib = radiance * f * (ndotl * vis)[:, None]
        lo = lo + jnp.where((ndotl > 0.0)[:, None], contrib, 0.0)

    return lo, state
