"""Edge-aware differentiable rendering: soft visibility + soft depth.

The hard renderer's pixel value is a step function of geometry at
silhouettes — occlusion/coverage changes are measure-zero events, so
reverse-mode gradients w.r.t. vertex positions and camera pose see only
the *interior* shading terms and miss the boundary terms entirely (the
north-star requirement of "edge-aware visibility gradients").

``render_soft`` replaces the two discontinuous selections with smooth
relaxations, in the style of soft rasterization (SoftRas, Liu et al.
2019), restated for ray tracing:

- the hard inside-triangle test ``u>=0 & v>=0 & u+v<=1``
  (``GPUandCPU/include/query.h:104-108``) becomes a coverage weight
  ``sigmoid(min(u, v, 1-u-v) / sigma)`` — a smooth function of the
  signed barycentric distance to the triangle boundary;
- the hard closest-hit argmin over t (``query.h:254-263``) becomes a
  depth softmin *among candidates*: candidate i gets weight
  ``cov_i * exp(-(t_i - m)/gamma)`` and hit attributes are aggregated as
  the weighted expectation;
- foreground-vs-background is blended by the coverage union
  ``alpha = 1 - prod_i (1 - cov_i)`` (the SoftRas silhouette
  probability), accumulated stably in log space as
  ``sum_i log_sigmoid(-sd_i / sigma)``.  The background must NOT be a
  depth-softmin candidate: any hit makes ``exp(-(t_bg - m)/gamma)``
  underflow, which would give a pixel with coverage 1e-30 the full
  foreground color — silently re-creating the silhouette discontinuity
  at cov = 0 that this module exists to remove.

As ``sigma, gamma -> 0`` the soft image converges to the hard render;
for finite values every pixel is a smooth function of vertices, camera,
materials, and lights, so silhouette motion produces real gradients.

Shape: one ``lax.scan`` over triangle chunks (the same streaming
layout as ``ops.intersect.intersect_closest``); the per-chunk attribute
aggregation is a (R, C) x (C, K) matmul.
A streaming running-minimum reference depth keeps every exponent <= 0
(no overflow), exactly like an online softmax.

Scope: primary visibility + direct lighting (the differentiable-scene
configuration of BASELINE config 4); shadows are optionally applied as
hard visibility with gradients detached ("hard_detached") since shadow
boundary terms need their own relaxation.  No secondary bounces (kr is
ignored).  Use small training resolutions — cost is O(R * T) like the
reference's brute-force HW1 loop (``HW1/src/render.cpp:72-116``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import Array

from ..ops import shading
from ..ops.intersect import chunk_tuv, occluded
from ..scene.build import Scene
from ..scene.material import MaterialTable

__all__ = ["render_soft", "soft_render_loss"]


@partial(jax.jit, static_argnames=("shadows", "chunk", "det_eps", "tmin"))
def render_soft(
    scene: Scene,
    *,
    sigma: float = 0.01,
    gamma: Optional[Array] = None,
    t_background: Optional[Array] = None,
    shadows: str = "hard_detached",
    chunk: int = 512,
    det_eps: float = 1e-8,
    tmin: float = 1e-4,
) -> Array:
    """Soft render of ``scene``: (H, W, 3) linear radiance.

    sigma: coverage softness in barycentric units (scale-free; ~0.01
      blurs edges by about 1% of a triangle's extent).
    gamma: depth-aggregation temperature in world units; default is
      1e-2 x the scene's AABB diagonal.
    t_background: depth at which irrelevant candidates are parked for
      the softmin's conditioning; default is the camera-to-scene-center
      distance plus one diagonal.
    shadows: "none" (fully smooth, no shadow rays) or "hard_detached"
      (hard occlusion at the expected hit point, gradients stopped).
    """
    if shadows not in ("none", "hard_detached"):
        raise ValueError(f"unknown shadows mode {shadows!r}")
    geom = scene.geometry
    cam = scene.camera
    verts = geom.vertices  # (T, 3, 3)
    t_count = verts.shape[0]
    chunk = min(chunk, t_count)
    assert t_count % chunk == 0, "triangle count must be padded to chunk size"

    # scene scale for the depth temperature (concrete shapes, traced values)
    vflat = verts.reshape(-1, 3)
    lo = jnp.min(vflat, axis=0)
    hi = jnp.max(vflat, axis=0)
    diag = jnp.sqrt(jnp.sum((hi - lo) ** 2)) + 1e-6
    if gamma is None:
        gamma = 1e-2 * diag
    gamma = jnp.asarray(gamma, jnp.float32)
    if t_background is None:
        center = 0.5 * (lo + hi)
        t_background = jnp.sqrt(
            jnp.sum((center - cam.center) ** 2)) + diag
    t_bg = jnp.asarray(t_background, jnp.float32)

    o_img, d_img = cam.image_rays()  # (H, W, 3)
    h, w = o_img.shape[:2]
    o = o_img.reshape(-1, 3)
    d = d_img.reshape(-1, 3)
    r = o.shape[0]

    # per-triangle shading attributes, aggregated under the soft weights:
    # [n (3) | albedo (3) | kd | spec (3) | ks | shininess | emission (3) | t]
    mats = scene.materials
    obj = jnp.clip(geom.obj_id, 0, mats.kd.shape[0] - 1)
    pad_dead = geom.obj_id < 0  # padding triangles can never contribute

    tris = verts.reshape(t_count // chunk, chunk, 3, 3)
    tri_norm = geom.normals.reshape(t_count // chunk, chunk, 3, 3)
    tri_obj = obj.reshape(t_count // chunk, chunk)
    tri_dead = pad_dead.reshape(t_count // chunk, chunk)

    n_attr = 16

    def body(carry, inputs):
        m, s_w, log_tr, acc = carry  # (R,), (R,), (R,), (R, n_attr)
        tri, nrm, ob, dead = inputs
        t, u, v, det_ok = chunk_tuv(o, d, tri, det_eps)  # (R, C)
        # near-parallel rays make |u|,|v| ~ 1/det explode; clip so that
        # interp**2 below can't overflow to inf (coverage for such
        # candidates is exactly 0 either way, and the clip's dead zone
        # starts ~1e5 sigmas outside the triangle — no usable gradient
        # is lost)
        u = jnp.clip(u, -1e3, 1e3)
        v = jnp.clip(v, -1e3, 1e3)

        sd = jnp.minimum(jnp.minimum(u, v), 1.0 - u - v)
        cov = jax.nn.sigmoid(sd / sigma)
        ok = det_ok & (t >= tmin) & ~dead[None, :]
        cov = jnp.where(ok, cov, 0.0)
        # log transmittance: log(1 - cov) = log_sigmoid(-sd/sigma) exactly
        # (stable for saturated coverage where 1 - cov underflows)
        log_tr = log_tr + jnp.sum(
            jnp.where(ok, jax.nn.log_sigmoid(-sd / sigma), 0.0), axis=-1)
        # candidates with negligible coverage are parked at the
        # background depth BEFORE the running min — otherwise a near
        # plane-crossing far outside its triangle (tiny cov, small t)
        # makes the exponent positive and 0 * inf = NaN
        relevant = cov > 1e-6
        t = jnp.where(relevant, t, t_bg)

        # online-softmax rescale: reference depth = running min, so
        # every exponent below is <= 0 by construction
        new_m = jnp.minimum(m, jnp.min(t, axis=-1))
        rescale = jnp.exp((new_m - m) / gamma)  # <= 1
        w_c = cov * jnp.exp(-(t - new_m[:, None]) / gamma)  # (R, C)

        # per-candidate attributes (C, n_attr); shading normal is the
        # normalized barycentric interpolation (query.h:113-121) —
        # evaluated at the candidate's own (u, v)
        w_b = 1.0 - u - v
        interp = (
            w_b[..., None] * nrm[None, :, 0]
            + u[..., None] * nrm[None, :, 1]
            + v[..., None] * nrm[None, :, 2]
        )  # (R, C, 3)
        # NORMAL-range clamp: 1e-38 is subnormal and flushes to zero on
        # XLA, turning zero-length padding normals into 0/0 = NaN that
        # 0-weight aggregation then spreads (0 * NaN = NaN)
        ilen = jnp.sqrt(jnp.maximum(
            jnp.sum(interp * interp, axis=-1, keepdims=True), 1e-24))
        sn = interp / ilen
        # flip to face the ray (the gpu dialect's geometric-sidedness
        # hygiene collapses to this for closed meshes)
        sn = jnp.where(
            jnp.sum(sn * d[:, None, :], axis=-1, keepdims=True) > 0.0,
            -sn, sn)

        mat_c = jnp.concatenate([
            mats.albedo[ob],                     # (C, 3)
            mats.kd[ob][:, None],                # (C, 1)
            mats.specular_color[ob],             # (C, 3)
            mats.ks[ob][:, None],
            mats.shininess[ob][:, None],
            mats.emission[ob],                   # (C, 3)
        ], axis=-1)  # (C, 12)

        # aggregate: normals need per-(ray, candidate) values; material
        # columns depend only on the candidate, so their aggregation is
        # an (R, C) x (C, 12) matmul, in full f32 (no TF32 on the GPU)
        agg_n = jnp.sum(w_c[..., None] * sn, axis=1)  # (R, 3)
        agg_mat = jnp.matmul(w_c, mat_c,
                             precision=jax.lax.Precision.HIGHEST)  # (R, 12)
        agg_t = jnp.sum(w_c * t, axis=-1)  # (R,)
        new_acc = acc * rescale[:, None] + jnp.concatenate(
            [agg_n, agg_mat, agg_t[:, None]], axis=-1)
        new_sw = s_w * rescale + jnp.sum(w_c, axis=-1)
        return (new_m, new_sw, log_tr, new_acc), None

    init = (
        jnp.full((r,), t_bg, jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r, n_attr), jnp.float32),
    )
    (m, s_w, log_tr, acc), _ = jax.lax.scan(
        body, init, (tris, tri_norm, tri_obj, tri_dead))

    # silhouette alpha: union of candidate coverages (SoftRas-style)
    alpha = 1.0 - jnp.exp(log_tr)  # log_tr <= 0
    # the floor must keep denom**2 a NORMAL f32: the division backward
    # computes ct * acc / denom**2, and (1e-20)**2 underflows to 0 giving
    # inf * 0 = NaN.  Rays with s_w < 1e-12 are overwhelmingly background
    # (alpha ~ 0 there), so flooring costs no image or gradient signal.
    denom = jnp.maximum(s_w, 1e-12)
    n_bar = acc[:, 0:3] / denom[:, None]
    n_bar = n_bar / jnp.sqrt(jnp.maximum(
        jnp.sum(n_bar * n_bar, axis=-1, keepdims=True), 1e-24))
    mat_bar = acc[:, 3:15] / denom[:, None]
    t_bar = acc[:, 15] / denom
    p_bar = o + t_bar[:, None] * d

    mat_r = MaterialTable(
        albedo=mat_bar[:, 0:3],
        kd=mat_bar[:, 3],
        specular_color=mat_bar[:, 4:7],
        ks=mat_bar[:, 7],
        shininess=jnp.maximum(mat_bar[:, 8], 1.0),
        kr=jnp.zeros_like(mat_bar[:, 3]),
        emission=mat_bar[:, 9:12],
    )

    if shadows == "hard_detached":
        stop = jax.lax.stop_gradient
        occlude_fn = lambda oo, dd, lo_, hi_: occluded(
            stop(oo), stop(dd), stop(scene.geometry.vertices),
            stop(lo_), stop(hi_), det_eps=det_eps)
    else:
        occlude_fn = lambda oo, dd, lo_, hi_: jnp.zeros(
            (oo.shape[0],), bool)

    lo_rgb, _ = shading.shade_direct(
        o, d, p_bar, n_bar, mat_r, scene.lights, occlude_fn,
        jnp.zeros((r,), jnp.uint32), dialect="gpu",
    )

    if scene.background_kind == "miss":
        bg = jnp.broadcast_to(
            jnp.asarray(scene.miss_color, jnp.float32), (r, 3))
    else:
        bg = shading.sky_gradient(d)

    img = alpha[:, None] * lo_rgb + (1.0 - alpha)[:, None] * bg
    img = jnp.clip(img, 0.0, 1.0)  # per-sample clamp (query.h:219)
    return img.reshape(h, w, 3)


@partial(jax.jit, static_argnames=("shadows",))
def soft_render_loss(
    params,
    scene: Scene,
    target: Array,
    *,
    sigma: float = 0.01,
    shadows: str = "hard_detached",
) -> Array:
    """MSE pixel loss of the soft render under substituted parameters.

    Composes with ``inverse.apply_params`` — so the optimized leaves may
    include ``vertices`` and ``camera_center`` in addition to material /
    light fields, with silhouette (edge) terms contributing gradients.
    """
    from .inverse import apply_params

    img = render_soft(apply_params(scene, params), sigma=sigma,
                      shadows=shadows)
    return jnp.mean((img - target) ** 2)
