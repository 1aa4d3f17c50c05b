"""Batched ray-triangle intersection (Möller–Trumbore) and hit records.

Batched formulation of the reference's scalar intersectors:

- ``HW1/include/ray.h:67-117`` — ``ray_intersection`` (t >= 0, FLT_EPSILON
  det cutoff, raw interpolated shading normal, hardcoded metal material),
- ``CPUOnly/include/ray.h:48-97`` — adds face/shading-normal hygiene,
- ``GPUandCPU/include/query.h:72-132`` — ``intersectTriangle`` with
  [tmin, tmax] clipping, 1e-8 det cutoff, geometric-normal sidedness and
  degenerate-shading-normal fallback.

Instead of one ray vs one triangle, ``intersect_closest`` tests a whole
wavefront of rays against the full triangle soup, scanning over
lane-aligned triangle chunks with a running closest-hit carry — all
VPU-friendly elementwise math with a min-reduction, no per-ray control
flow.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

__all__ = ["HitData", "FLT_EPSILON", "chunk_tuv", "intersect_closest",
           "occluded", "make_hit_frame"]

FLT_EPSILON = 1.1920929e-7  # std::numeric_limits<float>::epsilon()
F32_MAX = 3.4028235e38


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HitData:
    """Closest-hit result for a wavefront of rays (all leading shape R)."""

    t: Array  # (R,) float32, F32_MAX where no hit
    u: Array  # (R,) barycentric
    v: Array  # (R,)
    tri_idx: Array  # (R,) int32, -1 where no hit
    hit: Array  # (R,) bool


def chunk_tuv(o: Array, d: Array, tri: Array, det_eps: float):
    """Raw ray x triangle-chunk Möller–Trumbore algebra.

    o, d: (R, 3); tri: (C, 3, 3).  Returns (t, u, v, det_ok) each (R, C)
    WITHOUT the inside-triangle test — callers apply their own acceptance
    (hard barycentric bounds here; smoothed bounds in ``diff.soft``).
    The algebra follows query.h:77-103 with everything broadcast.
    """
    v0 = tri[:, 0]  # (C, 3)
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0

    # pvec = d x e2 : (R, C, 3)
    dx = d[:, None, :]
    pvec = jnp.cross(dx, e2[None, :, :])
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)  # (R, C)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < det_eps, 1.0, det)

    tvec = o[:, None, :] - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(dx * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det
    return t, u, v, jnp.abs(det) >= det_eps


def mt_single(o: Array, d: Array, tri: Array, det_eps: float):
    """Per-ray single-triangle Möller–Trumbore: o, d (R, 3) against ONE
    paired triangle each, tri (R, 3, 3).  Returns (t, u, v) raw (no
    acceptance test) — the differentiable recompute behind the
    detached-traversal mode (``Scene.differentiable``): the winner
    index comes from the fast non-differentiable traversal, this
    carries the gradients."""
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    pvec = jnp.cross(d, e2)
    det = jnp.sum(e1 * pvec, axis=-1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < det_eps, 1.0, det)
    tvec = o - v0
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2 * qvec, axis=-1) * inv_det
    return t, u, v


def _chunk_hits(o: Array, d: Array, tri: Array, det_eps: float):
    """Ray x triangle-chunk Möller–Trumbore with the hard inside test
    (u, v, u+v bounds, query.h:104-108).  Returns (t, u, v, valid)."""
    t, u, v, det_ok = chunk_tuv(o, d, tri, det_eps)
    valid = (
        det_ok
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    return t, u, v, valid


@partial(jax.jit, static_argnames=("det_eps", "chunk"))
def intersect_closest(
    origins: Array,
    dirs: Array,
    vertices: Array,
    tmin=1e-4,
    tmax=F32_MAX,
    *,
    det_eps: float = 1e-8,
    chunk: int = 512,
) -> HitData:
    """Closest hit of each ray against all triangles.

    origins/dirs: (R, 3); vertices: (T, 3, 3) with T a multiple of
    ``chunk`` (scene build pads).  ``tmin``/``tmax`` broadcast against (R,).
    Acceptance is ``tmin <= t <= tmax`` (``query.h:105-108``); pass
    ``tmin=0`` with ``det_eps=FLT_EPSILON`` for HW1 semantics (t >= 0,
    ``HW1/include/ray.h:99-102``).

    Tie-breaking matches the reference's sequential scan: strictly-closer
    wins, so the lowest triangle index survives equal t.
    """
    r = origins.shape[0]
    t_count = vertices.shape[0]
    chunk = min(chunk, t_count)
    assert t_count % chunk == 0, "triangle count must be padded to chunk size"
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))

    tris = vertices.reshape(t_count // chunk, chunk, 3, 3)

    def body(carry, inputs):
        best_t, best_u, best_v, best_idx = carry
        chunk_idx, tri = inputs
        t, u, v, valid = _chunk_hits(origins, dirs, tri, det_eps)
        ok = valid & (t >= tmin[:, None]) & (t <= tmax[:, None])
        t = jnp.where(ok, t, F32_MAX)
        # closest within chunk (first index wins ties, like the scan order
        # of IntersectScene, CPUOnly/include/raytracer.h:100-117)
        j = jnp.argmin(t, axis=-1)  # (R,)
        rows = jnp.arange(r)
        ct, cu, cv = t[rows, j], u[rows, j], v[rows, j]
        better = ct < best_t
        best_u = jnp.where(better, cu, best_u)
        best_v = jnp.where(better, cv, best_v)
        best_idx = jnp.where(better, chunk_idx * chunk + j, best_idx)
        best_t = jnp.where(better, ct, best_t)
        return (best_t, best_u, best_v, best_idx), None

    init = (
        jnp.full((r,), F32_MAX, jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.full((r,), -1, jnp.int32),
    )
    # remat: without it reverse-mode saves every chunk's (R, chunk)
    # Moller-Trumbore intermediates across the scan — hundreds of GB at
    # 1080p — instead of recomputing them in the backward pass.  No-op
    # for forward-only renders.
    (best_t, best_u, best_v, best_idx), _ = jax.lax.scan(
        jax.checkpoint(body), init,
        (jnp.arange(t_count // chunk, dtype=jnp.int32), tris)
    )
    hit = best_idx >= 0
    return HitData(t=best_t, u=best_u, v=best_v, tri_idx=best_idx, hit=hit)


@partial(jax.jit, static_argnames=("det_eps", "chunk"))
def occluded(
    origins: Array,
    dirs: Array,
    vertices: Array,
    tmin=1e-4,
    tmax=F32_MAX,
    *,
    det_eps: float = 1e-8,
    chunk: int = 512,
) -> Array:
    """Any-hit occlusion test: True where something blocks [tmin, tmax].

    The shadow-ray primitive behind ``ShadowVisibility``
    (``CPUOnly/include/raytracer.h:121-168``) and ``IsInShadow``
    (``GPUandCPU/include/shader.h:44-62``).  Cheaper than closest-hit:
    a single any() reduction, no argmin or index carry.
    """
    r = origins.shape[0]
    t_count = vertices.shape[0]
    chunk = min(chunk, t_count)
    assert t_count % chunk == 0
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    tris = vertices.reshape(t_count // chunk, chunk, 3, 3)

    def body(blocked, tri):
        t, _, _, valid = _chunk_hits(origins, dirs, tri, det_eps)
        ok = valid & (t >= tmin[:, None]) & (t <= tmax[:, None])
        return blocked | jnp.any(ok, axis=-1), None

    blocked, _ = jax.lax.scan(jax.checkpoint(body),
                              jnp.zeros((r,), bool), tris)
    return blocked


def make_hit_frame(
    origins: Array,
    dirs: Array,
    hits: HitData,
    vertices: Array,
    normals: Array,
    mode: str = "gpu",
    tri: Array | None = None,
    tn: Array | None = None,
):
    """Derive hit position + shading normal + front_face from a HitData.

    ``mode`` selects the reference dialect's normal hygiene:

    - ``"hw1"``: raw interpolated vertex normal, un-normalized
      (``HW1/include/ray.h:108-110``); ``front_face`` from the geometric
      normal for completeness.
    - ``"cpuonly"``: face normal decides sidedness; shading normal is the
      normalized interpolation, flipped to the chosen side
      (``CPUOnly/include/ray.h:76-92``).
    - ``"gpu"``: geometric sidedness + hemisphere alignment + zero-length
      fallback (``GPUandCPU/include/query.h:113-126``).

    Returns (p, normal, front_face), with arbitrary values where
    ``hits.hit`` is False — callers mask on ``hits.hit``.

    ``tri``/``tn``: optionally the already-gathered (R, 3, 3) winner
    vertices/normals (callers that gathered them for another purpose —
    e.g. the detached-diff winner recompute — pass them in, so the gather and its
    backward scatter-add are paid once, not twice).
    """
    idx = jnp.maximum(hits.tri_idx, 0)
    if tri is None:
        tri = vertices[idx]  # (R, 3, 3)
    if tn is None:
        tn = normals[idx]  # (R, 3, 3)
    u, v = hits.u[:, None], hits.v[:, None]
    w = 1.0 - u - v

    p = origins + hits.t[:, None] * dirs
    interp = w * tn[:, 0] + u * tn[:, 1] + v * tn[:, 2]

    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    geom = jnp.cross(e1, e2)
    geom_len = jnp.sqrt(jnp.sum(geom * geom, axis=-1, keepdims=True))
    geom_n = geom / jnp.maximum(geom_len, 1e-20)  # 1e-38 flushes to 0 on XLA
    front_face = jnp.sum(dirs * geom_n, axis=-1) < 0.0

    if mode == "hw1":
        return p, interp, front_face

    oriented_geom = jnp.where(front_face[:, None], geom_n, -geom_n)
    interp_len_sq = jnp.sum(interp * interp, axis=-1, keepdims=True)
    shade_n = interp / jnp.sqrt(jnp.maximum(interp_len_sq, 1e-24))

    if mode == "cpuonly":
        shade_n = jnp.where(front_face[:, None], shade_n, -shade_n)
        return p, shade_n, front_face

    if mode == "gpu":
        shade_n = jnp.where(interp_len_sq < 1e-12, oriented_geom, shade_n)
        flip = jnp.sum(shade_n * oriented_geom, axis=-1, keepdims=True) < 0.0
        shade_n = jnp.where(flip, -shade_n, shade_n)
        return p, shade_n, front_face

    raise ValueError(f"unknown hit-frame mode {mode!r}")
