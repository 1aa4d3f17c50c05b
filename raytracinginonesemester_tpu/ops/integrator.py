"""Path integrator: fixed-depth wavefront loop with throughput/radiance carry.

Port of the *iterative* tracer the reference proved on GPU
(``TraceRayIterative``, ``GPUandCPU/include/query.h:156-220``) — the same
semantics as CPUOnly's recursive ``TraceRay``
(``CPUOnly/include/raytracer.h:215-260``) restated as a loop, which is
exactly the shape ``lax.scan`` wants: static depth, whole-wavefront state,
per-lane aliveness masks instead of control flow.

Per bounce:  closest hit -> miss shading -> direct lighting (+shadows) ->
Russian-roulette diffuse/mirror split -> throughput update -> early-out.
RNG is the reference's per-ray uint32 stream (bit-compatible, see
``core.rng``); masked state threading reproduces the scalar code's
draws-only-when-the-branch-is-taken behavior lane by lane.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import Array

from ..core import rng as rnglib
from ..core.vecmath import reflect
from ..scene.build import Scene
from . import shading
from .backend import resolve_traversal
from .intersect import (FLT_EPSILON, HitData, intersect_closest,
                        make_hit_frame, mt_single)

__all__ = ["trace_rays", "make_bounce_step"]

# differentiable renders unroll their bounce loop up to this depth (XLA
# then fuses across bounce boundaries and keeps residuals unstacked);
# deeper loops scan, bounding compile time and program size
DIFF_UNROLL_MAX_DEPTH = 8


def merge_hits_over_axis(hits: HitData, axis_name: str) -> HitData:
    """Min-t merge of per-shard HitData across a mesh axis.

    The collective analog of the reference's sequential closest-t update
    (``query.h:254-263``) when triangle testing is sharded over devices:
    all_gather the per-shard candidates (a few scalars per ray) and select
    the global minimum, lowest shard winning ties.
    """
    t = jax.lax.all_gather(hits.t, axis_name)  # (S, R)
    u = jax.lax.all_gather(hits.u, axis_name)
    v = jax.lax.all_gather(hits.v, axis_name)
    idx = jax.lax.all_gather(hits.tri_idx, axis_name)
    # lexicographic (t, global tri id): partition-invariant and identical
    # to the unsharded tie-break (smallest original index wins)
    min_t = jnp.min(t, axis=0, keepdims=True)
    id_key = jnp.where((t == min_t) & (idx >= 0), idx, 2**31 - 1)
    best_id = jnp.min(id_key, axis=0, keepdims=True)
    best = jnp.argmax((t == min_t) & (id_key == best_id), axis=0)
    cols = jnp.arange(t.shape[1])
    return HitData(
        t=t[best, cols],
        u=u[best, cols],
        v=v[best, cols],
        tri_idx=idx[best, cols],
        hit=idx[best, cols] >= 0,
    )


def _traversal_fns(scene: Scene, det_eps: float, tmin: float):
    """(closest_local, occlude_local) for the scene's traversal
    implementation (``ops.backend.resolve_traversal``)."""
    geom = scene.geometry
    if scene.accel is None:
        from .intersect import occluded

        def closest_local(o, d):
            return intersect_closest(o, d, geom.vertices, tmin=tmin,
                                     det_eps=det_eps)

        def occlude_local(o, d, s_tmin, s_tmax):
            return occluded(o, d, geom.vertices, tmin=s_tmin, tmax=s_tmax,
                            det_eps=det_eps)

        return closest_local, occlude_local

    impl = resolve_traversal(scene.use_pallas, scene.interpret)
    if impl == "xla":
        from .accel import block_closest as closest_k
        from .accel import block_occluded as occlude_k
        kw = {}
    else:
        from .pallas_kernels import pallas_block_closest as closest_k
        from .pallas_kernels import pallas_block_occluded as occlude_k
        kw = {"interpret": impl == "interpret"}

    def closest_local(o, d):
        return closest_k(o, d, scene.accel, tmin=tmin, det_eps=det_eps, **kw)

    def occlude_local(o, d, s_tmin, s_tmax):
        return occlude_k(o, d, scene.accel, tmin=s_tmin, tmax=s_tmax,
                         det_eps=det_eps, **kw)

    return closest_local, occlude_local


def make_bounce_step(scene: Scene, model_axis: str | None = None):
    """Build the integrator's single-bounce step for a scene.

    Returns ``bounce(carry, _) -> (carry, None)`` over the wavefront
    carry ``(origins, dirs, throughput, radiance, rng_state, alive)``
    — the loop body of ``TraceRayIterative`` (query.h:165-216) with
    the scene's dialect rules, acceleration dispatch, and (under
    ``model_axis``) the collective hit merges baked in.  Shared by
    ``trace_rays`` and the compacted sharded scheduler
    (``parallel.wavefront_sharded``), so the two can never drift.
    """
    gpu = scene.dialect == "gpu"
    det_eps = 1e-8 if gpu else FLT_EPSILON
    offset_eps = shading.RT_EPS_GPU if gpu else shading.RT_EPS_CPUONLY
    tmin = 1e-4  # kRayTMin (query.h:230) == CPUOnly RT_EPS
    diffuse_bounce = scene.diffuse_bounce
    geom = scene.geometry

    closest_fn, occlude_fn = _traversal_fns(scene, det_eps, tmin)
    if model_axis is not None:
        # triangle testing sharded over `model_axis`: local candidates are
        # merged by collectives (the analog of cross-thread reduction)
        closest_local, occlude_local = closest_fn, occlude_fn

        def closest_fn(o, d):
            return merge_hits_over_axis(closest_local(o, d), model_axis)

        def occlude_fn(o, d, s_tmin, s_tmax):
            local = occlude_local(o, d, s_tmin, s_tmax)
            return jax.lax.psum(local.astype(jnp.int32), model_axis) > 0

    differentiable = bool(getattr(scene, "differentiable", False))
    tri_cell = [None]  # winner (vertices, normals), set by closest_fn below
    if differentiable and scene.accel is not None:
        # Detached-traversal differentiable mode: the (dynamic-loop,
        # non-differentiable) block traversal runs entirely under
        # stop_gradient to pick the winner triangle; a per-ray
        # Moller-Trumbore on the gathered winner then carries gradients
        # w.r.t. vertices/origins/directions, while the primal t/u/v
        # pass through BIT-EXACTLY via a + (b - stop_gradient(b)).
        # This is the standard detached estimator (the discrete
        # which-triangle choice has zero gradient anyway away from
        # silhouettes, exactly like the brute-force path's argmin).
        sg = jax.lax.stop_gradient
        inner_closest = closest_fn

        def closest_fn(o, d):
            hits = jax.tree.map(sg, inner_closest(sg(o), sg(d)))
            idx = jnp.maximum(hits.tri_idx, 0)
            # differentiable gathers (R, 3, 3); stashed in tri_cell so
            # make_hit_frame reuses them.  Their VJP is XLA's scatter-add.
            tri = geom.vertices[idx]
            tri_cell[0] = (tri, geom.normals[idx])
            t2, u2, v2 = mt_single(o, d, tri, det_eps)
            thru = lambda a, b: a + (b - sg(b))
            return HitData(
                t=thru(hits.t, t2), u=thru(hits.u, u2),
                v=thru(hits.v, v2), tri_idx=hits.tri_idx, hit=hits.hit,
            )

        # occlusion is a 0/1 step function of its inputs (no useful
        # gradient anywhere), and the Pallas occlusion kernel has no JVP
        # rule — detach its inputs so hit points built from the
        # gradient-carrying t never push tangents into pallas_call
        inner_occlude = occlude_fn

        def occlude_fn(o, d, s_tmin, s_tmax):
            return inner_occlude(sg(o), sg(d), sg(s_tmin), sg(s_tmax))

    def bounce(carry, _):
        o, d, throughput, radiance, state, alive = carry
        r = o.shape[0]

        # park dead rays at an unreachable origin: every slab test misses,
        # so finished lanes cost the traversal nothing
        o = jnp.where(alive[:, None], o, 1e30)

        hits = closest_fn(o, d)
        found = hits.hit & alive

        # --- miss shading ---
        if gpu:
            miss_rad = jnp.broadcast_to(scene.miss_color, (r, 3))
        else:
            unit_d = d / jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1, keepdims=True), 1e-24))
            miss_rad = shading.sky_gradient(unit_d)
        missed = alive & ~hits.hit
        radiance = radiance + jnp.where(missed[:, None], throughput * miss_rad, 0.0)

        # --- hit frame + material ---
        tri_tn = tri_cell[0]
        p, n, _ = make_hit_frame(
            o, d, hits, geom.vertices, geom.normals,
            mode=scene.dialect,
            tri=tri_tn[0] if tri_tn is not None else None,
            tn=tri_tn[1] if tri_tn is not None else None,
        )
        # park miss/dead lanes' shade points too: their shadow rays then
        # cull instantly instead of tracing from a garbage position
        p = jnp.where(found[:, None], p, 1e30)
        obj = geom.obj_id[jnp.maximum(hits.tri_idx, 0)]
        mat = scene.materials.gather(obj)

        # --- direct lighting ---
        direct, state_direct = shading.shade_direct(
            o, d, p, n, mat, scene.lights, occlude_fn, state,
            dialect=scene.dialect,
        )
        state = jnp.where(found, state_direct, state)
        radiance = radiance + jnp.where(found[:, None], throughput * direct, 0.0)

        # --- Russian-roulette bounce split (query.h:188-206) ---
        kd, kr = mat.kd, mat.kr
        total = kd + kr
        can_bounce = found & (total > 0.0)

        n_unit = n / jnp.sqrt(jnp.maximum(jnp.sum(n * n, -1, keepdims=True), 1e-24))
        state_xi, xi = rnglib.rng_next(state)
        state = jnp.where(can_bounce, state_xi, state)

        take_diffuse = can_bounce & (
            xi < kd / jnp.where(total > 0, total, 1.0))
        if not diffuse_bounce:
            take_diffuse = jnp.zeros_like(take_diffuse)
        take_mirror = can_bounce & ~take_diffuse
        if not gpu:
            # CPUOnly only mirrors when kr > 0 (raytracer.h:249);
            # the GPU loop always takes the else-branch.
            take_mirror = take_mirror & (kr > 0.0)

        if diffuse_bounce:
            # diffuse branch: hemisphere sample consumes RNG only where
            # taken.  stop_gradient on the normal keeps the rejection
            # while_loop out of reverse-mode autodiff (sample directions
            # are treated as constants, the standard score-free estimator).
            state_h, hemi = rnglib.random_on_hemisphere(
                jax.lax.stop_gradient(n_unit), state
            )
            state = jnp.where(take_diffuse, state_h, state)
            ndotl = jnp.maximum(jnp.sum(n_unit * hemi, axis=-1), 0.0)
            if gpu:
                diff_tp = mat.albedo * (2.0 * ndotl)[:, None]
            else:
                diff_tp = mat.albedo * (total * 2.0 * ndotl)[:, None]
        else:
            # statically mirror-only: no sampling ops in the graph at all,
            # keeping the integrator reverse-differentiable
            hemi = n_unit
            diff_tp = jnp.ones_like(mat.albedo)

        # mirror branch: GPU uses kr * tint (query.h:202-205); CPUOnly uses
        # (diffuse_bounce ? total : kr) * tint (raytracer.h:249-255)
        d_unit = d / jnp.sqrt(jnp.maximum(jnp.sum(d * d, -1, keepdims=True), 1e-24))
        refl = reflect(d_unit, n_unit)
        if gpu:
            mirror_scale = kr
        else:
            mirror_scale = total if diffuse_bounce else kr
        mirror_tp = mat.specular_color * mirror_scale[:, None]

        new_dir = jnp.where(take_diffuse[:, None], hemi, refl)
        new_origin = p + n_unit * offset_eps
        tp_scale = jnp.where(
            take_diffuse[:, None], diff_tp,
            jnp.where(take_mirror[:, None], mirror_tp, 1.0),
        )

        bounced = take_diffuse | take_mirror
        o = jnp.where(bounced[:, None], new_origin, o)
        d = jnp.where(bounced[:, None], new_dir, d)
        throughput = jnp.where(bounced[:, None], throughput * tp_scale, throughput)

        # early-out: all channels < 1e-4 (query.h:209-212)
        tiny = jnp.all(throughput < 1e-4, axis=-1)
        alive = bounced & ~tiny

        return (o, d, throughput, radiance, state, alive), None

    return bounce


def trace_rays(
    origins: Array,
    dirs: Array,
    rng_state: Array,
    scene: Scene,
    model_axis: str | None = None,
) -> Array:
    """Trace a wavefront of rays to completion; returns radiance (R, 3).

    Dialect differences honored (see module docstring of ``ops.shading``):

    =====================  ======================  =====================
    ..                     gpu                     cpuonly
    =====================  ======================  =====================
    det epsilon            1e-8                    FLT_EPSILON
    ray-offset eps         1e-3                    1e-4
    traversal tmin         1e-4                    1e-4
    miss radiance          miss_color              sky gradient
    diffuse throughput     albedo * 2 * N.L        albedo * total * 2 * N.L
    mirror throughput      kr * tint               (db ? total : kr) * tint
    final clamp            [0, 1] per bounce loop  none (clamped at PNG)
    =====================  ======================  =====================

    (throughput rows cite ``query.h:195-206`` vs ``raytracer.h:240-256``;
    the GPU path clamps the summed radiance once at loop exit,
    ``query.h:219``.)
    """
    bounce = make_bounce_step(scene, model_axis)
    max_depth = scene.max_bounces
    gpu = scene.dialect == "gpu"
    differentiable = bool(getattr(scene, "differentiable", False))
    r = origins.shape[0]

    init = (
        origins,
        dirs,
        jnp.ones((r, 3), jnp.float32),
        jnp.zeros((r, 3), jnp.float32),
        jnp.asarray(rng_state, jnp.uint32),
        jnp.ones((r,), bool),
    )
    if scene.accel is None or differentiable:
        # differentiable path: fixed trip count (reverse-mode
        # transposes; lax.while_loop does not) — detached-traversal
        # scenes need it just as much as brute-force ones
        if int(max_depth) <= DIFF_UNROLL_MAX_DEPTH:
            carry = init
            for _ in range(int(max_depth)):
                carry = bounce(carry, None)[0]
            radiance = carry[3]
        else:
            (_, _, _, radiance, _, _), _ = jax.lax.scan(
                bounce, init, None, length=max_depth
            )
    else:
        # forward path: stop as soon as every ray has terminated — e.g. a
        # mirror-free scene finishes in 1 bounce instead of max_depth
        # (the wavefront analog of the reference's per-thread `break`,
        # query.h:209-212)
        def w_cond(carry):
            depth, state = carry
            return (depth < max_depth) & jnp.any(state[5])

        def w_body(carry):
            depth, state = carry
            new_state, _ = bounce(state, None)
            return depth + 1, new_state

        _, (_, _, _, radiance, _, _) = jax.lax.while_loop(
            w_cond, w_body, (jnp.int32(0), init)
        )

    if gpu:
        radiance = jnp.clip(radiance, 0.0, 1.0)  # clamp(radiance), query.h:219
    return radiance
