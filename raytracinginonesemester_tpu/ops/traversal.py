"""BVH traversal: a faithful wavefront port of the reference's SearchBVH.

``SearchBVH`` (``GPUandCPU/include/query.h:224-311``) pops an explicit
per-thread stack, prunes with the slab test against the running closest t,
and falls back to brute force on stack overflow.  This module restates it
as a *wavefront* program: every ray in the batch performs one
pop/test/push step per iteration in lockstep, with masks for rays whose
stacks are empty — per-lane control flow becomes ``lax.while_loop`` over
whole-array ops.

This is the semantically-exact traversal used for parity testing and
small scenes; the high-throughput path is ``ops.accel`` (block
culling) and its GPU kernels (``ops.pallas_kernels``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import Array

from .intersect import F32_MAX, HitData, _chunk_hits, intersect_closest
from .lbvh import Lbvh

__all__ = ["bvh_closest", "STACK_DEPTH"]

# 64-bit keys bound the radix-tree depth by 64 (the reference uses a
# generous 512, query.h:242, because CUDA stack slots are cheap; our
# per-ray stack is a dense (R, 64) array so we use the tight bound + the
# same overflow fallback).
STACK_DEPTH = 64


def _slab_test(o: Array, inv_d: Array, box_min: Array, box_max: Array,
               tmin: Array, tmax: Array) -> Array:
    """Ray/AABB slab test.

    Port of ``intersectAABB`` (``bvh.h:81-129``) without its
    axis-parallel special cases: IEEE inf semantics make ``inv_d = 1/0``
    produce the correct +-inf slab bounds, with the degenerate
    NaN case (origin exactly on a slab plane) resolved conservatively.
    Inputs are per-ray (..., 3); returns (...,) bool.
    """
    t1 = (box_min - o) * inv_d
    t2 = (box_max - o) * inv_d
    t_near = jnp.minimum(t1, t2)
    t_far = jnp.maximum(t1, t2)
    # NaN (0 * inf) -> treat that axis as pass-through, like the
    # reference's |dir| < eps branch checking origin within slab
    t_near = jnp.where(jnp.isnan(t_near), -jnp.inf, t_near)
    # Robust-traversal far-plane stretch (Ize 2013): rounding in the two
    # multiplies can shrink the interval past a tangent hit; scaling
    # t_far by 1+4ulp keeps the test conservative (false positives only).
    t_far = jnp.where(jnp.isnan(t_far), jnp.inf, t_far * 1.0000004)
    t0 = jnp.maximum(jnp.max(t_near, axis=-1), tmin)
    t1_ = jnp.minimum(jnp.min(t_far, axis=-1), tmax)
    return t0 <= t1_


@partial(jax.jit, static_argnames=("det_eps",))
def bvh_closest(
    origins: Array,
    dirs: Array,
    bvh: Lbvh,
    vertices: Array,
    tmin=1e-4,
    *,
    det_eps: float = 1e-8,
) -> HitData:
    """Closest hit via lockstep stack traversal; matches SearchBVH.

    ``vertices`` is the (T, 3, 3) triangle array in ORIGINAL order (leaf
    ``object_idx`` indexes into it, as in the reference where sorted
    leaves carry the original triangle id, ``bvh.cu:34-56``).
    """
    r = origins.shape[0]
    num_tris = vertices.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    inv_d = 1.0 / dirs  # IEEE inf for zero components

    v0 = vertices[:, 0]
    e1 = vertices[:, 1] - v0
    e2 = vertices[:, 2] - v0

    stack = jnp.zeros((r, STACK_DEPTH), jnp.int32)  # root (=0) pre-pushed
    sp = jnp.ones((r,), jnp.int32)

    def tri_test(tri_idx, best_t):
        """Masked single-triangle Moller-Trumbore (query.h:72-132)."""
        tv0 = v0[tri_idx]
        te1 = e1[tri_idx]
        te2 = e2[tri_idx]
        pvec = jnp.cross(dirs, te2)
        det = jnp.sum(te1 * pvec, axis=-1)
        inv_det = 1.0 / jnp.where(jnp.abs(det) < det_eps, 1.0, det)
        tvec = origins - tv0
        u = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, te1)
        v = jnp.sum(dirs * qvec, axis=-1) * inv_det
        t = jnp.sum(te2 * qvec, axis=-1) * inv_det
        ok = (
            (jnp.abs(det) >= det_eps)
            & (u >= 0.0) & (u <= 1.0)
            & (v >= 0.0) & (u + v <= 1.0)
            & (t >= tmin) & (t <= best_t)
        )
        return ok, t, u, v

    def cond(carry):
        sp = carry[1]
        return jnp.any(sp > 0)

    def body(carry):
        stack, sp, best_t, best_u, best_v, best_idx, overflow = carry
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = stack[jnp.arange(r), top]
        sp = jnp.where(active, sp - 1, sp)

        # node AABB prune against current best (query.h:251-253)
        hit_box = _slab_test(
            origins, inv_d, bvh.aabb_min[node], bvh.aabb_max[node], tmin, best_t
        )
        live = active & hit_box

        obj = bvh.object_idx[node]
        is_leaf = obj != jnp.uint32(0xFFFFFFFF)
        tri_idx = jnp.clip(obj.astype(jnp.int32), 0, num_tris - 1)

        # leaf: triangle test updates the running best
        ok, t, u, v = tri_test(tri_idx, best_t)
        take = live & is_leaf & ok & (obj.astype(jnp.int32) < num_tris)
        best_t = jnp.where(take, t, best_t)
        best_u = jnp.where(take, u, best_u)
        best_v = jnp.where(take, v, best_v)
        best_idx = jnp.where(take, tri_idx, best_idx)

        # internal: push children whose AABBs pass (query.h:265-287)
        internal = live & ~is_leaf
        li = bvh.left[node].astype(jnp.int32)
        ri = bvh.right[node].astype(jnp.int32)
        push_l = internal & _slab_test(
            origins, inv_d, bvh.aabb_min[li], bvh.aabb_max[li], tmin, best_t
        )
        push_r = internal & _slab_test(
            origins, inv_d, bvh.aabb_min[ri], bvh.aabb_max[ri], tmin, best_t
        )

        rows = jnp.arange(r)
        can_l = sp < STACK_DEPTH
        stack = stack.at[rows, jnp.minimum(sp, STACK_DEPTH - 1)].set(
            jnp.where(push_l & can_l, li, stack[rows, jnp.minimum(sp, STACK_DEPTH - 1)])
        )
        overflow = overflow | (push_l & ~can_l)
        sp = jnp.where(push_l & can_l, sp + 1, sp)

        can_r = sp < STACK_DEPTH
        stack = stack.at[rows, jnp.minimum(sp, STACK_DEPTH - 1)].set(
            jnp.where(push_r & can_r, ri, stack[rows, jnp.minimum(sp, STACK_DEPTH - 1)])
        )
        overflow = overflow | (push_r & ~can_r)
        sp = jnp.where(push_r & can_r, sp + 1, sp)

        return stack, sp, best_t, best_u, best_v, best_idx, overflow

    init = (
        stack,
        sp,
        jnp.full((r,), F32_MAX, jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.full((r,), -1, jnp.int32),
        jnp.zeros((r,), bool),
    )
    _, _, best_t, best_u, best_v, best_idx, overflow = jax.lax.while_loop(
        cond, body, init
    )

    # overflow fallback: brute force the overflowed rays (query.h:298-308).
    # Rays that overflowed re-run against the full soup; masked merge.
    def fallback(args):
        bt, bu, bv, bi = args
        brute = intersect_closest(
            origins, dirs, vertices, tmin=tmin, det_eps=det_eps
        )
        take = overflow & brute.hit & (brute.t < bt)
        return (
            jnp.where(take, brute.t, bt),
            jnp.where(take, brute.u, bu),
            jnp.where(take, brute.v, bv),
            jnp.where(take, brute.tri_idx, bi),
        )

    best_t, best_u, best_v, best_idx = jax.lax.cond(
        jnp.any(overflow),
        fallback,
        lambda args: args,
        (best_t, best_u, best_v, best_idx),
    )

    return HitData(
        t=best_t, u=best_u, v=best_v, tri_idx=best_idx, hit=best_idx >= 0
    )
