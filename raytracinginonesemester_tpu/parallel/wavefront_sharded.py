"""Compacted + load-balanced bounce scheduling under dp x tp meshes.

The plain sharded integrator pays full-wavefront glue for every bounce,
although only a few per cent of camera rays survive depth 0, and its
alive rays can concentrate on a few data shards (a zoomed-in object
lights up one shard's pixel rows while the others idle).

This module compacts and rebalances at the shard_map level, on the
integrator's own bounce step (``ops.integrator.make_bounce_step``, the
exact per-ray math — so images cannot drift):

1. **Depth 0** runs on every local ray (camera rays are dense).
2. **Compaction is a sort**: one multi-operand ``lax.sort`` per shard packs alive rays first,
   ordered by (direction octant, origin morton) for traversal
   coherence.
3. **Rebalance is an all_to_all**: each shard deals its sorted rays
   round-robin across the data axis (row k goes to shard k mod S), so
   every shard ends up with alive counts within +-S of the mean — the
   renderer analog of expert-parallel token dispatch.  The deal is an
   involution, so the same ``all_to_all`` brings radiance home.
4. **Bounces 1..max** run on a static alive-capacity PREFIX of the
   re-sorted local rays (kernels and glue shrink with the wavefront);
   if the wavefront overflows the capacity, a ``lax.cond`` — with a
   ``pmax`` so every shard agrees — keeps the full width.  Output is
   identical either way: per-ray math never depends on ray placement,
   and rays beyond the alive prefix are dead (bounce is a no-op on
   them by construction).

Under ``model_axis`` the bounce step's closest-hit/occlusion queries
run on each shard's block subset and merge by ``all_gather``/``psum``
(``ops.integrator.merge_hits_over_axis``) — traversal stays sharded
while scheduling happens on the data axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..ops.integrator import make_bounce_step
from ..ops.lbvh import _bit_expand
from ..scene.build import Scene

__all__ = ["trace_rays_compacted"]

_I32_MAX = np.int32(2**31 - 1)


def _scene_bounds(scene):
    """Monotone morton quantization bounds from the REPLICATED geometry
    (never the accel: block AABBs are sharded over the model axis, so
    per-shard bounds would give each model shard a different sort
    permutation — and the all_gather hit merges inside the bounce loop
    would then combine candidates of DIFFERENT rays).  Every model
    shard of a data row must sort its identical ray set identically."""
    v = scene.geometry.vertices
    lo = [jnp.min(v[..., c]) for c in range(3)]
    hi = [jnp.max(v[..., c]) for c in range(3)]
    span = [jnp.maximum(hi[c] - lo[c], 1e-20) for c in range(3)]
    return lo, span


def _sort_key(o, d, alive, lo, span):
    """(octant << 24) | origin morton, INT32_MAX for dead rays: alive
    rays first, grouped by direction octant and origin locality."""
    oct_ = (
        jnp.where(d[:, 0] < 0.0, 4, 0)
        | jnp.where(d[:, 1] < 0.0, 2, 0)
        | jnp.where(d[:, 2] < 0.0, 1, 0)
    ).astype(jnp.int32)
    q = [
        jnp.clip((o[:, c] - lo[c]) / span[c] * 256.0, 0.0, 255.0).astype(
            jnp.uint32)
        for c in range(3)
    ]
    morton = (
        _bit_expand(q[0]) | (_bit_expand(q[1]) << 1)
        | (_bit_expand(q[2]) << 2)
    ).astype(jnp.int32)
    return jnp.where(alive, (oct_ << 24) | morton, _I32_MAX)


def _deal(planes, axis_name: str, s: int):
    """Round-robin deal of (R,) operands across the data axis: sorted
    row k moves to shard k % s.  An involution (applying it twice is
    the identity), so the same call undoes it."""
    if s == 1:
        return planes

    def one(x):
        x2 = x.reshape(-1, s)
        x2 = jax.lax.all_to_all(x2, axis_name, split_axis=1, concat_axis=1,
                                tiled=True)
        return x2.reshape(-1)

    return [one(x) for x in planes]


def trace_rays_compacted(
    origins: Array,
    dirs: Array,
    rng_state: Array,
    scene: Scene,
    model_axis: str | None,
    data_axis: str,
    data_size: int,
    capacity: int | None = None,
) -> Array:
    """Shard-local entry (call INSIDE shard_map): trace local rays with
    sort-compaction + cross-shard load balancing; returns (R, 3)
    radiance in the caller's ray order, bit-identical to
    ``trace_rays`` on the same backend (same bounce step; sorts and
    all_to_alls only permute whole rays, and per-ray math never
    depends on placement).
    """
    bounce = make_bounce_step(scene, model_axis)
    gpu = scene.dialect == "gpu"
    max_depth = int(scene.max_bounces)
    r = origins.shape[0]

    init = (
        origins,
        dirs,
        jnp.ones((r, 3), jnp.float32),
        jnp.zeros((r, 3), jnp.float32),
        jnp.asarray(rng_state, jnp.uint32),
        jnp.ones((r,), bool),
    )
    carry, _ = bounce(init, None)  # depth 0 on the dense camera rays

    if max_depth <= 1:
        radiance = carry[3]
        return jnp.clip(radiance, 0.0, 1.0) if gpu else radiance

    s = int(data_size)
    # pad the local ray count to a deal-able multiple of s with dead
    # rays (sorted last; stripped by the final pixel-order sort)
    pad = (-r) % s
    rp = r + pad
    if pad:
        carry = jax.tree.map(
            lambda a: jnp.concatenate(
                [a, jnp.zeros((pad,) + a.shape[1:], a.dtype)]), carry)
    o, d, tp, rad, state, alive = carry

    lo, span = _scene_bounds(scene)
    key = _sort_key(o, d, alive, lo, span)
    pix = jnp.arange(rp, dtype=jnp.int32)
    if pad:
        # padding sorts after every real ray, dead or alive
        key = key.at[r:].set(_I32_MAX)
        pix = jnp.where(pix < r, pix, _I32_MAX - (rp - pix))

    planes = ([key, pix, state, alive.astype(jnp.int32)]
              + [o[:, c] for c in range(3)] + [d[:, c] for c in range(3)]
              + [tp[:, c] for c in range(3)] + [rad[:, c] for c in range(3)])
    planes = list(jax.lax.sort(tuple(planes), dimension=0, num_keys=1))
    # Rebalance: deal the sorted rays round-robin over the data shards.
    # NO local re-sort afterwards — the homing deal at the end is the
    # positional inverse of this one, so row positions must be
    # preserved through the bounce loop.  The dealt layout interleaves
    # the s sources' alive prefixes (row i came from source i % s, its
    # sorted position i // s), so rows [0, cap) contain every alive ray
    # as long as each source had at most cap/s of them — exactly what
    # the overflow cond below checks, conservatively, by looking at
    # rows [cap, rp).
    planes = _deal(planes, data_axis, s)

    def unpack(ps):
        key, pix, state_u, alive_i = ps[0], ps[1], ps[2], ps[3]
        o = jnp.stack(ps[4:7], axis=1)
        d = jnp.stack(ps[7:10], axis=1)
        tp = jnp.stack(ps[10:13], axis=1)
        rad = jnp.stack(ps[13:16], axis=1)
        return (o, d, tp, rad, state_u, alive_i > 0), pix

    def run_depths(carry):
        def w_cond(c):
            depth, st = c
            return (depth < max_depth) & jnp.any(st[5])

        def w_body(c):
            depth, st = c
            new, _ = bounce(st, None)
            return depth + 1, new

        _, out = jax.lax.while_loop(w_cond, w_body, (jnp.int32(1), carry))
        return out

    cap = capacity
    if cap is None:
        cap = 512
        while cap < rp // 8:
            cap *= 2
    cap = min(cap, rp)

    if cap >= rp:
        carry, pix = unpack(planes)
        carry = run_depths(carry)
        rad = carry[3]
    else:
        alive_sorted = planes[3]
        # every shard must take the same branch: collectives inside the
        # bounce loop (the model-axis hit merges) require lockstep
        overflow = jnp.any(alive_sorted[cap:] > 0)
        if s > 1:
            overflow = jax.lax.pmax(overflow, data_axis)

        def full(ps):
            carry, _ = unpack(ps)
            out = run_depths(carry)
            return out[3]

        def prefix(ps):
            head = [p[:cap] for p in ps]
            carry, _ = unpack(head)
            out = run_depths(carry)
            rad = out[3]
            tail = jnp.stack(ps[13:16], axis=1)[cap:]
            return jnp.concatenate([rad, tail])

        rad = jax.lax.cond(overflow, full, prefix, planes)
        pix = planes[1]

    # bring every ray home (the deal is an involution), then restore
    # the caller's ray order with one local 4-operand sort
    homed = _deal([pix, rad[:, 0], rad[:, 1], rad[:, 2]], data_axis, s)
    pix_h, r_h, g_h, b_h = jax.lax.sort(tuple(homed), dimension=0,
                                        num_keys=1)
    radiance = jnp.stack([r_h, g_h, b_h], axis=1)[:r]
    return jnp.clip(radiance, 0.0, 1.0) if gpu else radiance
