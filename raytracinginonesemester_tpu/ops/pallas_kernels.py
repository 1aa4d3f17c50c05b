"""Traversal kernels for the GPU: Pallas through Triton.

The XLA block path (``ops.accel.block_closest``) tests every ray of a
wavefront against every block that *any* ray of the wavefront hits, one
(R, GROUP * B) dense step at a time.  These kernels give each program one
small tile of spatially coherent rays (the renderer's 16x16 pixel
swizzle) and let it walk only its own tile's plan:

1. an XLA pre-pass (``accel.tile_visit_plan_fast``) bounds each tile's
   rays with interval boxes and sorts the superblocks (``accel.SUPER``
   Morton-adjacent blocks) the tile can reach by entry distance;
2. the program loads its own plan row, walks it front to back, slab-tests
   each block against its rays, and runs a dense Moller-Trumbore on
   (ray tile, triangle chunk) pairs for blocks some ray can reach.  The
   closest-hit walk stops once the next superblock starts beyond every
   ray's best hit (ordered BVH descent with closest-t pruning,
   ``query.h:251-263``); the any-hit walk stops once every ray is
   blocked.

Each ray's best (t, u, v, id) lives in registers for the whole walk.
Triangle planes stay in global memory and are read through L2 in
power-of-two chunks, so one kernel serves every scene size.  Winners
break ties on (t, global triangle id), the rule every traversal path of
the repo shares, so results match ``accel.block_closest`` and the brute
force ``intersect.intersect_closest``.

``interpret=True`` runs the same kernel body through the Pallas
interpreter (CPU tests); it is never chosen implicitly
(``ops.backend.resolve_traversal``).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .accel import SUPER, BlockGrid, tile_visit_plan_fast
from .intersect import F32_MAX, HitData

__all__ = ["pallas_block_closest", "pallas_block_occluded", "RAY_TILE",
           "TRI_CHUNK"]

# rays per program and triangles per dense step; both powers of two
# (Triton block shapes).  Chosen on the H100 (PERF.md).
RAY_TILE = 32
TRI_CHUNK = 32
NUM_WARPS = 4
NUM_STAGES = 1

_INT_MAX = np.int32(2**31 - 1)


def _compiler_params():
    return plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES)


def _load_rays(rays_ref):
    """(8, RAY_TILE) ray block -> origin, direction, tmin, tmax rows."""
    o = tuple(rays_ref[k, :] for k in range(3))
    d = tuple(rays_ref[k, :] for k in range(3, 6))
    return o, d, rays_ref[6, :], rays_ref[7, :]


def _slab(aabb_ref, b, o, inv_d, tmin, tmax):
    """Per-ray slab test against block ``b``'s AABB (``bvh.h:81-129``),
    with the far plane stretched so culling stays conservative under
    f32 rounding (same rule as ``accel._slab_entry``)."""
    t0, t1 = tmin, tmax
    for axis in range(3):
        lo = (aabb_ref[axis, b] - o[axis]) * inv_d[axis]
        hi = (aabb_ref[axis + 3, b] - o[axis]) * inv_d[axis]
        near = jnp.minimum(lo, hi)
        far = jnp.maximum(lo, hi)
        near = jnp.where(jnp.isnan(near), -jnp.inf, near)
        far = jnp.where(jnp.isnan(far), jnp.inf, far * 1.0000004)
        t0 = jnp.maximum(t0, near)
        t1 = jnp.minimum(t1, far)
    return t0 <= t1


def _any(mask):
    return jnp.max(mask.astype(jnp.int32)) > 0


def _mt_chunk(o, d, tri_ref, ids_ref, start, det_eps, tmin, tmax):
    """(RAY_TILE,) rays vs TRI_CHUNK triangles from ``start``.

    Unrolled Moller-Trumbore (``query.h:72-132``) on (RAY_TILE,
    TRI_CHUNK) tiles; returns (t, u, v, ids) with misses and padding
    lanes at t = F32_MAX.
    """
    sl = pl.ds(start, TRI_CHUNK)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        tri_ref[k, sl][None, :] for k in range(9))
    ids = ids_ref[sl]
    ox, oy, oz = (c[:, None] for c in o)
    dx, dy, dz = (c[:, None] for c in d)

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / jnp.where(jnp.abs(det) < det_eps, 1.0, det)

    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det

    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det

    ok = (
        (jnp.abs(det) >= det_eps)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin[:, None]) & (t <= tmax[:, None])
        & (ids >= 0)[None, :]
    )
    return jnp.where(ok, t, F32_MAX), u, v, ids


def _closest_kernel(det_eps, num_blocks, num_supers, block_size,
                    rays_ref, tri_ref, ids_ref, aabb_ref, order_ref,
                    entry_ref, t_ref, u_ref, v_ref, idx_ref):
    tile = pl.program_id(0)
    o, d, tmin, _ = _load_rays(rays_ref)
    inv_d = tuple(1.0 / c for c in d)
    n_chunks = block_size // TRI_CHUNK

    def visit_chunk(c, state, b):
        best_t, best_u, best_v, best_id = state
        t, u, v, ids = _mt_chunk(o, d, tri_ref, ids_ref,
                                 b * block_size + c * TRI_CHUNK,
                                 det_eps, tmin, best_t)
        min_t = jnp.min(t, axis=1)
        at_min = t == min_t[:, None]
        id_key = jnp.where(at_min & (ids >= 0)[None, :], ids[None, :],
                           _INT_MAX)
        win_id = jnp.min(id_key, axis=1)
        pick = at_min & (id_key == win_id[:, None])
        win_u = jnp.sum(jnp.where(pick, u, 0.0), axis=1)
        win_v = jnp.sum(jnp.where(pick, v, 0.0), axis=1)
        best_key = jnp.where(best_id >= 0, best_id, _INT_MAX)
        take = (min_t < F32_MAX) & (
            (min_t < best_t) | ((min_t == best_t) & (win_id < best_key)))
        return (jnp.where(take, min_t, best_t),
                jnp.where(take, win_u, best_u),
                jnp.where(take, win_v, best_v),
                jnp.where(take, win_id, best_id))

    def visit_block(j, carry):
        k, state = carry
        b = order_ref[tile, k] * SUPER + j
        b_c = jnp.minimum(b, num_blocks - 1)
        boxed = _slab(aabb_ref, b_c, o, inv_d, tmin, state[0])
        state = jax.lax.cond(
            _any(boxed) & (b < num_blocks),
            lambda s: jax.lax.fori_loop(
                0, n_chunks, lambda c, s_: visit_chunk(c, s_, b_c), s),
            lambda s: s,
            state)
        return k, state

    def cond(carry):
        k, state = carry
        next_entry = entry_ref[tile, jnp.minimum(k, num_supers - 1)]
        return (k < num_supers) & (next_entry <= jnp.max(state[0]))

    def body(carry):
        k, state = jax.lax.fori_loop(0, SUPER, visit_block, carry)
        return k + 1, state

    init = (jnp.full(tmin.shape, F32_MAX, jnp.float32),
            jnp.zeros(tmin.shape, jnp.float32),
            jnp.zeros(tmin.shape, jnp.float32),
            jnp.full(tmin.shape, -1, jnp.int32))
    _, (best_t, best_u, best_v, best_id) = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init))
    t_ref[...] = best_t
    u_ref[...] = best_u
    v_ref[...] = best_v
    idx_ref[...] = best_id


def _occluded_kernel(det_eps, num_blocks, num_supers, block_size,
                     rays_ref, tri_ref, ids_ref, aabb_ref, order_ref,
                     entry_ref, out_ref):
    tile = pl.program_id(0)
    o, d, tmin, tmax = _load_rays(rays_ref)
    inv_d = tuple(1.0 / c for c in d)
    n_chunks = block_size // TRI_CHUNK

    def visit_block(j, carry):
        k, blocked = carry
        b = order_ref[tile, k] * SUPER + j
        b_c = jnp.minimum(b, num_blocks - 1)
        boxed = _slab(aabb_ref, b_c, o, inv_d, tmin, tmax) & ~blocked

        def walk(blocked):
            def c_cond(cc):
                c, blk = cc
                return (c < n_chunks) & _any(~blk)

            def c_body(cc):
                c, blk = cc
                t, _, _, _ = _mt_chunk(o, d, tri_ref, ids_ref,
                                       b_c * block_size + c * TRI_CHUNK,
                                       det_eps, tmin, tmax)
                return c + 1, blk | (jnp.min(t, axis=1) < F32_MAX)

            return jax.lax.while_loop(c_cond, c_body,
                                      (jnp.int32(0), blocked))[1]

        blocked = jax.lax.cond(_any(boxed) & (b < num_blocks), walk,
                               lambda x: x, blocked)
        return k, blocked

    def cond(carry):
        k, blocked = carry
        next_entry = entry_ref[tile, jnp.minimum(k, num_supers - 1)]
        return (k < num_supers) & (next_entry < jnp.inf) & _any(~blocked)

    def body(carry):
        k, blocked = jax.lax.fori_loop(0, SUPER, visit_block, carry)
        return k + 1, blocked

    _, blocked = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros(tmin.shape, jnp.bool_)))
    out_ref[...] = blocked.astype(jnp.int32)


def _prep(origins, dirs, grid: BlockGrid, tmin, tmax):
    """Pad rays to whole tiles, build the per-tile plan and the flat
    operand layout the kernels read."""
    r = origins.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    pad = (-r) % RAY_TILE
    if pad:
        # padded rays start at infinity: every slab test misses, so they
        # never appear in any tile's plan
        origins = jnp.concatenate(
            [origins, jnp.full((pad, 3), 1e30, jnp.float32)])
        dirs = jnp.concatenate([dirs, jnp.ones((pad, 3), jnp.float32)])
        tmin = jnp.concatenate([tmin, jnp.zeros((pad,), jnp.float32)])
        tmax = jnp.concatenate([tmax, jnp.zeros((pad,), jnp.float32)])
    rp = r + pad
    order, entry, _ = tile_visit_plan_fast(origins, dirs, grid, tmin, tmax,
                                           RAY_TILE)
    rays = jnp.concatenate(
        [origins.T, dirs.T, tmin[None], tmax[None]]).astype(jnp.float32)
    l, b = grid.tri_index.shape
    operands = (rays, grid.tri.reshape(9, l * b),
                grid.tri_index.reshape(l * b), grid.aabb, order, entry)
    return operands, rp, order.shape[1]


def _in_specs():
    whole = pl.BlockSpec(memory_space=pl.ANY)
    return [pl.BlockSpec((8, RAY_TILE), lambda i: (0, i)),
            whole, whole, whole, whole, whole]


def _check_block_size(block_size: int) -> None:
    if block_size % TRI_CHUNK:
        raise ValueError(
            f"block size {block_size} must be a multiple of {TRI_CHUNK}")


@partial(jax.jit, static_argnames=("det_eps", "interpret"))
def pallas_block_closest(
    origins: Array,
    dirs: Array,
    grid: BlockGrid,
    tmin=1e-4,
    *,
    det_eps: float = 1e-8,
    interpret: bool = False,
) -> HitData:
    """Closest hit through the Triton traversal kernel.

    Same contract as ``accel.block_closest``: hits, winning triangle ids
    and the (t, global id) tie-break are identical; t/u/v may differ in
    the last ulp where the GPU contracts multiply-adds differently.
    """
    r = origins.shape[0]
    l, b = grid.tri_index.shape
    _check_block_size(b)
    operands, rp, ls = _prep(origins, dirs, grid, tmin, F32_MAX)
    row = pl.BlockSpec((RAY_TILE,), lambda i: (i,))
    t, u, v, idx = pl.pallas_call(
        partial(_closest_kernel, det_eps, l, ls, b),
        out_shape=[jax.ShapeDtypeStruct((rp,), jnp.float32)] * 3
        + [jax.ShapeDtypeStruct((rp,), jnp.int32)],
        grid=(rp // RAY_TILE,),
        in_specs=_in_specs(),
        out_specs=[row] * 4,
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="rt_closest",
    )(*operands)
    return HitData(t=t[:r], u=u[:r], v=v[:r], tri_idx=idx[:r],
                   hit=idx[:r] >= 0)


@partial(jax.jit, static_argnames=("det_eps", "interpret"))
def pallas_block_occluded(
    origins: Array,
    dirs: Array,
    grid: BlockGrid,
    tmin=1e-4,
    tmax=F32_MAX,
    *,
    det_eps: float = 1e-8,
    interpret: bool = False,
) -> Array:
    """Any-hit occlusion through the Triton traversal kernel (same
    contract as ``accel.block_occluded``)."""
    r = origins.shape[0]
    l, b = grid.tri_index.shape
    _check_block_size(b)
    operands, rp, ls = _prep(origins, dirs, grid, tmin, tmax)
    (blocked,) = pl.pallas_call(
        partial(_occluded_kernel, det_eps, l, ls, b),
        out_shape=[jax.ShapeDtypeStruct((rp,), jnp.int32)],
        grid=(rp // RAY_TILE,),
        in_specs=_in_specs(),
        out_specs=[pl.BlockSpec((RAY_TILE,), lambda i: (i,))],
        compiler_params=_compiler_params(),
        interpret=interpret,
        name="rt_occluded",
    )(*operands)
    return blocked[:r] > 0
