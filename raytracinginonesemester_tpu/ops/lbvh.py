"""LBVH construction (Karras 2012) as batched XLA array ops.

Re-design of the reference's flagship CUDA component
(``GPUandCPU/include/bvh.h:131-445``, ``bvh.cu:1-318``):

- 30-bit Morton codes by bit expansion (``bvh.h:131-151``) — identical
  uint32 arithmetic, vectorized;
- 64-bit sort keys ``(morton << 32) | index`` (``bvh.cu:34-56``) —
  represented as (hi, lo) uint32 pairs so no x64 mode is needed, ordered
  via a stable two-pass argsort (thrust::sort_by_key analog);
- Karras ``determine_range``/``find_split`` (``bvh.h:163-257``) — per
  internal node, as fixed-trip-count vectorized binary searches (each node
  is independent, exactly the property the reference exploits with its
  per-node ``thrust::for_each``);
- bottom-up AABB refit — the reference's atomicCAS + ``__threadfence``
  scheme (``bvh.cu:172-203``) has no XLA analog (XLA is data-race-free by
  construction); the idiomatic replacement is a level-synchronous sweep:
  at most 64 rounds (the radix-tree depth bound for 64-bit keys) of
  "merge children where both are ready".

Node layout matches the reference exactly (``bvh.h:7-13``, ``bvh.cu:30``):
``2P-1`` nodes, internals at ``[0, P-2]``, leaves at ``[P-1, 2P-2]`` in
Morton order, ``object_idx`` = original triangle index for leaves and
``0xFFFFFFFF`` for internals.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

__all__ = ["Lbvh", "morton_codes", "triangle_aabbs", "build_lbvh", "INVALID"]

# numpy (host) scalar on purpose: a module-level jnp constant would live on
# the process-default device and get re-fetched during every trace.
INVALID = np.uint32(0xFFFFFFFF)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Lbvh:
    """Flat LBVH: (2P-1) nodes; all int32/uint32/float32 arrays."""

    parent: Array  # (2P-1,) uint32
    left: Array  # (2P-1,) uint32 (INVALID for leaves)
    right: Array  # (2P-1,) uint32
    object_idx: Array  # (2P-1,) uint32 (INVALID for internals)
    aabb_min: Array  # (2P-1, 3) float32
    aabb_max: Array  # (2P-1, 3) float32

    @property
    def num_leaves(self) -> int:
        return (int(self.parent.shape[0]) + 1) // 2


def _bit_expand(v: Array) -> Array:
    """Spread 10 bits to every 3rd position (``bitExpansion``, bvh.h:131-138)."""
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton_codes(points: Array, resolution: float = 1024.0) -> Array:
    """30-bit Morton codes of (N, 3) points in the unit cube.

    Bit-exact ``ComputeMortonCode`` (``bvh.h:141-151``): coordinates scale
    by ``resolution`` and clamp to [0, resolution-1] before interleaving
    as x*4 + y*2 + z.
    """
    scaled = jnp.clip(points * resolution, 0.0, resolution - 1.0)
    q = scaled.astype(jnp.uint32)
    xx = _bit_expand(q[..., 0])
    yy = _bit_expand(q[..., 1])
    zz = _bit_expand(q[..., 2])
    return xx * jnp.uint32(4) + yy * jnp.uint32(2) + zz


def triangle_aabbs(vertices: Array) -> tuple[Array, Array]:
    """Per-triangle AABBs from (T, 3, 3) vertices (``aabb_of_triangle``,
    bvh.h:57-77, eps=0)."""
    return jnp.min(vertices, axis=1), jnp.max(vertices, axis=1)


def _clz32_exact(x: Array) -> Array:
    """Count leading zeros of uint32 via branch-free bisection, with the
    reference's diff==0 -> 32 convention (``common_upper_bits_cpu``,
    bvh.h:292-301)."""
    x = x.astype(jnp.uint32)
    n = jnp.full(x.shape, 32, jnp.int32)
    shift = jnp.where(x > jnp.uint32(0xFFFF), 16, 0)
    x, n = x >> shift, n - shift
    shift = jnp.where(x > jnp.uint32(0xFF), 8, 0)
    x, n = x >> shift, n - shift
    shift = jnp.where(x > jnp.uint32(0xF), 4, 0)
    x, n = x >> shift, n - shift
    shift = jnp.where(x > jnp.uint32(0x3), 2, 0)
    x, n = x >> shift, n - shift
    shift = jnp.where(x > jnp.uint32(0x1), 1, 0)
    x, n = x >> shift, n - shift
    return n - x.astype(jnp.int32)


def _delta_fn(code_hi: Array, code_lo: Array):
    """Return delta(i, j): common prefix length of 64-bit keys, -1 out of
    range — the ``common_upper_bits`` of bvh.h:163-175 on (hi, lo) pairs."""
    n = code_hi.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        j_c = jnp.clip(j, 0, n - 1)
        hi_x = code_hi[i] ^ code_hi[j_c]
        lo_x = code_lo[i] ^ code_lo[j_c]
        d = jnp.where(
            hi_x != 0, _clz32_exact(hi_x), 32 + _clz32_exact(lo_x)
        )
        return jnp.where(valid, d, -1)

    return delta


def _determine_range(delta, n: int, idx: Array):
    """Vectorizable ``determine_range`` (bvh.h:178-236): direction from
    neighbor deltas, doubling upper bound, then binary search."""
    l_delta = delta(idx, idx - 1)
    r_delta = delta(idx, idx + 1)
    d = jnp.where(r_delta > l_delta, 1, -1)
    delta_min = jnp.minimum(l_delta, r_delta)

    # doubling loop: l_max *= 2 while delta(idx, idx + d*l_max) > delta_min
    max_rounds = max(2, (n - 1).bit_length() + 1)

    def dbl_body(_, l_max):
        grow = delta(idx, idx + d * l_max) > delta_min
        return jnp.where(grow, l_max << 1, l_max)

    l_max = jax.lax.fori_loop(0, max_rounds, dbl_body, jnp.full(idx.shape, 2))

    # binary search for exact length l
    def bs_body(_, carry):
        l, t = carry
        probe = delta(idx, idx + (l + t) * d) > delta_min
        l = jnp.where((t > 0) & probe, l + t, l)
        return l, t >> 1

    l0 = jnp.zeros(idx.shape, jnp.int32)
    t0 = l_max >> 1
    l, _ = jax.lax.fori_loop(0, max_rounds, bs_body, (l0, t0))
    jdx = idx + l * d
    first = jnp.minimum(idx, jdx)
    last = jnp.maximum(idx, jdx)
    return first, last


def _find_split(delta, first: Array, last: Array):
    """Vectorizable ``find_split`` (bvh.h:239-257): highest-differing-bit
    binary split. 64-bit keys are unique, so first_code == last_code never
    happens (the reference's midpoint fallback is unreachable)."""
    delta_node = delta(first, last)
    max_rounds = 33  # stride halves from <= n

    def body(_, carry):
        split, stride = carry
        stride = (stride + 1) >> 1
        middle = split + stride
        ok = (middle < last) & (delta(first, middle) > delta_node)
        split = jnp.where(ok, middle, split)
        return split, stride

    split0 = first
    stride0 = last - first
    split, _ = jax.lax.fori_loop(0, max_rounds, body, (split0, stride0))
    return split


@jax.jit
def build_lbvh(vertices: Array) -> Lbvh:
    """Build the LBVH for (T, 3, 3) triangle vertices.

    Pipeline (mirroring ``buildBVH``, bvh.cu:93-206): leaf AABBs -> scene
    AABB -> morton keys -> stable sort -> leaf permutation -> Karras
    topology -> level-synchronous refit.
    """
    p = vertices.shape[0]
    assert p >= 2, "LBVH needs at least 2 primitives"
    num_nodes = 2 * p - 1

    leaf_min, leaf_max = triangle_aabbs(vertices)
    scene_min = jnp.min(leaf_min, axis=0)
    scene_max = jnp.max(leaf_max, axis=0)

    centroid = 0.5 * (leaf_min + leaf_max)
    extent = scene_max - scene_min
    norm = (centroid - scene_min) / jnp.where(extent == 0, 1.0, extent)
    codes = morton_codes(norm)  # (P,) uint32

    # stable sort by morton code == sort by 64-bit (code << 32 | idx)
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)
    code_hi = codes[order]
    code_lo = order.astype(jnp.uint32)  # original index = low word

    sorted_min = leaf_min[order]
    sorted_max = leaf_max[order]

    delta = _delta_fn(code_hi, code_lo)

    # --- Karras topology for internal nodes [0, P-2] ---
    idx = jnp.arange(p - 1, dtype=jnp.int32)
    first, last = _determine_range(delta, p, idx)
    # idx 0 covers the full range (bvh.h:183-186)
    first = first.at[0].set(0)
    last = last.at[0].set(p - 1)
    gamma = _find_split(delta, first, last)

    left = gamma.astype(jnp.uint32)
    right = (gamma + 1).astype(jnp.uint32)
    # children that are range endpoints are leaves (offset by P-1),
    # bvh.h:273-280
    left = jnp.where(jnp.minimum(first, last) == gamma, left + (p - 1), left)
    right = jnp.where(jnp.maximum(first, last) == gamma + 1, right + (p - 1), right)

    node_left = jnp.concatenate([left, jnp.full(p, INVALID)])
    node_right = jnp.concatenate([right, jnp.full(p, INVALID)])
    node_obj = jnp.concatenate([jnp.full(p - 1, INVALID), code_lo])

    parent = jnp.zeros(num_nodes, jnp.uint32)
    parent = parent.at[left.astype(jnp.int32)].set(idx.astype(jnp.uint32))
    parent = parent.at[right.astype(jnp.int32)].set(idx.astype(jnp.uint32))

    # --- refit: level-synchronous bottom-up merge ---
    big = jnp.float32(jnp.inf)
    aabb_min = jnp.concatenate([jnp.full((p - 1, 3), big), sorted_min])
    aabb_max = jnp.concatenate([jnp.full((p - 1, 3), -big), sorted_max])
    ready = jnp.concatenate([jnp.zeros(p - 1, bool), jnp.ones(p, bool)])

    li = node_left[: p - 1].astype(jnp.int32)
    ri = node_right[: p - 1].astype(jnp.int32)

    def refit_round(carry):
        aabb_min, aabb_max, ready, _ = carry
        can = ready[li] & ready[ri] & ~ready[: p - 1]
        new_min = jnp.minimum(aabb_min[li], aabb_min[ri])
        new_max = jnp.maximum(aabb_max[li], aabb_max[ri])
        aabb_min = aabb_min.at[: p - 1].set(
            jnp.where(can[:, None], new_min, aabb_min[: p - 1])
        )
        aabb_max = aabb_max.at[: p - 1].set(
            jnp.where(can[:, None], new_max, aabb_max[: p - 1])
        )
        ready = ready.at[: p - 1].set(ready[: p - 1] | can)
        return aabb_min, aabb_max, ready, can.any()

    def refit_cond(carry):
        return carry[3]

    aabb_min, aabb_max, ready, _ = jax.lax.while_loop(
        refit_cond,
        refit_round,
        (aabb_min, aabb_max, ready, jnp.asarray(True)),
    )

    return Lbvh(
        parent=parent,
        left=node_left,
        right=node_right,
        object_idx=node_obj,
        aabb_min=aabb_min,
        aabb_max=aabb_max,
    )
