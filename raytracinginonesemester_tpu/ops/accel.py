"""Block-culling acceleration structure.

Per-ray stack traversal (``ops.traversal``) is semantically faithful to
the reference but is a data-dependent gather and per-lane branch at
every step.  This structure trades tree depth for vectorizable breadth
(the "wide/shallow" plan from SURVEY.md section 7):

1. **Build** (from the same Morton order the LBVH uses,
   ``bvh.cu:101-133``): sort triangles by centroid Morton code and group
   consecutive runs of ``block_size`` into *blocks*; a block's AABB is the
   union of its members'.  Spatially-coherent triangles land in the same
   block, so block AABBs are tight — this is exactly the bottom
   ``log2(block_size)`` levels of the LBVH collapsed into one node.

2. **Query**: slab-test all block AABBs against all rays — an (R, L)
   elementwise grid — then visit only blocks some ray hit, in a compacted
   dynamic-length loop; each visit is a dense (R, block_size)
   Moller-Trumbore.  The reference's per-thread stack becomes one shared
   worklist per wavefront; its stack-overflow -> brute-force fallback
   (``query.h:298-311``) corresponds to every block being active, which
   is simply visiting every block.

Vectors are stored as *component planes* — nine (L, B) arrays for
v0/e1/e2 xyz — never as a trailing axis of 3, so every intersection
operand is a contiguous run of triangles.  All intersection arithmetic
below is unrolled per component over (R, B) tiles.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from .intersect import F32_MAX, HitData
from .lbvh import morton_codes, triangle_aabbs

__all__ = ["BlockGrid", "build_block_grid",
           "block_closest", "block_occluded",
           "tile_visit_plan", "tile_visit_plan_fast"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockGrid:
    """Morton-ordered triangle blocks in plane-SoA layout.

    ``tri`` is (9, L, B): planes [v0x v0y v0z e1x e1y e1z e2x e2y e2z]
    (edges precomputed once at build; the reference recomputes them per
    test, query.h:77-78).  ``aabb`` is (6, L):
    [min_xyz, max_xyz].  ``tri_index`` maps back to original triangle
    ids (-1 padding).
    """

    tri: Array  # (9, L, B) float32
    tri_index: Array  # (L, B) int32
    obj: Array  # (L, B) int32 — per-triangle object id (-1 padding)
    aabb: Array  # (6, L) float32
    block_size: int = dataclasses.field(metadata=dict(static=True))

    @property
    def num_blocks(self) -> int:
        return int(self.tri.shape[1])


@partial(jax.jit, static_argnames=("block_size",))
def build_block_grid(vertices: Array, num_valid: Array, block_size: int = 128,
                     obj_ids: Array = None) -> BlockGrid:
    """Build the block grid from (T, 3, 3) triangles.

    ``num_valid`` masks padding triangles (they sort to a dedicated tail
    region and never produce hits).  T must be a multiple of
    ``block_size``.
    """
    t = vertices.shape[0]
    assert t % block_size == 0, "triangle count must be padded to block_size"
    l = t // block_size

    leaf_min, leaf_max = triangle_aabbs(vertices)
    valid = jnp.arange(t) < num_valid
    vmin = jnp.where(valid[:, None], leaf_min, jnp.inf)
    vmax = jnp.where(valid[:, None], leaf_max, -jnp.inf)
    scene_min = jnp.min(vmin, axis=0)
    scene_max = jnp.max(vmax, axis=0)

    centroid = 0.5 * (leaf_min + leaf_max)
    extent = scene_max - scene_min
    norm = (centroid - scene_min) / jnp.where(extent == 0, 1.0, extent)
    codes = morton_codes(norm)
    # push padding to the end regardless of its morton code
    codes = jnp.where(valid, codes, jnp.uint32(0xFFFFFFFF))
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)

    sv = vertices[order]  # (T, 3, 3)
    v0 = sv[:, 0]
    e1 = sv[:, 1] - v0
    e2 = sv[:, 2] - v0
    tri = jnp.stack(
        [v0[:, 0], v0[:, 1], v0[:, 2],
         e1[:, 0], e1[:, 1], e1[:, 2],
         e2[:, 0], e2[:, 1], e2[:, 2]]
    ).reshape(9, l, block_size)

    sorted_valid = valid[order]
    tri_index = jnp.where(sorted_valid, order, -1).reshape(l, block_size)
    if obj_ids is None:
        obj_ids = jnp.zeros(t, jnp.int32)
    obj_plane = jnp.where(
        sorted_valid, jnp.asarray(obj_ids, jnp.int32)[order], -1
    ).reshape(l, block_size)

    bmin = jnp.where(sorted_valid[:, None], leaf_min[order], jnp.inf)
    bmax = jnp.where(sorted_valid[:, None], leaf_max[order], -jnp.inf)
    block_min = bmin.reshape(l, block_size, 3).min(axis=1)  # (L, 3)
    block_max = bmax.reshape(l, block_size, 3).max(axis=1)
    aabb = jnp.concatenate([block_min.T, block_max.T])  # (6, L)

    return BlockGrid(
        tri=tri, tri_index=tri_index, obj=obj_plane, aabb=aabb,
        block_size=block_size,
    )


def _slab_entry(o, inv_d, aabb, tmin, tmax):
    """(R,) rays vs (6, L) block AABBs -> ((R, L) hit, (R, L) entry t).

    Port of ``intersectAABB``'s slab logic (bvh.h:81-129) with IEEE inf
    arithmetic standing in for the axis-parallel special cases; also
    returns the clamped slab entry distance used for front-to-back
    traversal ordering.
    """
    ox, oy, oz = o
    ix, iy, iz = inv_d
    t0 = jnp.broadcast_to(tmin[:, None], (tmin.shape[0], aabb.shape[1]))
    t1 = jnp.broadcast_to(tmax[:, None], t0.shape)

    for axis, (oc, ic) in enumerate(((ox, ix), (oy, iy), (oz, iz))):
        lo = (aabb[axis][None, :] - oc[:, None]) * ic[:, None]
        hi = (aabb[axis + 3][None, :] - oc[:, None]) * ic[:, None]
        near = jnp.minimum(lo, hi)
        far = jnp.maximum(lo, hi)
        near = jnp.where(jnp.isnan(near), -jnp.inf, near)
        # robust far-plane stretch (Ize 2013): culling must stay
        # conservative under f32 rounding — false positives only
        far = jnp.where(jnp.isnan(far), jnp.inf, far * 1.0000004)
        t0 = jnp.maximum(t0, near)
        t1 = jnp.minimum(t1, far)
    return t0 <= t1, t0


def _slab_grid(o, inv_d, aabb, tmin, tmax):
    return _slab_entry(o, inv_d, aabb, tmin, tmax)[0]


def _block_tri_test(o, d, tri_block, det_eps, tmin, tmax, ids=None):
    """(R,) rays vs one block's (9, B) triangle planes.

    Fully-unrolled Moller-Trumbore (query.h:72-132) on (R, B) tiles.
    Returns per-ray (t, u, v, j) within the block.  When ``ids`` (the
    global triangle index per lane) is given, ties on t resolve to the
    smallest id — the partition-invariant equivalent of the reference's
    sequential first-wins scan (``raytracer.h:100-117``), so results are
    identical no matter how lanes are grouped or sharded.
    """
    ox, oy, oz = o
    dx, dy, dz = d
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = [
        tri_block[k][None, :] for k in range(9)
    ]
    rdx, rdy, rdz = dx[:, None], dy[:, None], dz[:, None]

    # pvec = d x e2
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv_det = 1.0 / jnp.where(jnp.abs(det) < det_eps, 1.0, det)

    # tvec = o - v0
    tvx = ox[:, None] - v0x
    tvy = oy[:, None] - v0y
    tvz = oz[:, None] - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det

    # qvec = tvec x e1
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det

    ok = (
        (jnp.abs(det) >= det_eps)
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (u + v <= 1.0)
        & (t >= tmin[:, None]) & (t <= tmax[:, None])
    )
    t = jnp.where(ok, t, F32_MAX)
    if ids is None:
        j = jnp.argmin(t, axis=-1)
    else:
        # padding lanes arrive with id INT_MAX — they must not win the min
        t = jnp.where(ids[None, :] == np.int32(2**31 - 1), F32_MAX, t)
        min_t = jnp.min(t, axis=-1, keepdims=True)
        at_min = t == min_t
        id_key = jnp.where(at_min, ids[None, :], np.int32(2**31 - 1))
        best_id = jnp.min(id_key, axis=-1, keepdims=True)
        j = jnp.argmax(at_min & (id_key == best_id), axis=-1)
    rows = jnp.arange(t.shape[0])
    return t[rows, j], u[rows, j], v[rows, j], j


def _ray_soa(origins, dirs):
    o = (origins[:, 0], origins[:, 1], origins[:, 2])
    d = (dirs[:, 0], dirs[:, 1], dirs[:, 2])
    inv = tuple(1.0 / c for c in d)
    return o, d, inv


# Blocks tested per loop step: one sequential-loop iteration gathers
# GROUP blocks and tests (R, GROUP*B) at once, so fewer, fatter steps
# trade loop overhead against the tail group's inactive blocks.  Not
# re-measured on the H100 (PERF.md).
GROUP = 8


def _grouped_visits(grid: BlockGrid, hit_grid: Array):
    """Compact active blocks to the front, padded to a GROUP multiple.

    Returns (visit_order (Lp,), num_steps) where Lp = ceil(L/G)*G; the
    order's tail repeats block 0 (harmlessly re-tested against a
    closed best-t window).
    """
    l = grid.num_blocks
    block_active = jnp.any(hit_grid, axis=0)  # (L,)
    visit_order = jnp.argsort(~block_active, stable=True).astype(jnp.int32)
    pad = (-l) % GROUP
    if pad:
        visit_order = jnp.concatenate(
            [visit_order, jnp.zeros(pad, jnp.int32)]
        )
    num_active = jnp.sum(block_active.astype(jnp.int32))
    num_steps = (num_active + GROUP - 1) // GROUP
    return visit_order, num_steps


def _gather_group(grid: BlockGrid, visit_order: Array, k: Array):
    """Gather GROUP blocks' planes -> (9, GROUP*B) plus their ids."""
    ids = jax.lax.dynamic_slice(visit_order, (k * GROUP,), (GROUP,))
    tri = grid.tri[:, ids]  # (9, GROUP, B)
    tri = tri.reshape(9, GROUP * grid.block_size)
    idx = grid.tri_index[ids].reshape(GROUP * grid.block_size)
    return tri, idx


# blocks per superblock in the coarse traversal plan
SUPER = 8


def super_aabbs(grid: BlockGrid):
    """Union AABBs of consecutive SUPER-block groups -> (6, LS).

    Morton-adjacent blocks are spatially adjacent, so the coarse boxes
    stay tight — this is one more collapsed LBVH level on top of the
    blocks.
    """
    l = grid.num_blocks
    ls = -(-l // SUPER)
    pad = ls * SUPER - l
    aabb = grid.aabb
    if pad:
        pad_cols = jnp.concatenate(
            [jnp.full((3, pad), jnp.inf), jnp.full((3, pad), -jnp.inf)]
        )
        aabb = jnp.concatenate([aabb, pad_cols], axis=1)
    smin = aabb[:3].reshape(3, ls, SUPER).min(axis=2)
    smax = aabb[3:].reshape(3, ls, SUPER).max(axis=2)
    return jnp.concatenate([smin, smax])  # (6, LS)


def tile_visit_plan(origins, dirs, grid: BlockGrid, tmin, tmax, ray_tile: int):
    """Front-to-back per-tile traversal plan for the traversal kernels.

    For each tile of ``ray_tile`` rays (callers arrange tiles to be
    spatially coherent): which *superblocks* (groups of SUPER
    Morton-adjacent blocks) any tile ray's slab test hits, in ascending
    order of the tile's closest slab-entry distance.  Planning at
    superblock granularity cuts the (rays x boxes) pre-pass and the
    per-tile sort by SUPERx; the kernel refines with cheap per-block
    slab tests before each dense triangle test.  Sorted entries let the
    kernel stop as soon as the next superblock begins beyond every ray's
    current best hit — ordered BVH descent with closest-t pruning
    (``query.h:251-263``), amortized per tile.

    origins/dirs must already be padded to a ray_tile multiple.  Returns
    (order (NT, LS) int32, sorted_entry (NT, LS) f32, count (NT, 1)).
    """
    r = origins.shape[0]
    assert r % ray_tile == 0
    nt = r // ray_tile
    o, d, inv_d = _ray_soa(origins, dirs)
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    saabb = super_aabbs(grid)
    hit, entry = _slab_entry(o, inv_d, saabb, tmin, tmax)
    ls = saabb.shape[1]
    entry = jnp.where(hit, entry, jnp.inf).reshape(nt, ray_tile, ls)
    entry_tile = jnp.min(entry, axis=1)  # (NT, LS)
    active = jnp.any(hit.reshape(nt, ray_tile, ls), axis=1)
    count = jnp.sum(active.astype(jnp.int32), axis=1, keepdims=True)
    order = jnp.argsort(entry_tile, axis=1).astype(jnp.int32)
    sorted_entry = jnp.take_along_axis(entry_tile, order, axis=1).astype(jnp.float32)
    return order, sorted_entry, count


# Origins at/above this are "parked" lanes (dead rays, padding); they are
# excluded from interval bounds so one dead lane doesn't blow up a tile's
# hull (renderer parks at 1e30).
PARK_THRESHOLD = 1e29


def tile_visit_plan_fast(origins, dirs, grid: BlockGrid, tmin, tmax,
                         ray_tile: int):
    """Interval-arithmetic tile plan: same contract as ``tile_visit_plan``
    at ~1/ray_tile of the cost.

    Instead of slab-testing every ray against every superblock (an
    (R, LS) grid), bound each tile's live rays with interval boxes —
    [o_lo, o_hi], [d_lo, d_hi], [tmin_lo, tmax_hi] — and run ONE
    interval slab test per (tile, superblock): (NT, LS) work.  Interval
    arithmetic makes the test conservative (every ray a real slab test
    would pass also passes here, and the returned entry is a true lower
    bound of any ray's entry distance), so the kernel's culling and
    front-to-back early exit stay exact: images are bit-identical to the
    per-ray plan.  Direction intervals straddling zero get (-inf, inf)
    slab spans — incoherent tiles degrade to visit-everything, which the
    kernel's own per-block slab tests then prune.
    """
    r = origins.shape[0]
    assert r % ray_tile == 0
    nt = r // ray_tile
    saabb = super_aabbs(grid)  # (6, LS)
    ls = saabb.shape[1]

    live = (origins[:, 0] < PARK_THRESHOLD).reshape(nt, ray_tile, 1)
    o3 = origins.reshape(nt, ray_tile, 3)
    d3 = dirs.reshape(nt, ray_tile, 3)
    o_lo = jnp.min(jnp.where(live, o3, jnp.inf), axis=1)  # (nt, 3)
    o_hi = jnp.max(jnp.where(live, o3, -jnp.inf), axis=1)
    d_lo = jnp.min(jnp.where(live, d3, jnp.inf), axis=1)
    d_hi = jnp.max(jnp.where(live, d3, -jnp.inf), axis=1)

    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    lv = live[..., 0]
    tn_lo = jnp.min(jnp.where(lv, tmin.reshape(nt, ray_tile), jnp.inf), axis=1)
    tx_hi = jnp.max(jnp.where(lv, tmax.reshape(nt, ray_tile), -jnp.inf), axis=1)
    any_live = jnp.any(lv, axis=1)  # (nt,)

    near_all = tn_lo[:, None]
    far_all = tx_hi[:, None]

    def imul(alo, ahi, blo, bhi):
        p1, p2, p3, p4 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
        return (
            jnp.minimum(jnp.minimum(p1, p2), jnp.minimum(p3, p4)),
            jnp.maximum(jnp.maximum(p1, p2), jnp.maximum(p3, p4)),
        )

    for axis in range(3):
        blo = saabb[axis][None, :]
        bhi = saabb[axis + 3][None, :]
        olo, ohi = o_lo[:, axis:axis + 1], o_hi[:, axis:axis + 1]
        dlo, dhi = d_lo[:, axis:axis + 1], d_hi[:, axis:axis + 1]
        spans0 = (dlo <= 0.0) & (dhi >= 0.0)
        # same-sign interval reciprocal is [1/dhi, 1/dlo]
        inv_a, inv_b = 1.0 / dhi, 1.0 / dlo
        p1lo, p1hi = imul(blo - ohi, blo - olo, inv_a, inv_b)
        p2lo, p2hi = imul(bhi - ohi, bhi - olo, inv_a, inv_b)
        near_lo = jnp.minimum(p1lo, p2lo)
        far_hi = jnp.maximum(p1hi, p2hi)
        # widen by a few ulps: round-to-nearest f32 interval arithmetic
        # may under-cover; culling must stay conservative (cf. the
        # per-ray test's Ize far stretch)
        near_lo = near_lo - jnp.abs(near_lo) * 4e-7
        far_hi = far_hi + jnp.abs(far_hi) * 4e-7
        bad = spans0 | jnp.isnan(near_lo) | jnp.isnan(far_hi)
        near_all = jnp.maximum(near_all, jnp.where(bad, -jnp.inf, near_lo))
        far_all = jnp.minimum(far_all, jnp.where(bad, jnp.inf, far_hi))

    valid_box = (saabb[0] <= saabb[3])[None, :]  # padded supers never hit
    hit = (near_all <= far_all) & valid_box & any_live[:, None]
    entry_tile = jnp.where(hit, near_all, jnp.inf)
    count = jnp.sum(hit.astype(jnp.int32), axis=1, keepdims=True)
    order = jnp.argsort(entry_tile, axis=1).astype(jnp.int32)
    sorted_entry = jnp.take_along_axis(entry_tile, order, axis=1).astype(jnp.float32)
    return order, sorted_entry, count


@partial(jax.jit, static_argnames=("det_eps",))
def block_closest(
    origins: Array,
    dirs: Array,
    grid: BlockGrid,
    tmin=1e-4,
    *,
    det_eps: float = 1e-8,
) -> HitData:
    """Closest hit for a ray wavefront via block culling."""
    r = origins.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    o, d, inv_d = _ray_soa(origins, dirs)

    hit_grid = _slab_grid(o, inv_d, grid.aabb, tmin, jnp.full((r,), F32_MAX))
    visit_order, num_steps = _grouped_visits(grid, hit_grid)

    def body(k, carry):
        best_t, best_u, best_v, best_idx = carry
        tri, ids = _gather_group(grid, visit_order, k)
        # padding lanes carry id -1: map to INT_MAX for the tie-break key
        key_ids = jnp.where(ids >= 0, ids, np.int32(2**31 - 1))
        t, u, v, j = _block_tri_test(o, d, tri, det_eps, tmin, best_t, key_ids)
        idx = ids[j]
        best_key = jnp.where(best_idx >= 0, best_idx, np.int32(2**31 - 1))
        take = (idx >= 0) & (t < F32_MAX) & (
            (t < best_t) | ((t == best_t) & (idx < best_key))
        )
        return (
            jnp.where(take, t, best_t),
            jnp.where(take, u, best_u),
            jnp.where(take, v, best_v),
            jnp.where(take, idx, best_idx),
        )

    init = (
        jnp.full((r,), F32_MAX, jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.zeros((r,), jnp.float32),
        jnp.full((r,), -1, jnp.int32),
    )
    best_t, best_u, best_v, best_idx = jax.lax.fori_loop(0, num_steps, body, init)
    return HitData(
        t=best_t, u=best_u, v=best_v, tri_idx=best_idx, hit=best_idx >= 0
    )


@partial(jax.jit, static_argnames=("det_eps",))
def block_occluded(
    origins: Array,
    dirs: Array,
    grid: BlockGrid,
    tmin=1e-4,
    tmax=F32_MAX,
    *,
    det_eps: float = 1e-8,
) -> Array:
    """Any-hit occlusion via block culling; early-exits once every ray
    with an active block is resolved."""
    r = origins.shape[0]
    tmin = jnp.broadcast_to(jnp.asarray(tmin, jnp.float32), (r,))
    tmax = jnp.broadcast_to(jnp.asarray(tmax, jnp.float32), (r,))
    o, d, inv_d = _ray_soa(origins, dirs)

    hit_grid = _slab_grid(o, inv_d, grid.aabb, tmin, tmax)
    visit_order, num_steps = _grouped_visits(grid, hit_grid)

    def cond(carry):
        k, blocked = carry
        return (k < num_steps) & ~jnp.all(blocked)

    def body(carry):
        k, blocked = carry
        tri, ids = _gather_group(grid, visit_order, k)
        t, _, _, j = _block_tri_test(o, d, tri, det_eps, tmin, tmax)
        idx = ids[j]
        blocked = blocked | ((t < F32_MAX) & (idx >= 0))
        return k + 1, blocked

    _, blocked = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), jnp.zeros((r,), bool))
    )
    return blocked
