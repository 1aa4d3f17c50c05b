"""Shared cases for the traversal equivalence tests.

Every traversal implementation (the XLA block path, the Triton kernels)
must agree with the brute-force intersector (``ops.intersect``) on hit
flags and winning triangle ids, with t equal up to op-order rounding.
``test_traversal.py`` runs the cases on the XLA block path and
``test_pallas.py`` on the Triton kernels in interpret mode.
"""

import functools

import numpy as np

import jax.numpy as jnp

from raytracinginonesemester_tpu.io.obj import load_obj, mesh_to_triangles
from raytracinginonesemester_tpu.ops.accel import (block_closest,
                                                   block_occluded,
                                                   build_block_grid)
from raytracinginonesemester_tpu.ops.intersect import (FLT_EPSILON,
                                                       intersect_closest,
                                                       occluded)
from raytracinginonesemester_tpu.ops.pallas_kernels import (
    pallas_block_closest, pallas_block_occluded)

from conftest import REPO

MESHES = ["cube", "plane_5x5", "sphere", "sphere_patchy", "cornellbox",
          "frog"]
DET_EPS = [1e-8, FLT_EPSILON]
BLOCK_SIZES = [128, 512]
QUERIES = ["closest", "occluded"]


def pad_tris(tris: np.ndarray, multiple: int = 512) -> np.ndarray:
    """Pad with degenerate point triangles (never hit) to a multiple."""
    pad = (-len(tris)) % multiple
    filler = np.broadcast_to(tris[0, 0], (pad, 3, 3))
    return np.concatenate([tris, filler]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def mesh_tris(name: str) -> np.ndarray:
    mesh, _ = load_obj(str(REPO / "tests/assets/meshes" / f"{name}.obj"))
    verts, _ = mesh_to_triangles(mesh)
    return np.asarray(verts, np.float32)


def rays_for(tris: np.ndarray, n: int = 256, seed: int = 0):
    """Rays from a shell around the mesh: half aimed at random points on
    random triangles (hits, some occluded), half random (mostly misses).
    Returns (origins, dirs, tmax) with tmax windows that cut some hits."""
    rs = np.random.RandomState(seed)
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    center, radius = 0.5 * (lo + hi), 0.5 * np.linalg.norm(hi - lo) + 1e-3
    u = rs.normal(size=(n, 3))
    o = center + 1.5 * radius * u / np.linalg.norm(u, axis=1, keepdims=True)
    b = rs.dirichlet([1.0, 1.0, 1.0], size=n // 2)
    pick = tris[rs.randint(0, len(tris), n // 2)]
    target = np.einsum("nk,nkc->nc", b, pick)
    d = np.concatenate([target - o[: n // 2], rs.normal(size=(n - n // 2, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rs.uniform(0.5, 3.0, n) * radius
    return (jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(tmax, jnp.float32))


@functools.lru_cache(maxsize=None)
def grid_for(name: str, block_size: int):
    tris = mesh_tris(name)
    padded = pad_tris(tris, max(block_size, 512))
    grid = build_block_grid(jnp.asarray(padded), jnp.asarray(len(tris)),
                            block_size=block_size)
    return padded, grid


def closest_fn(impl: str):
    if impl == "xla":
        return block_closest
    return functools.partial(pallas_block_closest, interpret=True)


def occluded_fn(impl: str):
    if impl == "xla":
        return block_occluded
    return functools.partial(pallas_block_occluded, interpret=True)


def assert_closest_matches_brute(impl, verts, grid, o, d, det_eps,
                                 tmin=1e-4):
    ref = intersect_closest(o, d, jnp.asarray(verts), tmin=tmin,
                            det_eps=det_eps)
    got = closest_fn(impl)(o, d, grid, tmin=tmin, det_eps=det_eps)
    np.testing.assert_array_equal(np.asarray(got.hit), np.asarray(ref.hit))
    np.testing.assert_array_equal(np.asarray(got.tri_idx),
                                  np.asarray(ref.tri_idx))
    # t within 1e-5 relative; barycentrics (in [0, 1]) within 1e-3: the
    # brute force and the block paths evaluate Moller-Trumbore in another
    # op order, and u, v scale that rounding by 1/det on grazing rays
    hit = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(got.t)[hit], np.asarray(ref.t)[hit],
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.u)[hit], np.asarray(ref.u)[hit],
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.asarray(got.v)[hit], np.asarray(ref.v)[hit],
                               rtol=0, atol=1e-3)
    return got


def assert_occluded_matches_brute(impl, verts, grid, o, d, tmax, det_eps,
                                  tmin=1e-4):
    ref = occluded(o, d, jnp.asarray(verts), tmin=tmin, tmax=tmax,
                   det_eps=det_eps)
    got = occluded_fn(impl)(o, d, grid, tmin=tmin, tmax=tmax,
                            det_eps=det_eps)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    return got


def run_matrix_case(impl, name, query, det_eps, block_size):
    verts, grid = grid_for(name, block_size)
    o, d, tmax = rays_for(mesh_tris(name))
    if query == "closest":
        got = assert_closest_matches_brute(impl, verts, grid, o, d, det_eps)
        assert 0 < int(np.sum(np.asarray(got.hit))) < o.shape[0]
    else:
        assert_occluded_matches_brute(impl, verts, grid, o, d, tmax, det_eps)


def run_padding_case(impl, n):
    """Ray counts that are not tile multiples pad and unpad exactly."""
    verts, grid = grid_for("sphere", 128)
    o, d, tmax = rays_for(mesh_tris("sphere"), n=max(n, 2), seed=n)
    o, d, tmax = o[:n], d[:n], tmax[:n]
    got = assert_closest_matches_brute(impl, verts, grid, o, d, 1e-8)
    assert got.t.shape == (n,)
    occ = assert_occluded_matches_brute(impl, verts, grid, o, d, tmax, 1e-8)
    assert occ.shape == (n,)


def run_parked_case(impl):
    """Rays parked at 1e30 (dead lanes, padding) never hit or block."""
    _, grid = grid_for("sphere", 128)
    o = jnp.full((70, 3), 1e30, jnp.float32)
    d = jnp.asarray(np.tile([0.0, 0.0, -1.0], (70, 1)), jnp.float32)
    hits = closest_fn(impl)(o, d, grid, tmin=1e-4)
    assert not np.asarray(hits.hit).any()
    assert (np.asarray(hits.tri_idx) == -1).all()
    assert not np.asarray(occluded_fn(impl)(o, d, grid, tmin=1e-4)).any()


def run_axis_parallel_case(impl, query):
    """Axis-parallel directions (zero components, infinite inverse
    directions in the slab tests) through the plane and the cube."""
    rs = np.random.RandomState(3)
    verts, grid = grid_for("cornellbox", 128)
    tris = mesh_tris("cornellbox")
    lo, hi = tris.reshape(-1, 3).min(0), tris.reshape(-1, 3).max(0)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    d = np.repeat(axes, 20, axis=0)
    o = rs.uniform(lo, hi, size=(len(d), 3)).astype(np.float32)
    o, d = jnp.asarray(o), jnp.asarray(d)
    if query == "closest":
        got = assert_closest_matches_brute(impl, verts, grid, o, d, 1e-8)
        assert int(np.sum(np.asarray(got.hit))) > 0
    else:
        tmax = jnp.full((len(d),), float(np.max(hi - lo)) * 0.3)
        assert_occluded_matches_brute(impl, verts, grid, o, d, tmax, 1e-8)


def run_duplicate_case(impl):
    """Coincident duplicate triangles tie on t; the smallest global id
    wins, whichever block each copy lands in."""
    tris = mesh_tris("sphere")
    dup = np.concatenate([tris, tris[::-1], tris]).astype(np.float32)
    verts = pad_tris(dup)
    grid = build_block_grid(jnp.asarray(verts), jnp.asarray(len(dup)),
                            block_size=128)
    o, d, _ = rays_for(tris, n=200, seed=5)
    got = assert_closest_matches_brute(impl, verts, grid, o, d, 1e-8)
    idx = np.asarray(got.tri_idx)[np.asarray(got.hit)]
    assert (idx < len(tris)).all(), "a later duplicate won the tie"


def run_window_case(impl):
    """tmin/tmax windows: per-ray tmin beyond the first surface finds the
    far side; occlusion honours per-ray tmax."""
    verts, grid = grid_for("sphere", 128)
    o, d, tmax = rays_for(mesh_tris("sphere"), n=160, seed=9)
    near = closest_fn("xla")(o, d, grid, tmin=1e-4)
    tmin = jnp.where(near.hit, near.t * 1.001, 1e-4)
    far = assert_closest_matches_brute(impl, verts, grid, o, d, 1e-8,
                                       tmin=tmin)
    both = np.asarray(near.hit & far.hit)
    assert both.any() and (np.asarray(far.t)[both]
                           > np.asarray(near.t)[both]).all()
    assert_occluded_matches_brute(impl, verts, grid, o, d, tmax, 1e-8,
                                  tmin=tmin)
