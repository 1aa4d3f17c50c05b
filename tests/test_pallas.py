"""The Triton traversal kernels (interpret mode on the CPU) against brute
force, and their traversal plan.

The analog of the reference's single-source CPU/GPU duality
(``GPUandCPU/CMakeLists.txt:35-51``): the kernel body that compiles for
the GPU runs here through the Pallas interpreter and must agree with the
brute-force intersector.  Tests marked ``gpu`` compile it for the card.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from raytracinginonesemester_tpu.ops.accel import (build_block_grid,
                                                   tile_visit_plan,
                                                   tile_visit_plan_fast)
from raytracinginonesemester_tpu.ops.intersect import F32_MAX
from raytracinginonesemester_tpu.ops.pallas_kernels import (
    RAY_TILE, pallas_block_closest, pallas_block_occluded)

import traversal_cases as tc


@pytest.mark.parametrize("block_size", tc.BLOCK_SIZES)
@pytest.mark.parametrize("det_eps", tc.DET_EPS)
@pytest.mark.parametrize("query", tc.QUERIES)
@pytest.mark.parametrize("name", tc.MESHES)
def test_pallas_matches_brute(name, query, det_eps, block_size):
    tc.run_matrix_case("interpret", name, query, det_eps, block_size)


@pytest.mark.parametrize("n", [1, 37, 128, 129, 1000])
def test_pallas_ray_padding(n):
    tc.run_padding_case("interpret", n)


def test_pallas_parked_rays():
    tc.run_parked_case("interpret")


@pytest.mark.parametrize("query", tc.QUERIES)
def test_pallas_axis_parallel(query):
    tc.run_axis_parallel_case("interpret", query)


def test_pallas_duplicate_tie_break():
    tc.run_duplicate_case("interpret")


def test_pallas_tmin_tmax_windows():
    tc.run_window_case("interpret")


def test_pallas_rejects_unchunkable_block_size():
    tris = jnp.asarray(tc.pad_tris(tc.mesh_tris("cube"), 24))
    grid = build_block_grid(tris, jnp.asarray(12), block_size=24)
    o = jnp.zeros((4, 3), jnp.float32)
    with pytest.raises(ValueError, match="multiple of"):
        pallas_block_closest(o, o + 1.0, grid, interpret=True)


def test_interval_plan_superset_of_exact():
    """tile_visit_plan_fast must visit a superset of the exact per-ray
    plan's superblocks, with entry distances that lower-bound the exact
    entries — the two properties that make it a drop-in conservative
    replacement (identical kernel results)."""
    rs = np.random.RandomState(0)
    tris = jnp.asarray(
        (rs.uniform(-4, 4, (1024, 1, 3)) + rs.uniform(-0.4, 0.4, (1024, 3, 3)))
        .astype(np.float32))
    grid = build_block_grid(tris, jnp.asarray(1000), block_size=16)
    # a coherent tile (shared origin, small cone) + incoherent rays
    o = rs.uniform(-6, 6, (RAY_TILE * 3, 3)).astype(np.float32)
    d = rs.normal(size=(RAY_TILE * 3, 3)).astype(np.float32)
    o[:RAY_TILE] = [0.0, 0.0, -6.0]
    d[:RAY_TILE] = np.concatenate(
        [rs.uniform(-0.2, 0.2, (RAY_TILE, 2)), np.ones((RAY_TILE, 1))], 1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = len(o)
    a = (jnp.asarray(o), jnp.asarray(d), grid, jnp.full((r,), 1e-4),
         jnp.full((r,), F32_MAX), RAY_TILE)
    e_order, e_entry, _ = (np.asarray(x) for x in tile_visit_plan(*a))
    f_order, f_entry, _ = (np.asarray(x) for x in tile_visit_plan_fast(*a))
    for ti in range(e_order.shape[0]):
        exact = {int(s): float(t) for s, t in zip(e_order[ti], e_entry[ti])
                 if np.isfinite(t)}
        fast = {int(s): float(t) for s, t in zip(f_order[ti], f_entry[ti])
                if np.isfinite(t)}
        assert exact, f"tile {ti} plans nothing"
        assert set(exact) <= set(fast), f"tile {ti} lost superblocks"
        for s, t in exact.items():
            assert fast[s] <= t + 1e-5, f"tile {ti} super {s} entry not a lower bound"


def test_interval_plan_parked_tile_empty():
    """A tile whose rays are all parked (origin 1e30) must plan nothing."""
    rs = np.random.RandomState(1)
    tris = jnp.asarray(
        (rs.uniform(-4, 4, (128, 1, 3)) + rs.uniform(-0.4, 0.4, (128, 3, 3)))
        .astype(np.float32))
    grid = build_block_grid(tris, jnp.asarray(128), block_size=128)
    o = jnp.full((512, 3), 1e30, jnp.float32)
    d = jnp.ones((512, 3), jnp.float32)
    _, entry, count = tile_visit_plan_fast(
        o, d, grid, jnp.full((512,), 1e-4), jnp.full((512,), 3.4e38), 512)
    assert int(np.asarray(count)[0, 0]) == 0
    assert not np.isfinite(np.asarray(entry)).any()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["sphere", "frog"])
def test_compiled_kernels_match_brute(gpu_device, name):
    """The kernels compiled for the card agree with brute force."""
    verts, grid = tc.grid_for(name, 512)
    o, d, tmax = tc.rays_for(tc.mesh_tris(name), n=4096)
    ref = tc.intersect_closest(o, d, jnp.asarray(verts), tmin=1e-4)
    got = pallas_block_closest(o, d, grid, tmin=1e-4)
    np.testing.assert_array_equal(np.asarray(got.tri_idx),
                                  np.asarray(ref.tri_idx))
    occ = pallas_block_occluded(o, d, grid, tmin=1e-4, tmax=tmax)
    np.testing.assert_array_equal(
        np.asarray(occ),
        np.asarray(tc.occluded(o, d, jnp.asarray(verts), tmin=1e-4,
                               tmax=tmax)))
