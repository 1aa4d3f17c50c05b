"""Sharded rendering tests on the 8-virtual-device CPU mesh.

The core guarantee: any mesh shape produces the bit-identical image,
because RNG seeds derive from absolute (pixel, sample) coordinates
(``core.rng``) — the reshard-safety property called out in SURVEY.md.
"""

import numpy as np
import pytest

import jax

from raytracinginonesemester_tpu.parallel.sharded import (
    make_mesh,
    render_scene_sharded,
)
from raytracinginonesemester_tpu.render.renderer import render_scene
from raytracinginonesemester_tpu.scene.build import load_scene

from conftest import REPO

SCENE = str(REPO / "tests/assets/scenes/gpu_spheres.json")


@pytest.fixture(scope="module")
def scene():
    return load_scene(SCENE)


@pytest.fixture(scope="module")
def single_device_image(scene):
    return np.asarray(render_scene(scene, jitter_mode="reference_cpu"))


def test_dp8_bit_identical(scene, single_device_image):
    mesh = make_mesh((8,), ("data",))
    img = np.asarray(
        render_scene_sharded(scene, mesh, jitter_mode="reference_cpu")
    )
    np.testing.assert_array_equal(img, single_device_image)


def test_dp2_tp4_matches(scene, single_device_image):
    """Triangle-sharded (TP) rendering matches the single-device image.

    Closest-hit selection is made partition-invariant by the (t, global
    triangle id) lexicographic tie-break, so hits are identical; the
    remaining tolerance (~1e-5) covers XLA reassociating 3-element dot
    reductions differently for the per-shard array shapes.
    """
    mesh = make_mesh((2, 4), ("data", "model"))
    img = np.asarray(
        render_scene_sharded(
            scene, mesh, jitter_mode="reference_cpu", model_axis="model"
        )
    )
    np.testing.assert_allclose(img, single_device_image, atol=2e-5)


def test_dp4_tp2_matches(scene, single_device_image):
    mesh = make_mesh((4, 2), ("data", "model"))
    img = np.asarray(
        render_scene_sharded(
            scene, mesh, jitter_mode="reference_cpu", model_axis="model"
        )
    )
    np.testing.assert_allclose(img, single_device_image, atol=2e-5)


def test_uneven_pixel_count():
    """Pixel counts not divisible by the device count are padded."""
    scene = load_scene(SCENE)
    import dataclasses

    from raytracinginonesemester_tpu.core.camera import Camera

    cam = Camera.create(
        position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5), up=(0, 0, 1),
        focal_length_mm=24.0, width=33, height=7,  # 231 pixels, not /8
    )
    scene = dataclasses.replace(scene, camera=cam)
    mesh = make_mesh((8,), ("data",))
    img_s = np.asarray(render_scene_sharded(scene, mesh))
    img_r = np.asarray(render_scene(scene))
    np.testing.assert_array_equal(img_s, img_r)


def test_dryrun_multichip_entrypoint():
    import sys

    sys.path.insert(0, str(REPO))
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(8)


def test_dp8_fast_path_bit_identical():
    """DP sharding through the Triton traversal kernels (the GPU route,
    interpret mode here) must match the unsharded render bit-for-bit."""
    import dataclasses

    scene = load_scene(SCENE)
    scene = dataclasses.replace(scene, use_pallas=True, interpret=True)
    mesh = make_mesh((8,), ("data",))
    img_s = np.asarray(render_scene_sharded(scene, mesh))
    img_r = np.asarray(render_scene(scene))
    np.testing.assert_array_equal(img_s, img_r)


def test_dp8_fast_path_cpuonly_bit_identical():
    """DP sharding of a CPUOnly-dialect scene through the Triton
    traversal kernels: same bits as the unsharded render."""
    import dataclasses
    import os

    scene_path = os.path.join(
        os.path.dirname(SCENE), "cpuonly_point.json")
    scene = load_scene(scene_path)
    assert scene.dialect == "cpuonly"
    scene = dataclasses.replace(scene, use_pallas=True, interpret=True)
    mesh = make_mesh((8,), ("data",))
    img_s = np.asarray(render_scene_sharded(scene, mesh))
    img_r = np.asarray(render_scene(scene))
    np.testing.assert_array_equal(img_s, img_r)


def test_dp2_tp4_compacted_matches_plain(scene, monkeypatch):
    """The compacted + all_to_all-rebalanced staged scheduler
    (parallel.wavefront_sharded) runs the same bounce step
    (make_bounce_step) on permuted rays, so images match the plain
    full-wavefront staged loop up to XLA's shape/position-dependent
    reassociation of the glue's (R, 3) reductions (the same ~1e-5
    contract as the dp x tp vs single-device tests; bit-identity under
    permutation is a Pallas-kernel property, not an XLA-glue one) —
    and match the single-device image at that tolerance too."""
    mesh = make_mesh((2, 4), ("data", "model"))
    monkeypatch.setenv("RT_WAVEFRONT", "0")
    plain = np.asarray(render_scene_sharded(
        scene, mesh, jitter_mode="reference_cpu", model_axis="model"))
    monkeypatch.setenv("RT_WAVEFRONT", "1")
    compact = np.asarray(render_scene_sharded(
        scene, mesh, jitter_mode="reference_cpu", model_axis="model"))
    np.testing.assert_allclose(compact, plain, atol=2e-5)
    single = np.asarray(render_scene(scene, jitter_mode="reference_cpu"))
    np.testing.assert_allclose(compact, single, atol=2e-5)


def test_dp4_tp2_compacted_tiny_capacity_overflow(scene, monkeypatch):
    """A deliberately tiny alive capacity must flip the in-graph
    overflow cond (pmax'd so all shards agree) to the full-width loop
    — never drop rays."""
    from raytracinginonesemester_tpu.parallel import wavefront_sharded as ws
    from raytracinginonesemester_tpu.parallel.sharded import (
        _render_sharded_staged)

    mesh = make_mesh((4, 2), ("data", "model"))
    plain = np.asarray(_render_sharded_staged(
        scene, mesh, "reference_cpu", 16384, 1, "model", compacted=False))

    orig = ws.trace_rays_compacted

    def tiny_cap(*a, **k):
        k["capacity"] = 8
        return orig(*a, **k)

    monkeypatch.setattr(ws, "trace_rays_compacted", tiny_cap)
    # the monkeypatched fn is read at trace time inside the shard body
    compact = np.asarray(_render_sharded_staged(
        scene, mesh, "reference_cpu", 16384, 1, "model", compacted=True))
    np.testing.assert_allclose(compact, plain, atol=2e-5)
