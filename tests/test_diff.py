"""Differentiable rendering: finite-difference gradient checks and an
inverse-rendering recovery test (the BASELINE.md gradient-correctness
gate — new capability, absent from the forward-only reference)."""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracinginonesemester_tpu.diff.inverse import (
    apply_params,
    extract_params,
    optimize,
    render_loss,
)
from raytracinginonesemester_tpu.render.renderer import render_scene
from raytracinginonesemester_tpu.scene.build import load_scene

from conftest import REPO

SCENE = str(REPO / "tests/assets/scenes/gpu_spheres.json")


@pytest.fixture(scope="module")
def scene():
    # differentiable configuration: brute-force intersector, mirror-only,
    # small frame (gradient math is resolution-independent; CPU renders
    # of the full frame would dominate suite time)
    from raytracinginonesemester_tpu.core.camera import Camera

    s = load_scene(SCENE, accel="none")
    cam = Camera.create(
        position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5), up=(0, 0, 1),
        focal_length_mm=24.0, width=96, height=54,
    )
    return dataclasses.replace(s, camera=cam, max_bounces=2, spp=1)


def test_gradients_match_finite_differences(scene):
    """d(loss)/d(albedo) via autodiff vs central finite differences.

    Albedo has smooth (non-visibility) influence on the image, so FD and
    autodiff must agree tightly.
    """
    params = extract_params(scene, keys=("albedo",))
    target = jnp.zeros(
        (scene.camera.height, scene.camera.width, 3), jnp.float32
    )

    loss_fn = lambda p: render_loss(p, scene, target, jitter_mode="center",
                                    spp_override=1)
    g = jax.grad(loss_fn)(params)["albedo"]
    g = np.asarray(g)

    eps = 1e-2
    rs = np.random.RandomState(0)
    albedo = np.array(params["albedo"])
    # probe a few (material, channel) coordinates
    for _ in range(4):
        m = rs.randint(albedo.shape[0])
        c = rs.randint(3)
        ap = albedo.copy(); ap[m, c] += eps
        am = albedo.copy(); am[m, c] -= eps
        lp = float(loss_fn({"albedo": jnp.asarray(ap)}))
        lm = float(loss_fn({"albedo": jnp.asarray(am)}))
        fd = (lp - lm) / (2 * eps)
        assert g[m, c] == pytest.approx(fd, rel=5e-2, abs=1e-5), (m, c)


def test_light_gradients_finite_differences(scene):
    params = extract_params(scene, keys=("light_intensity",))
    target = jnp.zeros((scene.camera.height, scene.camera.width, 3), jnp.float32)
    loss_fn = lambda p: render_loss(p, scene, target, jitter_mode="center",
                                    spp_override=1)
    g = float(jax.grad(loss_fn)(params)["light_intensity"][0])
    eps = 1e-2
    base = np.array(params["light_intensity"])
    lp = float(loss_fn({"light_intensity": jnp.asarray(base + eps)}))
    lm = float(loss_fn({"light_intensity": jnp.asarray(base - eps)}))
    fd = (lp - lm) / (2 * eps)
    assert g == pytest.approx(fd, rel=5e-2)


@pytest.mark.slow
def test_inverse_rendering_recovers_albedo(scene):
    """Perturb the albedo table, then recover it by gradient descent on
    the pixel loss against the original render."""
    target = render_scene(scene, jitter_mode="center", spp_override=1)

    true_albedo = np.array(scene.materials.albedo)
    rs = np.random.RandomState(1)
    init = jnp.asarray(
        np.clip(true_albedo + rs.uniform(-0.25, 0.25, true_albedo.shape), 0.05, 1.0),
        jnp.float32,
    )
    params, losses = optimize(
        scene, target, keys=("albedo",), steps=60, learning_rate=0.03,
        init_params={"albedo": init}, spp_override=1,
    )
    assert losses[-1] < losses[0] * 0.05, losses[::10]
    # visible materials converge toward the truth
    final = render_scene(
        apply_params(scene, params), jitter_mode="center", spp_override=1
    )
    err = float(jnp.mean(jnp.abs(final - target)))
    assert err < 5e-3


@pytest.fixture(scope="module")
def scene_detached():
    """Same configuration as ``scene`` but block-accelerated with the
    detached-traversal differentiable mode (Scene.differentiable)."""
    from raytracinginonesemester_tpu.core.camera import Camera

    s = load_scene(SCENE, accel="blocks")
    cam = Camera.create(
        position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5), up=(0, 0, 1),
        focal_length_mm=24.0, width=96, height=54,
    )
    return dataclasses.replace(s, camera=cam, max_bounces=2, spp=1,
                               differentiable=True, use_pallas=False)


def test_detached_traversal_gradients_match_brute(scene, scene_detached,
                                                  monkeypatch):
    """The detached-traversal mode (fast block traversal under
    stop_gradient + differentiable winner recompute) must produce the
    EXACT forward image of the non-differentiable block-accel path on
    the same backend — the ``a + (b - stop_gradient(b))`` passthrough
    keeps the primal t/u/v bit-for-bit — and closely matching gradients
    vs the brute-force differentiable path (identical estimator: the
    discrete winner choice carries no gradient in either).

    Tolerance contract: brute (accel='none') and block-accel t/u/v are
    computed with different op orders, so their images legitimately
    differ by FMA/vectorization reassociation amplified through shading
    (measured ~4e-6 on 2/15552 pixels) — the brute comparison is
    therefore loose (1e-5).  The block-vs-detached comparison is exact
    (atol=0) UNDER MATCHED LOOP STRUCTURE: the a + (b - sg(b))
    passthrough is bit-exact per-op, but the production detached path
    UNROLLS its bounce loop (the scan's backward cost, see
    ops/integrator.py), which lets XLA fuse across iteration
    boundaries — a different (still correct) contraction, checked at
    fusion tolerance (1e-6)."""
    fwd_brute = render_scene(scene, jitter_mode="center", spp_override=1)
    fwd_det = render_scene(scene_detached, jitter_mode="center",
                           spp_override=1)
    scene_blocks = dataclasses.replace(scene_detached, differentiable=False)
    fwd_blocks = render_scene(scene_blocks, jitter_mode="center",
                              spp_override=1)
    np.testing.assert_allclose(np.asarray(fwd_det),
                               np.asarray(fwd_blocks), rtol=0, atol=1e-6)
    # matched loop structure (scan, like the non-diff while body): the
    # unroll bound is read at trace time, so patch the module constant —
    # monkeypatch restores it, and the replaced spp forges a fresh jit key
    import raytracinginonesemester_tpu.ops.integrator as integ

    monkeypatch.setattr(integ, "DIFF_UNROLL_MAX_DEPTH", 0)
    fwd_det_scan = render_scene(
        dataclasses.replace(scene_detached, spp=2),  # new jit key
        jitter_mode="center", spp_override=1)
    monkeypatch.undo()
    np.testing.assert_array_equal(np.asarray(fwd_det_scan),
                                  np.asarray(fwd_blocks))
    np.testing.assert_allclose(np.asarray(fwd_det), np.asarray(fwd_brute),
                               rtol=0, atol=1e-5)

    target = jnp.zeros((54, 96, 3), jnp.float32)
    for keys in (("albedo",), ("light_intensity",), ("vertices",)):
        pb = extract_params(scene, keys=keys)
        pd = extract_params(scene_detached, keys=keys)
        gb = jax.grad(lambda p: render_loss(
            p, scene, target, jitter_mode="center", spp_override=1))(pb)
        gd = jax.grad(lambda p: render_loss(
            p, scene_detached, target, jitter_mode="center",
            spp_override=1))(pd)
        for k in keys:
            a, b = np.asarray(gb[k]), np.asarray(gd[k])
            scale = max(np.abs(a).max(), 1e-8)
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                       err_msg=k)


def test_detached_traversal_gradients_pallas_path(scene, scene_detached):
    """Detached-diff must also work on the Pallas traversal path (the
    GPU default): the closest-hit query AND the occlusion query run
    under stop_gradient, so no tangents ever reach a pallas_call (which
    has no JVP rule).  Gradients must match the brute-force estimator
    just like the XLA block path does.

    Exercised in interpret mode (this suite is CPU); on a GPU the same
    code path compiles for real."""
    scene_pl = dataclasses.replace(scene_detached, use_pallas=True,
                                   interpret=True)
    target = jnp.zeros((54, 96, 3), jnp.float32)
    for keys in (("albedo",), ("vertices",)):
        pb = extract_params(scene, keys=keys)
        pp = extract_params(scene_pl, keys=keys)
        gb = jax.grad(lambda p: render_loss(
            p, scene, target, jitter_mode="center", spp_override=1))(pb)
        gp = jax.grad(lambda p: render_loss(
            p, scene_pl, target, jitter_mode="center",
            spp_override=1))(pp)
        for k in keys:
            a, b = np.asarray(gb[k]), np.asarray(gp[k])
            scale = max(np.abs(a).max(), 1e-8)
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-4 * scale,
                                       err_msg=k)
