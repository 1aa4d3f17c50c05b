"""Geometry / camera gradients and edge-aware visibility gradients.

North-star coverage (BASELINE.md): "differentiable w.r.t. vertex
positions, materials, and camera ... with edge-aware visibility
gradients".  Interior (smooth) terms are FD-checked through the hard
renderer; silhouette terms are FD-checked through ``diff.soft`` (the
hard render's boundary contribution is a measure-zero event that
autodiff cannot see — the soft renderer exists exactly for that).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracinginonesemester_tpu.core.camera import Camera
from raytracinginonesemester_tpu.diff.inverse import apply_params, extract_params
from raytracinginonesemester_tpu.diff.soft import render_soft, soft_render_loss
from raytracinginonesemester_tpu.render.renderer import render_scene
from raytracinginonesemester_tpu.scene.build import Scene, geometry_from_mesh
from raytracinginonesemester_tpu.scene.material import Lights, MaterialTable


def _tri_scene(width=64, height=36, shift=(0.0, 0.0, 0.0)):
    """One large triangle facing the camera, diffuse-only, point light."""
    shift = np.asarray(shift, np.float32)
    verts = np.array(
        [[[-1.2, 2.0, -1.0], [1.2, 2.0, -1.0], [0.0, 2.0, 1.4]]],
        np.float32,
    ) + shift
    # stored shading normals: the face normal (toward the camera at -y)
    n = np.array([0.0, -1.0, 0.0], np.float32)
    normals = np.broadcast_to(n, (1, 3, 3)).copy()
    geometry = geometry_from_mesh(verts, normals, pad_to=8)
    camera = Camera.create(
        position=(0.0, -1.5, 0.0), look_at=(0.0, 1.0, 0.0), up=(0, 0, 1),
        focal_length_mm=24.0, width=width, height=height,
    )
    return Scene(
        geometry=geometry,
        materials=MaterialTable.from_dicts(
            [dict(albedo=(0.7, 0.3, 0.2), kd=1.0, ks=0.2)]
        ),
        lights=Lights.from_dicts(
            [dict(position=(-2.0, -2.0, 2.0), color=(1.0, 1.0, 1.0),
                  intensity=4.0)]
        ),
        camera=camera,
        max_bounces=1,
        spp=1,
        diffuse_bounce=False,
        background_kind="miss",
        dialect="gpu",
        miss_color=jnp.asarray([0.1, 0.1, 0.3], jnp.float32),
        accel=None,
    )


def _interior_loss(scene_builder, params, apply, h, w):
    """MSE over a center crop — pixels strictly inside the triangle, so
    vertex/camera motion has smooth (non-silhouette) influence only."""
    img = apply(params)
    crop = img[h // 2 - 4: h // 2 + 4, w // 2 - 4: w // 2 + 4]
    return jnp.mean(crop ** 2)


def test_vertex_gradients_interior_fd():
    """d(loss)/d(vertex) via autodiff vs FD through the HARD renderer,
    probing the triangle's y (depth) — interior shading changes smoothly
    (hit point, light distance, ndotl), no silhouette crossing in the
    center crop."""
    scene = _tri_scene()
    h, w = scene.camera.height, scene.camera.width

    def loss(v):
        s = apply_params(scene, {"vertices": v})
        img = render_scene(s, jitter_mode="center", spp_override=1)
        crop = img[h // 2 - 4: h // 2 + 4, w // 2 - 4: w // 2 + 4]
        return jnp.mean(crop ** 2)

    v0 = scene.geometry.vertices
    g = np.asarray(jax.grad(loss)(v0))

    eps = 1e-3
    for (ti, vi, ci) in [(0, 0, 1), (0, 2, 1), (0, 1, 2)]:
        vp = np.array(v0); vp[ti, vi, ci] += eps
        vm = np.array(v0); vm[ti, vi, ci] -= eps
        fd = (float(loss(jnp.asarray(vp))) - float(loss(jnp.asarray(vm)))) / (
            2 * eps)
        assert g[ti, vi, ci] == pytest.approx(fd, rel=5e-2, abs=1e-6), (
            ti, vi, ci)


def test_camera_center_gradients_fd():
    scene = _tri_scene()
    h, w = scene.camera.height, scene.camera.width

    def loss(c):
        s = apply_params(scene, {"camera_center": c})
        img = render_scene(s, jitter_mode="center", spp_override=1)
        crop = img[h // 2 - 4: h // 2 + 4, w // 2 - 4: w // 2 + 4]
        return jnp.mean(crop ** 2)

    c0 = scene.camera.center
    g = np.asarray(jax.grad(loss)(c0))
    eps = 1e-3
    for ci in range(3):
        cp = np.array(c0); cp[ci] += eps
        cm = np.array(c0); cm[ci] -= eps
        fd = (float(loss(jnp.asarray(cp))) - float(loss(jnp.asarray(cm)))) / (
            2 * eps)
        assert g[ci] == pytest.approx(fd, rel=5e-2, abs=1e-6), ci


def test_soft_render_converges_to_hard():
    """As sigma, gamma -> 0 the soft image approaches the hard render
    (away from the blurred edge band)."""
    scene = _tri_scene()
    hard = np.asarray(render_scene(scene, jitter_mode="center",
                                   spp_override=1))
    soft = np.asarray(render_soft(scene, sigma=1e-4, gamma=1e-3))
    diff = np.abs(hard - soft).max(axis=-1)
    # nearly all pixels match; the tolerance band is the silhouette ring
    assert (diff < 2e-2).mean() > 0.97
    assert np.median(diff) < 1e-3


def test_soft_edge_gradients_fd():
    """Silhouette gradients: FD of the SOFT loss w.r.t. a vertex motion
    that moves the triangle's edge matches autodiff of the soft loss —
    and is materially nonzero (the hard renderer's autodiff misses this
    boundary term entirely)."""
    scene = _tri_scene()
    target = jnp.zeros(
        (scene.camera.height, scene.camera.width, 3), jnp.float32)

    def loss(v):
        return soft_render_loss({"vertices": v}, scene, target,
                                sigma=0.02, shadows="none")

    v0 = scene.geometry.vertices
    g = np.asarray(jax.grad(loss)(v0))

    eps = 2e-3
    checked = 0
    for (ti, vi, ci) in [(0, 0, 0), (0, 1, 0), (0, 2, 2)]:
        vp = np.array(v0); vp[ti, vi, ci] += eps
        vm = np.array(v0); vm[ti, vi, ci] -= eps
        fd = (float(loss(jnp.asarray(vp))) - float(loss(jnp.asarray(vm)))) / (
            2 * eps)
        assert g[ti, vi, ci] == pytest.approx(fd, rel=8e-2, abs=1e-7), (
            ti, vi, ci)
        if abs(fd) > 1e-5:
            checked += 1
    assert checked >= 2, "edge motion should produce nonzero gradients"


def test_soft_inverse_recovers_translation():
    """Recover a silhouette translation by gradient descent on the soft
    loss — impossible with interior-only (hard) gradients when the
    shading is flat."""
    import optax

    true_scene = _tri_scene(width=48, height=27)
    target = render_soft(true_scene, sigma=0.02, shadows="none")

    start = _tri_scene(width=48, height=27, shift=(0.35, 0.0, 0.25))
    v = start.geometry.vertices
    opt = optax.adam(0.05)
    params = {"vertices": v}
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(
            lambda p: soft_render_loss(p, start, target, sigma=0.02,
                                       shadows="none")
        )(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for _ in range(120):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.1, losses[::20]

    # the optimized triangle's centroid moved back toward the truth
    true_c = np.asarray(true_scene.geometry.vertices[0]).mean(axis=0)
    got_c = np.asarray(params["vertices"][0]).mean(axis=0)
    start_c = np.asarray(start.geometry.vertices[0]).mean(axis=0)
    assert np.linalg.norm(got_c - true_c) < 0.5 * np.linalg.norm(
        start_c - true_c)


def test_vertex_params_require_no_accel():
    from raytracinginonesemester_tpu.scene.build import load_scene
    from conftest import REPO

    s = load_scene(str(REPO / "tests/assets/scenes/gpu_spheres.json"),
                   accel="blocks")
    with pytest.raises(ValueError, match="accel"):
        apply_params(s, {"vertices": s.geometry.vertices})


def test_extract_params_geometry_camera_roundtrip():
    scene = _tri_scene()
    p = extract_params(scene, keys=("vertices", "camera_center", "albedo"))
    assert p["vertices"].shape == scene.geometry.vertices.shape
    assert p["camera_center"].shape == (3,)
    s2 = apply_params(scene, p)
    # identity substitution: the render is unchanged
    a = render_scene(scene, jitter_mode="center", spp_override=1)
    b = render_scene(s2, jitter_mode="center", spp_override=1)
    assert np.allclose(np.asarray(a), np.asarray(b))
