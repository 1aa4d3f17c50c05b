"""The XLA block path against brute force, the dispatch rule, and the
integrator invariants that hold whichever traversal runs.

The Triton kernels run the same equivalence cases in ``test_pallas.py``.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from raytracinginonesemester_tpu.ops.backend import (GPU_TRAVERSAL,
                                                     resolve_traversal)
from raytracinginonesemester_tpu.render.renderer import (render_scene,
                                                         render_scene_frames)
from raytracinginonesemester_tpu.scene.build import load_scene

import traversal_cases as tc
from conftest import REPO, two_frog_scene


@pytest.mark.parametrize("block_size", tc.BLOCK_SIZES)
@pytest.mark.parametrize("det_eps", tc.DET_EPS)
@pytest.mark.parametrize("query", tc.QUERIES)
@pytest.mark.parametrize("name", tc.MESHES)
def test_xla_matches_brute(name, query, det_eps, block_size):
    tc.run_matrix_case("xla", name, query, det_eps, block_size)


@pytest.mark.parametrize("n", [1, 37, 128, 129, 1000])
def test_xla_ray_padding(n):
    tc.run_padding_case("xla", n)


def test_xla_parked_rays():
    tc.run_parked_case("xla")


@pytest.mark.parametrize("query", tc.QUERIES)
def test_xla_axis_parallel(query):
    tc.run_axis_parallel_case("xla", query)


def test_xla_duplicate_tie_break():
    tc.run_duplicate_case("xla")


def test_xla_tmin_tmax_windows():
    tc.run_window_case("xla")


# --- the dispatch rule (ops.backend) ---

def test_resolver_cpu_default_is_xla():
    assert resolve_traversal(None, platform="cpu") == "xla"
    assert resolve_traversal(False, platform="cpu") == "xla"
    assert resolve_traversal(None) == "xla"  # this suite runs on the CPU


def test_resolver_gpu():
    assert resolve_traversal(None, platform="gpu") == GPU_TRAVERSAL
    assert resolve_traversal(True, platform="gpu") == "triton"
    assert resolve_traversal(False, platform="gpu") == "xla"


def test_resolver_interpret_only_on_request():
    assert resolve_traversal(True, interpret=True, platform="cpu") == \
        "interpret"
    assert resolve_traversal(None, interpret=True, platform="gpu") == \
        "interpret"
    with pytest.raises(ValueError, match="use_pallas=False"):
        resolve_traversal(False, interpret=True, platform="cpu")


def test_resolver_pallas_without_gpu_raises():
    with pytest.raises(ValueError, match="needs a GPU"):
        resolve_traversal(True, platform="cpu")


def test_resolver_unknown_platform_raises():
    for platform in ("metal", "rocm", "neuron"):
        with pytest.raises(ValueError, match="no traversal implementation"):
            resolve_traversal(None, platform=platform)


def test_render_scene_pallas_without_gpu_raises():
    scene = load_scene(str(REPO / "tests/assets/scenes/gpu_spheres.json"))
    with pytest.raises(ValueError, match="needs a GPU"):
        render_scene(dataclasses.replace(scene, use_pallas=True))


def test_cli_pallas_without_gpu_errors(tmp_path):
    from raytracinginonesemester_tpu.render.cli import main

    with pytest.raises(SystemExit) as exc:
        main([str(REPO / "tests/assets/scenes/gpu_spheres.json"),
              "--pallas", "-o", str(tmp_path / "x.png")])
    assert exc.value.code != 0


# --- integrator invariants ---

@pytest.mark.parametrize("ray_tile", [0, 512, 1000])
def test_render_scene_ray_tile_invariant(ray_tile):
    """Images are the same across ray-tile sizes (seeding by absolute
    pixel and sample; per-ray math never depends on its neighbours).
    XLA compiles each tile shape on its own and may round a few pixels
    differently in the last ulp, so the bound is 1e-6, not bit
    equality."""
    scene = two_frog_scene(width=40, height=24, spp=2, diffuse_bounce=True,
                           max_bounces=3)
    base = np.asarray(render_scene(scene, jitter_mode="wang"))
    img = np.asarray(render_scene(scene, jitter_mode="wang",
                                  ray_tile=ray_tile))
    np.testing.assert_allclose(img, base, rtol=0, atol=1e-6)
    assert (img != base).mean() < 1e-2


def test_render_scene_frames_matches_single_frames():
    """Frame f of ``render_scene_frames`` equals ``render_scene`` at
    ``sample_offset=offset + f`` bit for bit."""
    scene = two_frog_scene(width=32, height=16, diffuse_bounce=True,
                           max_bounces=3)
    frames = np.asarray(render_scene_frames(scene, 3, jitter_mode="wang",
                                            sample_offset=5))
    assert frames.shape == (3, 16, 32, 3)
    for f in range(3):
        one = np.asarray(render_scene(scene, jitter_mode="wang",
                                      spp_override=1, sample_offset=5 + f))
        np.testing.assert_array_equal(frames[f], one)


def test_gather_vjp_is_scatter_add():
    """The plain gathers' VJP accumulates duplicate indices (XLA
    scatter-add), matching a numpy bincount."""
    from raytracinginonesemester_tpu.scene.material import MaterialTable

    rs = np.random.RandomState(0)
    mats = MaterialTable.from_dicts(
        [dict(albedo=(0.1 * k, 0.2, 0.3), kd=0.5) for k in range(5)])
    obj = jnp.asarray(rs.randint(-1, 7, 300), jnp.int32)  # out of range too
    w = jnp.asarray(rs.normal(size=(300, 3)), jnp.float32)
    g = jax.grad(lambda a: jnp.sum(
        w * dataclasses.replace(mats, albedo=a).gather(obj).albedo))(
            mats.albedo)
    idx = np.clip(np.asarray(obj), 0, 4)
    ref = np.stack([np.bincount(idx, np.asarray(w)[:, c], minlength=5)
                    for c in range(3)], axis=1)
    np.testing.assert_allclose(np.asarray(g), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["albedo", "light_intensity"])
def test_detached_gradients_match_finite_differences(key):
    """Detached-traversal gradients (plain gathers, scatter-add VJP)
    match central finite differences on smooth parameters."""
    from raytracinginonesemester_tpu.core.camera import Camera
    from raytracinginonesemester_tpu.diff.inverse import (extract_params,
                                                          render_loss)

    scene = load_scene(str(REPO / "tests/assets/scenes/gpu_spheres.json"))
    cam = Camera.create(position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5),
                        up=(0, 0, 1), focal_length_mm=24.0, width=48,
                        height=27)
    scene = dataclasses.replace(scene, camera=cam, max_bounces=2, spp=1,
                                differentiable=True)
    target = jnp.full((27, 48, 3), 0.3, jnp.float32)
    params = extract_params(scene, keys=(key,))

    def loss(p):
        return render_loss(p, scene, target, jitter_mode="center",
                           spp_override=1)

    grad = np.asarray(jax.grad(loss)(params)[key]).ravel()
    base = np.asarray(params[key])
    eps = 1e-2
    for i in np.argsort(-np.abs(grad))[:3]:
        dp = np.zeros(base.size, np.float32)
        dp[i] = eps
        up = float(loss({key: jnp.asarray(base + dp.reshape(base.shape))}))
        dn = float(loss({key: jnp.asarray(base - dp.reshape(base.shape))}))
        fd = (up - dn) / (2 * eps)
        assert abs(fd - grad[i]) <= 2e-2 * abs(fd) + 1e-6, (i, fd, grad[i])


def test_chip_smoke_fails_without_gpu():
    """``chip_smoke.py`` exits non-zero on the CPU and prints no ok line."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, cwd=str(REPO),
        env={**__import__("os").environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
