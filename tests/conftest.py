"""Test configuration: run everything on a virtual 8-device CPU mesh.

The analog of the reference's CPU compile path of the CUDA sources
(``GPUandCPU/CMakeLists.txt:35-51``): the same code, exercised on a
deterministic host backend.  Sharding tests use the 8 virtual CPU devices;
the GPU path is exercised by ``chip_smoke.py`` and by tests marked
``gpu``, which skip without a card (run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``).

Must set the environment before the first ``import jax`` anywhere in the
test process.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import pathlib

import numpy as np
import pytest

import jax

from raytracinginonesemester_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache)

# persistent compile cache: keeps repeat test runs fast
enable_compile_cache(min_compile_secs=0.5)

if os.environ["JAX_PLATFORMS"] == "cpu":
    assert jax.device_count() >= 8, (
        f"expected 8 virtual CPU devices, got {jax.devices()} — backend "
        "was initialized before conftest could configure it"
    )

REPO = pathlib.Path(__file__).resolve().parent.parent
REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def repo_root() -> pathlib.Path:
    return REPO


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none (decided here, at
    run time, never at import)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (platform is {dev.platform!r})")
    return dev


def two_frog_scene(width=64, height=32, spp=1, **settings):
    """Frog + small sphere, two point lights: two materials, shadows and
    (with ``diffuse_bounce``) real bounce chains in a small frame."""
    import os as _os

    from raytracinginonesemester_tpu.scene.build import build_scene
    from raytracinginonesemester_tpu.scene.config import (SceneConfig,
                                                          SceneNodeConfig)
    from raytracinginonesemester_tpu.scene.transform import Transform

    config = SceneConfig(
        max_bounces=settings.pop("max_bounces", 4),
        spp=spp,
        diffuse_bounce=settings.pop("diffuse_bounce", False),
        camera_position=(0.0, -0.2, 0.2),
        camera_look_at=(0.0, 0.1, 0.0),
        camera_up=(0.0, 0.0, 1.0),
        focal_length_mm=45.0,
        sensor_height_mm=24.0,
        sensor_width_mm=None,
        pixel_width=width,
        pixel_height=height,
        background=("miss", (0.25, 0.45, 0.9)),
        lights=[
            dict(position=(-3.0, 0.0, 1.0), color=(1.0, 1.0, 0.0),
                 intensity=5.0, radius=0.0, shadow_samples=1),
            dict(position=(2.0, -1.0, 2.0), color=(0.2, 0.6, 1.0),
                 intensity=2.0, radius=0.0, shadow_samples=1),
        ],
        nodes=[
            SceneNodeConfig(
                name="frog",
                type="mesh",
                path=_os.path.join(REPO, "tests/assets/meshes/frog.obj"),
                transform=Transform(),
                material=dict(albedo=(0.8, 0.2, 0.2), kd=1.0, ks=0.5,
                              specular_color=(0.04, 0.04, 0.04),
                              shininess=32.0, kr=0.0),
            ),
            SceneNodeConfig(
                name="ball",
                type="mesh",
                path=_os.path.join(REPO, "tests/assets/meshes/sphere.obj"),
                transform=Transform(position=(0.05, 0.05, 0.02),
                                    scale=(0.04, 0.04, 0.04)),
                material=dict(albedo=(0.2, 0.7, 0.3), kd=0.8, ks=0.2,
                              specular_color=(0.5, 0.5, 0.5),
                              shininess=8.0, kr=0.0),
            ),
        ],
        dialect="gpu",
        **settings,
    )
    return build_scene(config)


@pytest.fixture(scope="session")
def reference_root() -> pathlib.Path:
    if not REFERENCE.exists():
        pytest.skip("reference tree not mounted")
    return REFERENCE


@pytest.fixture(scope="session")
def sphere_mesh_path(reference_root) -> str:
    return str(reference_root / "HW1/assets/meshes/sphere.obj")


@pytest.fixture(scope="session")
def frog_mesh_path(reference_root) -> str:
    return str(reference_root / "HW1/assets/meshes/frog.obj")


def assert_images_close(ours: np.ndarray, golden: np.ndarray, max_bad_frac=2e-3,
                        max_mean=0.5, context=""):
    """Quantized-image comparison tolerant of last-ulp float divergence.

    Compares uint8 images: at most ``max_bad_frac`` of channel samples may
    differ by more than 1 step, and the mean absolute difference must stay
    under ``max_mean`` steps.
    """
    assert ours.shape == golden.shape, f"{context}: shape {ours.shape} vs {golden.shape}"
    diff = np.abs(ours.astype(np.int32) - golden.astype(np.int32))
    bad_frac = float((diff > 1).mean())
    mean = float(diff.mean())
    assert bad_frac <= max_bad_frac and mean <= max_mean, (
        f"{context}: bad_frac={bad_frac:.5f} (limit {max_bad_frac}), "
        f"mean={mean:.4f} (limit {max_mean}), max={diff.max()}"
    )
