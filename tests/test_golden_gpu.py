"""Golden-image tests: full scene pipeline vs the GPUandCPU reference.

Goldens in ``tests/goldens/gpu_*.png`` were produced by building the
reference ``HW2/HW2/GPUandCPU`` project in its CPU configuration
(``-DENABLE_GPU=OFF``, with ``-D__device__=`` to patch the reference's
missing guard in ``antialias.h:30``) and running ``bvh_viz`` on the scene
JSONs in ``tests/assets/scenes``.  The CPU render path
(``query.cu:130-166``) is fully deterministic: mt19937(42) jitter shared
across pixels + per-(pixel,sample) hash-seeded rng — which our
``jitter_mode="reference_cpu"`` and bit-compatible RNG reproduce, so these
compare brute-force-vs-BVH as well as shading/integration semantics.
"""

import numpy as np
import pytest

from raytracinginonesemester_tpu.io.image import quantize, read_png
from raytracinginonesemester_tpu.render.renderer import render_scene
from raytracinginonesemester_tpu.scene.build import load_scene

from conftest import REPO, assert_images_close

SCENES = REPO / "tests/assets/scenes"
GOLDENS = REPO / "tests/goldens"


def _run(scene_name: str) -> np.ndarray:
    scene = load_scene(str(SCENES / f"{scene_name}.json"))
    assert scene.dialect == "gpu"
    img = render_scene(scene, jitter_mode="reference_cpu")
    return quantize(np.asarray(img), "gpu")


def test_gpu_spheres_golden():
    """Deterministic mirror-only scene: spheres + rotated cube + ground,
    4 bounces, 2 spp, hard shadows."""
    ours = _run("gpu_spheres")
    golden = read_png(str(GOLDENS / "gpu_spheres.png"))
    assert_images_close(ours, golden, context="gpu_spheres")


def test_gpu_diffuse_golden():
    """Russian-roulette diffuse bounces + two lights: exercises the
    bit-compatible per-ray RNG stream through the full integrator."""
    ours = _run("gpu_diffuse")
    golden = read_png(str(GOLDENS / "gpu_diffuse.png"))
    assert_images_close(ours, golden, context="gpu_diffuse")


def test_gpu_frog_golden():
    """The flagship frog workload (frog.json semantics) vs the oracle,
    through the XLA block path."""
    ours = _run("gpu_frog")
    golden = read_png(str(GOLDENS / "gpu_frog.png"))
    assert_images_close(ours, golden, context="gpu_frog")


def test_gpu_frog_golden_pallas():
    """Same frame through the Triton traversal kernels (interpret mode on
    CPU): the full integrator must match the oracle too."""
    import dataclasses

    scene = load_scene(str(SCENES / "gpu_frog.json"))
    scene = dataclasses.replace(scene, use_pallas=True, interpret=True)
    img = render_scene(scene, jitter_mode="reference_cpu")
    ours = quantize(np.asarray(img), "gpu")
    golden = read_png(str(GOLDENS / "gpu_frog.png"))
    assert_images_close(ours, golden, context="gpu_frog pallas")


def test_gpu_cornell_golden():
    """Enclosed Cornell-box scene (Embree cornellbox.obj: 9 o/g groups
    in ONE obj sharing the node material, exactly main.cu:184-186) with
    a mirror ball + diffuse ball: most camera rays hit, RR bounce
    chains run deep, and interreflection exercises the bounce-phase
    traversal very differently from the open frog scenes."""
    ours = _run("gpu_cornell")
    golden = read_png(str(GOLDENS / "gpu_cornell.png"))
    assert_images_close(ours, golden, context="gpu_cornell")


def test_gpu_cornell_golden_pallas():
    """Same enclosed scene through the Triton traversal kernels."""
    import dataclasses

    scene = load_scene(str(SCENES / "gpu_cornell.json"))
    scene = dataclasses.replace(scene, use_pallas=True, interpret=True)
    img = render_scene(scene, jitter_mode="reference_cpu")
    ours = quantize(np.asarray(img), "gpu")
    golden = read_png(str(GOLDENS / "gpu_cornell.png"))
    assert_images_close(ours, golden, context="gpu_cornell pallas")
