"""Golden images vs the compiled CPUOnly reference renderer.

The oracle is the reference ``CPUOnly`` C++ renderer
(``HW2/HW2/CPUOnly/src/render.cpp``), built offline (see the verify
skill: hand-compiled with g++, nlohmann/json.hpp taken from the
tensorflow wheel's vendored copy; the renderer does not create its
``output/`` directory — mkdir first).

CPUOnly's RNG is an unseeded mt19937 (``raytracer.h:12-16``), so only
configurations that never *branch* on it are deterministic:
``samples_per_pixel == 1`` (exact pixel centers,
``render.cpp:127-128``), ``radius == 0`` point lights (no disk
sampling), and ``diffuse_bounce == false`` (the RR draw at
``raytracer.h:242`` happens but cannot change the branch).  Mirror
chains stay fully deterministic, so these goldens cover the terminal
AND mirror paths of the dialect against the real C++.

The XLA block path and the Triton traversal kernels (interpret mode on
the CPU) both reproduce the oracle byte-for-byte.
"""

import dataclasses
import os

import numpy as np
import pytest

from raytracinginonesemester_tpu.io.image import read_png, write_png
from raytracinginonesemester_tpu.render.renderer import render_scene
from raytracinginonesemester_tpu.scene.build import load_scene

HERE = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(HERE, "assets", "scenes")
GOLDENS = os.path.join(HERE, "goldens")


def _compare(name, pallas, tmp_path, max_diff):
    scene = load_scene(os.path.join(SCENES, f"{name}.json"))
    assert scene.dialect == "cpuonly"
    scene = dataclasses.replace(scene, use_pallas=pallas, interpret=pallas)
    img = np.asarray(render_scene(scene))
    out = str(tmp_path / "out.png")
    write_png(out, img, mode="cpuonly")
    ours = read_png(out).astype(int)
    gold = read_png(os.path.join(GOLDENS, f"{name}.png")).astype(int)
    d = np.abs(ours - gold)
    assert d.max() <= max_diff, f"max channel diff {d.max()}"


@pytest.mark.parametrize("name", ["cpuonly_point", "cpuonly_mirror"])
def test_cpuonly_golden_staged(name, tmp_path):
    """Staged XLA path: byte-exact against the C++ oracle."""
    _compare(name, pallas=False, tmp_path=tmp_path, max_diff=0)


@pytest.mark.parametrize("name", ["cpuonly_point", "cpuonly_mirror"])
def test_cpuonly_golden_pallas(name, tmp_path):
    """Triton traversal kernels (interpret mode): byte-exact too."""
    _compare(name, pallas=True, tmp_path=tmp_path, max_diff=0)
