"""raytracinginonesemester_tpu — a JAX ray-tracing framework.

A ground-up JAX/XLA/Pallas re-design with the capabilities of the
AME/EEE 598 "Ray Tracing in One Semester" reference repository
(``nirajbabar/raytracinginonesemester``): OBJ meshes, JSON scene graphs,
physical pinhole cameras, Lambert+Blinn-Phong BRDF, soft shadows, an
iterative path integrator, an LBVH acceleration structure, and PNG/PPM
output — formulated as batched array programs sharded over device
meshes instead of per-pixel CUDA threads.

Layering (bottom -> top), mirroring the reference layer map in SURVEY.md:

- ``core``     — vec math, camera, bit-compatible RNG
- ``io``       — OBJ loading, PNG/PPM codecs
- ``scene``    — JSON scene configs (both reference dialects), transforms,
                 materials/lights, device scene building
- ``ops``      — intersection, BRDF, shading, integrator, LBVH
- ``render``   — whole-image render drivers
- ``parallel`` — device-mesh sharding of the pixel axis
- ``diff``     — differentiable rendering utilities
- ``viz``      — BVH wireframe export and previews
"""

__version__ = "0.1.0"

from .core.camera import Camera
from .scene.build import Scene, build_scene, load_scene
from .scene.config import SceneConfig, load_scene_config
from .render.renderer import render_hw1, render_scene, render_scene_frames

__all__ = [
    "Camera",
    "Scene",
    "SceneConfig",
    "build_scene",
    "load_scene",
    "load_scene_config",
    "render_hw1",
    "render_scene",
    "render_scene_frames",
]
