"""Differentiable rendering and inverse-rendering optimization.

New capability beyond the reference (its renderers are forward-only); the
north-star configuration in BASELINE.md: pixel gradients w.r.t. scene
parameters validated against finite differences, and a gradient-descent
loop recovering scene parameters from a target image.

Differentiability notes:

- the integrator's hit/shade math is plain arithmetic + gathers, which
  XLA reverse-differentiates directly;
- acceleration structures use dynamic-trip-count loops (not reverse
  differentiable), so differentiable scenes are built with
  ``accel="none"`` — the brute-force ``lax.scan`` intersector transposes
  cleanly;
- ``diffuse_bounce=False`` scenes are exactly differentiable; with
  diffuse bounces the sample directions are ``stop_gradient``-ed
  (standard detached-sampling estimator);
- visibility edges are step discontinuities: FD checks are performed on
  parameters with smooth influence (materials, lights) or away from
  silhouettes.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import Array

from ..render.renderer import render_scene
from ..scene.build import Scene

__all__ = [
    "apply_params",
    "extract_params",
    "render_loss",
    "make_train_step",
    "optimize",
]


def extract_params(scene: Scene, keys=("albedo", "emission")) -> Dict[str, Array]:
    """Pull the optimizable leaves out of a scene.

    Supported keys: material table fields (``albedo``, ``specular_color``,
    ``emission``, ``kd``, ``ks``, ``kr``, ``shininess``), light fields
    (``light_color``, ``light_intensity``, ``light_position``), geometry
    (``vertices`` — the (T, 3, 3) world-space triangle soup; north-star
    "differentiable w.r.t. vertex positions"), and camera pose
    (``camera_center`` — rigid translation of the whole camera).
    """
    out: Dict[str, Array] = {}
    for k in keys:
        if k.startswith("light_"):
            out[k] = getattr(scene.lights, k[len("light_"):])
        elif k == "vertices":
            out[k] = scene.geometry.vertices
        elif k == "camera_center":
            out[k] = scene.camera.center
        else:
            out[k] = getattr(scene.materials, k)
    return out


def apply_params(scene: Scene, params: Dict[str, Array]) -> Scene:
    """Return a scene with the given parameter leaves substituted.

    ``vertices`` requires a scene built with ``accel="none"`` — block
    grids and LBVHs bake world-space triangle copies at build time
    (``ops/accel.py``), so substituting vertices under an acceleration
    structure would silently render stale geometry.

    ``camera_center`` applies a rigid translation: the derived
    ``pixel00_loc`` moves with the center, so the viewing direction field
    is unchanged (exactly how ``camera::initialize`` responds to a pure
    ``position`` shift with ``look_at`` moved in tandem,
    ``HW1/include/camera.h:66-91``).
    """
    mat_updates = {}
    light_updates = {}
    scene_updates = {}
    for k, v in params.items():
        if k.startswith("light_"):
            light_updates[k[len("light_"):]] = v
        elif k == "vertices":
            if scene.accel is not None and not scene.differentiable:
                raise ValueError(
                    "vertex parameters need accel='none' (or a scene "
                    "built with differentiable=True, which rebuilds the "
                    "grid): acceleration structures bake triangle "
                    "copies at build time"
                )
            scene_updates["geometry"] = dataclasses.replace(
                scene.geometry, vertices=v
            )
            if scene.accel is not None:
                # detached-diff mode: rebuild the block grid from the
                # new vertices so the (stop_gradient'ed) traversal sees
                # current geometry; gradients flow through the
                # integrator's differentiable winner recompute, never
                # through the grid build
                from ..ops.accel import build_block_grid

                import jax.numpy as _jnp

                grid = build_block_grid(
                    v, _jnp.asarray(scene.geometry.num_triangles),
                    block_size=scene.accel.block_size,
                    obj_ids=scene.geometry.obj_id,
                )
                # the grid only picks winner triangles (detached
                # estimator); gradients flow through the integrator's
                # differentiable winner recompute, so detach every leaf
                # — otherwise grid tangents reach the traversal kernel,
                # which has no JVP rule
                scene_updates["accel"] = jax.tree.map(
                    jax.lax.stop_gradient, grid)
        elif k == "camera_center":
            delta = v - scene.camera.center
            scene_updates["camera"] = dataclasses.replace(
                scene.camera, center=v,
                pixel00_loc=scene.camera.pixel00_loc + delta,
            )
        else:
            mat_updates[k] = v
    materials = (
        dataclasses.replace(scene.materials, **mat_updates)
        if mat_updates
        else scene.materials
    )
    lights = (
        dataclasses.replace(scene.lights, **light_updates)
        if light_updates
        else scene.lights
    )
    return dataclasses.replace(
        scene, materials=materials, lights=lights, **scene_updates
    )


@partial(jax.jit, static_argnames=("jitter_mode", "spp_override",
                                   "ray_tile"))
def render_loss(
    params: Dict[str, Array],
    scene: Scene,
    target: Array,
    jitter_mode: str = "center",
    spp_override: Optional[int] = None,
    ray_tile: Optional[int] = None,
) -> Array:
    """Mean-squared pixel loss between the parameterized render and target.

    ``ray_tile``: rays per integrator tile; the default (None) is 0, the
    whole frame as one tile.  Under value_and_grad a tiled render
    becomes a sequential loop whose carry stacks every residual, so
    whole-frame tiling is the default; callers differentiating very large
    frames can pass a tile size (e.g. 16384) for memory headroom."""
    img = render_scene(
        apply_params(scene, params),
        jitter_mode=jitter_mode,
        spp_override=spp_override,
        ray_tile=0 if ray_tile is None else ray_tile,
    )
    return jnp.mean((img - target) ** 2)


def make_train_step(optimizer, jitter_mode: str = "center",
                    spp_override: Optional[int] = None,
                    ray_tile: Optional[int] = None):
    """Build a jitted (params, opt_state, scene, target) -> update step.

    ``optimizer`` is any optax GradientTransformation.  Gradients flow
    through the full wavefront integrator.  ``ray_tile`` passes through
    to ``render_loss`` — None = whole-frame; pass a tile size (e.g.
    16384) for memory headroom on huge frames.
    """

    @partial(jax.jit, static_argnames=())
    def step(params, opt_state, scene, target):
        loss, grads = jax.value_and_grad(
            lambda p: render_loss(
                p, scene, target, jitter_mode=jitter_mode,
                spp_override=spp_override, ray_tile=ray_tile,
            )
        )(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        import optax

        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def optimize(
    scene: Scene,
    target: Array,
    keys=("albedo",),
    steps: int = 100,
    learning_rate: float = 0.05,
    jitter_mode: str = "center",
    spp_override: Optional[int] = 1,
    init_params: Optional[Dict[str, Array]] = None,
    ray_tile: Optional[int] = None,
):
    """Gradient-descent inverse rendering; returns (params, losses)."""
    import optax

    params = init_params if init_params is not None else extract_params(scene, keys)
    opt = optax.adam(learning_rate)
    opt_state = opt.init(params)
    step = make_train_step(opt, jitter_mode, spp_override, ray_tile)
    losses = []
    for _ in range(steps):
        params, opt_state, loss = step(params, opt_state, scene, target)
        losses.append(float(loss))
    return params, losses
