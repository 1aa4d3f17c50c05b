"""Multi-device rendering: pixel data-parallelism + triangle model-parallelism.

The reference's only execution-parallelism axis is CUDA pixel threads in
16x16 blocks (``query.cu:31-33``, ``buffers.h:6-7``).  The scale-out
restates that axis as a device mesh:

- **data axis** — the pixel/ray batch is sharded across devices with
  ``shard_map`` (each device renders its pixel rows; the image is the
  concatenation — no cross-device traffic at all during the forward
  pass), the renderer analog of data parallelism.
- **model axis** — triangle *testing* is sharded: each device culls and
  intersects only its shard of Morton-ordered triangle blocks, and
  per-ray candidates are merged with ``all_gather``/``psum`` collectives
  — the renderer analog of tensor parallelism (and the stepping stone to
  scenes larger than one device's memory).

Seeding is by absolute (pixel, sample) everywhere, so any mesh shape
produces the identical image (``core.rng`` docstring).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.integrator import trace_rays
from ..core import rng as rnglib
from ..render.renderer import (_pixel_grid, default_ray_tile,
                               resolve_jitter_mode)
from ..scene.build import Scene

__all__ = ["make_mesh", "render_scene_sharded", "shard_scene_blocks"]


def make_mesh(shape=None, axis_names=("data",), devices=None) -> Mesh:
    """Build a device mesh; default 1-D over all local devices."""
    devices = np.array(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (devices.size,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), axis_names)


def shard_scene_blocks(scene: Scene, num_shards: int) -> Scene:
    """Pad the accel's block count to a multiple of ``num_shards`` so the
    leading (block) axis can shard evenly.  Padding blocks carry empty
    AABBs (+inf/-inf) that never pass the slab test."""
    import dataclasses

    grid = scene.accel
    if grid is None:
        return scene
    l = grid.num_blocks
    pad = (-l) % num_shards
    if pad == 0:
        return scene
    inf = jnp.inf
    pad_aabb = jnp.concatenate(
        [jnp.full((3, pad), inf), jnp.full((3, pad), -inf)]
    )
    grid = dataclasses.replace(
        grid,
        tri=jnp.concatenate(
            [grid.tri, jnp.zeros((9, pad, grid.block_size), grid.tri.dtype)], axis=1
        ),
        tri_index=jnp.concatenate(
            [grid.tri_index, jnp.full((pad, grid.block_size), -1, jnp.int32)]
        ),
        obj=jnp.concatenate(
            [grid.obj, jnp.full((pad, grid.block_size), -1, jnp.int32)]
        ),
        aabb=jnp.concatenate([grid.aabb, pad_aabb], axis=1),
    )
    return dataclasses.replace(scene, accel=grid)


def render_scene_sharded(
    scene: Scene,
    mesh: Mesh,
    jitter_mode: str = "auto",
    ray_tile: Optional[int] = None,
    spp_override: Optional[int] = None,
    model_axis: Optional[str] = None,
    sample_offset: Array | int = 0,
) -> Array:
    """Render with pixels sharded over ``mesh`` axis "data" (and
    optionally triangle blocks over ``model_axis``).

    ``sample_offset`` shifts every sample's RNG stream index (the
    frame index in bench/serving loops) — same contract as
    ``render_scene``.

    Returns the full (H, W, 3) linear image (XLA inserts the final
    gather when the caller reads it un-sharded).
    """
    spp = spp_override if spp_override is not None else scene.spp
    jitter_mode = resolve_jitter_mode(scene, jitter_mode, spp)
    if ray_tile is None:
        ray_tile = default_ray_tile(scene)

    # compaction + all_to_all rebalance (parallel.wavefront_sharded)
    # engage under RT_WAVEFRONT (read here, outside jit); "0" keeps the
    # plain full-wavefront loop.  Scoped to model-sharded scenes:
    # re-permuting rays through XLA glue ops is only float-equivalent
    # (XLA reassociates (R, 3) reductions per shape/position), so
    # pure-DP keeps the bit-exactly-tiled loop that test_parallel pins
    # down.
    compacted = (
        os.environ.get("RT_WAVEFRONT", "auto") in ("1", "auto")
        and scene.accel is not None
        and int(scene.max_bounces) > 1
        and model_axis is not None
        and mesh.shape.get(model_axis, 1) > 1
    )
    return _render_sharded_staged(
        scene, mesh, jitter_mode, ray_tile, spp, model_axis, compacted,
        sample_offset=sample_offset)


@partial(
    jax.jit,
    static_argnames=("mesh", "jitter_mode", "ray_tile", "spp", "model_axis",
                     "compacted"),
)
def _render_sharded_staged(scene, mesh, jitter_mode, ray_tile, spp,
                           model_axis, compacted=False, sample_offset=0):
    """The sharded render: the integrator under ``shard_map``, pixels
    over "data" and (optionally) triangle blocks over ``model_axis``."""
    w, h = scene.camera.width, scene.camera.height
    xs, ys = _pixel_grid(w, h)
    n_data = mesh.shape["data"]
    num_rays = w * h
    padded = ((num_rays + n_data - 1) // n_data) * n_data
    if padded != num_rays:
        xs = jnp.concatenate([xs, jnp.zeros(padded - num_rays, xs.dtype)])
        ys = jnp.concatenate([ys, jnp.zeros(padded - num_rays, ys.dtype)])

    if model_axis is not None:
        scene = shard_scene_blocks(scene, mesh.shape[model_axis])

    host_offsets = None
    if jitter_mode == "reference_cpu":
        host_offsets = jnp.asarray(rnglib.jittered_samples(spp, 42, centered=True))

    # scene leaves are replicated except accel block arrays on the model axis
    def scene_spec(s: Scene):
        spec = jax.tree.map(lambda _: P(), s)
        if model_axis is not None and s.accel is not None:
            import dataclasses

            from ..ops.accel import BlockGrid

            accel_spec = BlockGrid(
                tri=P(None, model_axis, None),
                tri_index=P(model_axis, None),
                obj=P(model_axis, None),
                aabb=P(None, model_axis),
                block_size=s.accel.block_size,
            )
            spec = dataclasses.replace(spec, accel=accel_spec)
        return spec

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(scene_spec(scene), P("data"), P("data")),
        out_specs=P("data"),
        check_vma=False,
    )
    def shard_fn(scene_local: Scene, xs_l: Array, ys_l: Array) -> Array:
        n_local = xs_l.shape[0]

        def one_sample(s):
            s = s + sample_offset
            if jitter_mode == "wang":
                jx, jy = rnglib.pixel_jitter(xs_l, ys_l, s)
            elif jitter_mode == "reference_cpu":
                sc = jnp.minimum(s, spp - 1)  # offset-safe (clamp like
                # accumulate_samples; reference_cpu has spp host offsets)
                jx = jnp.broadcast_to(host_offsets[sc, 0], xs_l.shape)
                jy = jnp.broadcast_to(host_offsets[sc, 1], ys_l.shape)
            else:  # center
                jx = jnp.full(xs_l.shape, 0.5, jnp.float32)
                jy = jnp.full(ys_l.shape, 0.5, jnp.float32)
            px = xs_l.astype(jnp.float32) + jx
            py = ys_l.astype(jnp.float32) + jy
            origins, dirs = scene_local.camera.get_rays(px, py)
            seeds = rnglib.make_rng_seed(xs_l, ys_l, s)

            if compacted:
                # sort-compacted bounces + all_to_all alive rebalance
                # over the data axis (parallel.wavefront_sharded);
                # bit-identical to the tiled loop below on the same
                # backend — per-ray math never depends on placement
                from .wavefront_sharded import trace_rays_compacted

                return trace_rays_compacted(
                    origins, dirs, seeds, scene_local, model_axis,
                    "data", mesh.shape["data"])

            # tile the local rays to bound live memory
            tile = n_local if ray_tile <= 0 else min(ray_tile, n_local)
            pad_n = ((n_local + tile - 1) // tile) * tile
            args = (origins, dirs, seeds)
            if pad_n != n_local:
                args = jax.tree.map(
                    lambda a: jnp.concatenate(
                        [a, jnp.broadcast_to(a[:1], (pad_n - n_local,) + a.shape[1:])]
                    ),
                    args,
                )
            args = jax.tree.map(
                lambda a: a.reshape((pad_n // tile, tile) + a.shape[1:]), args
            )
            out = jax.lax.map(
                lambda t: trace_rays(t[0], t[1], t[2], scene_local, model_axis),
                args,
            )
            return out.reshape(pad_n, 3)[:n_local]

        accum, _ = jax.lax.scan(
            lambda acc, s: (acc + one_sample(s), None),
            jnp.zeros((n_local, 3), jnp.float32),
            jnp.arange(spp, dtype=jnp.int32),
        )
        return accum

    accum = shard_fn(scene, xs, ys)
    image = (accum[:num_rays] / float(spp)).reshape(h, w, 3)
    return image
