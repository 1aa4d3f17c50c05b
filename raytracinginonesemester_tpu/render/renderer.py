"""Top-level render drivers: whole-image wavefront rendering under ``jit``.

Replacement for the reference's render entry points:

- ``HW1/src/render.cpp:15-136`` — brute-force single-bounce renderer,
- ``CPUOnly/src/render.cpp:22-169`` — recursive tracer driver,
- ``GPUandCPU/include/query.cu:10-167`` — ``renderBatchCUDA`` pixel-thread
  kernel + sample batching, and its CPU fallback loop.

Design: rays for the whole image are generated in one batched op, tiled
into fixed-size wavefronts (``lax.map`` over ray tiles bounds peak memory
the way the reference's 16x16 CUDA blocks bound register pressure), with
the sample loop as a ``lax.scan`` accumulating into the image — the analog
of the reference's 32-sample register batches (``query.cu:39-65``).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..core import rng as rnglib
from ..core.camera import Camera
from ..ops import shading
from ..ops.backend import resolve_traversal
from ..ops.integrator import trace_rays
from ..ops.intersect import FLT_EPSILON, intersect_closest, make_hit_frame
from ..scene.build import Scene

__all__ = ["render_scene", "render_scene_frames", "render_hw1",
           "DEFAULT_RAY_TILE", "KERNEL_RAY_TILE", "default_ray_tile"]

# Rays per wavefront tile (``lax.map`` over tiles bounds peak memory),
# chosen on the H100 (PERF.md).  The XLA block path and the brute force
# materialise (tile, triangles) temporaries and run best at 16384 rays;
# the Triton kernels keep per-ray state in registers and run best on the
# whole frame (0).
DEFAULT_RAY_TILE = 16384
KERNEL_RAY_TILE = 0


def default_ray_tile(scene: Scene) -> int:
    """The ray tile ``ray_tile=None`` means for this scene's traversal."""
    if scene.accel is not None and resolve_traversal(
            scene.use_pallas, scene.interpret) != "xla":
        return KERNEL_RAY_TILE
    return DEFAULT_RAY_TILE


def _pixel_grid(width: int, height: int):
    ys, xs = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.int32),
        jnp.arange(width, dtype=jnp.int32),
        indexing="ij",
    )
    return xs.reshape(-1), ys.reshape(-1)


def _swizzled_grid(width: int, height: int, tile: int = 16):
    """Pixel indices in tile-major (16x16) order over a tile-padded frame.

    Spatially-coherent ray tiles are what make the traversal kernels'
    per-tile culling effective — the analog of the reference's 16x16
    CUDA thread blocks (``buffers.h:6-7``, ``query.cu:31-33``).  The
    frame pads to tile multiples (wp, hp) so the inverse mapping is a
    pure reshape/transpose (``_unswizzle``) instead of a 2M-element
    gather; the <2% padded pixels trace sky rays and are cropped.
    Because RNG seeds derive from absolute (x, y), any pixel order
    produces the identical image.
    """
    wp = -(-width // tile) * tile
    hp = -(-height // tile) * tile
    ys, xs = np.mgrid[0:hp, 0:wp]

    def swz(a):
        return (
            a.reshape(hp // tile, tile, wp // tile, tile)
            .transpose(0, 2, 1, 3)
            .ravel()
        )

    return (
        jnp.asarray(swz(xs), jnp.int32),
        jnp.asarray(swz(ys), jnp.int32),
        (hp, wp),
    )


def _unswizzle(accum: Array, width: int, height: int, hp: int, wp: int,
               tile: int = 16) -> Array:
    """(hp*wp, C) tile-major -> (height, width, C) scanline, by reshape."""
    c = accum.shape[-1]
    img = (
        accum.reshape(hp // tile, wp // tile, tile, tile, c)
        .transpose(0, 2, 1, 3, 4)
        .reshape(hp, wp, c)
    )
    return img[:height, :width]


def _tile_map(fn, args, num_rays: int, tile: int):
    """Apply ``fn`` over fixed-size ray tiles; pads the tail tile.

    All ``args`` leaves must have leading dim ``num_rays``; result leaves
    keep leading dim ``num_rays``.  ``tile <= 0`` means one whole-batch
    tile (no padding replication — the padded filler rays are real ray
    copies, so callers wanting a single wavefront should use this).
    """
    tile = num_rays if tile <= 0 else min(tile, num_rays)
    padded = ((num_rays + tile - 1) // tile) * tile
    if padded != num_rays:
        args = jax.tree.map(
            lambda a: jnp.concatenate(
                [a, jnp.broadcast_to(a[:1], (padded - num_rays,) + a.shape[1:])]
            ),
            args,
        )
    args = jax.tree.map(lambda a: a.reshape((padded // tile, tile) + a.shape[1:]), args)
    out = jax.lax.map(fn, args)
    out = jax.tree.map(lambda a: a.reshape((padded,) + a.shape[2:])[:num_rays], out)
    return out


def resolve_jitter_mode(scene: Scene, jitter_mode: str, spp: int) -> str:
    if jitter_mode != "auto":
        return jitter_mode
    gpu = scene.dialect == "gpu"
    return "wang" if (gpu or spp > 1) else "center"


def accumulate_samples(
    scene: Scene,
    xs: Array,
    ys: Array,
    spp: int,
    jitter_mode: str,
    ray_tile: Optional[int] = None,
    sample_offset: Array | int = 0,
) -> Array:
    """Sum of per-sample radiance for the given pixel-index arrays.

    The shard-friendly core: callers hand it any subset of pixels (whole
    image, a device's shard, a tile), it returns the un-normalized (N, 3)
    accumulator.  Seeding is by absolute (x, y, sample)
    (``make_rng_seed``, query.h:44-48), so any partitioning of the pixel
    set produces identical radiance — resharding never changes the image.
    """
    cam = scene.camera
    num_rays = xs.shape[0]
    if ray_tile is None:
        ray_tile = default_ray_tile(scene)

    host_offsets = None
    if jitter_mode == "reference_cpu":
        host_offsets = jnp.asarray(rnglib.jittered_samples(spp, 42, centered=True))

    def one_sample(s: Array) -> Array:
        s = s + sample_offset  # distinct seed stream per frame in benches
        if jitter_mode == "wang":
            jx, jy = rnglib.pixel_jitter(xs, ys, s)
        elif jitter_mode == "reference_cpu":
            jx = jnp.broadcast_to(host_offsets[jnp.minimum(s, spp - 1), 0], xs.shape)
            jy = jnp.broadcast_to(host_offsets[jnp.minimum(s, spp - 1), 1], ys.shape)
        elif jitter_mode == "center":
            jx = jnp.full(xs.shape, 0.5, jnp.float32)
            jy = jnp.full(ys.shape, 0.5, jnp.float32)
        else:
            raise ValueError(f"unknown jitter_mode {jitter_mode!r}")

        px = xs.astype(jnp.float32) + jx
        py = ys.astype(jnp.float32) + jy
        origins, dirs = cam.get_rays(px, py)
        seeds = rnglib.make_rng_seed(xs, ys, s)

        def tile_fn(args):
            o, d, st = args
            return trace_rays(o, d, st, scene)

        return _tile_map(tile_fn, (origins, dirs, seeds), num_rays, ray_tile)

    accum, _ = jax.lax.scan(
        lambda acc, s: (acc + one_sample(s), None),
        jnp.zeros((num_rays, 3), jnp.float32),
        jnp.arange(spp, dtype=jnp.int32),
    )
    return accum


@partial(jax.jit, static_argnames=("jitter_mode", "ray_tile", "spp_override",
                                   "normalize"))
def render_scene(
    scene: Scene,
    jitter_mode: str = "auto",
    ray_tile: Optional[int] = None,
    spp_override: Optional[int] = None,
    sample_offset: Array | int = 0,
    normalize: bool = True,
) -> Array:
    """Render a built scene to a linear (H, W, 3) float32 image.

    ``jitter_mode`` picks the sub-pixel sampling scheme:

    - ``"wang"`` — per-(pixel, sample) Wang-hash jitter in [-0.5, 0.5),
      exactly the CUDA kernel's sequence (``query.cu:36-43``),
    - ``"reference_cpu"`` — one host-side mt19937(42) offset per sample
      shared by all pixels, exactly the GPU repo's CPU fallback
      (``query.cu:137-146``) — the oracle-parity mode,
    - ``"center"`` — deterministic pixel centers: offset +0.5 in the
      CPUOnly convention (``CPUOnly/src/render.cpp:127-128`` at spp==1),
    - ``"auto"`` — gpu dialect -> "wang"; cpuonly -> "center" when spp==1
      else "wang" (the reference's spp>1 CPUOnly jitter is a non-seeded
      mt19937 and thus unreproducible; we substitute the wang stream).

    The per-ray RNG seed is ``make_rng_seed(x, y, sample)`` in every mode
    (``query.h:44-48``), so images are independent of ray-tile size and
    device sharding.

    ``ray_tile``: rays per wavefront tile, ``<= 0`` for the whole frame;
    None picks ``default_ray_tile(scene)``.

    ``normalize=False`` returns the raw per-pixel radiance SUM over the
    spp samples (no ``/spp``) — the accumulation unit for progressive /
    resumable rendering (``render.progressive``).
    """
    spp = spp_override if spp_override is not None else scene.spp
    w, h = scene.camera.width, scene.camera.height
    xs, ys, (hp, wp) = _swizzled_grid(w, h)
    accum = _frame_accum(scene, xs, ys, spp, sample_offset, jitter_mode,
                         ray_tile)
    img = _unswizzle(accum, w, h, hp, wp)
    return img / float(spp) if normalize else img


def _frame_accum(scene, xs, ys, spp, sample_offset, jitter_mode, ray_tile):
    """Per-ray radiance SUM over spp samples, (N, 3) in swizzled order —
    shared by ``render_scene`` and ``render_scene_frames``."""
    jitter_mode = resolve_jitter_mode(scene, jitter_mode, spp)
    return accumulate_samples(
        scene, xs, ys, spp, jitter_mode, ray_tile,
        sample_offset=sample_offset,
    )


@partial(jax.jit, static_argnames=("frames", "jitter_mode", "ray_tile"))
def render_scene_frames(
    scene: Scene,
    frames: int,
    jitter_mode: str = "auto",
    sample_offset: Array | int = 0,
    ray_tile: Optional[int] = None,
) -> Array:
    """Render ``frames`` consecutive spp-1 frames in ONE dispatch ->
    (frames, H, W, 3); frame f uses sample index ``sample_offset + f``.

    An in-graph scan of single-frame renders: each returned frame is
    bit-identical to ``render_scene(scene, ..., spp_override=1,
    sample_offset=sample_offset + f)`` rendered alone; only the dispatch
    batching differs."""
    w, h = scene.camera.width, scene.camera.height
    xs, ys, (hp, wp) = _swizzled_grid(w, h)

    def one(_, off):
        return 0, _frame_accum(scene, xs, ys, 1, off, jitter_mode, ray_tile)

    off0 = jnp.asarray(sample_offset, jnp.int32)
    _, accum = jax.lax.scan(
        one, 0, off0 + jnp.arange(frames, dtype=jnp.int32))
    return jax.vmap(lambda a: _unswizzle(a, w, h, hp, wp))(accum)


@partial(jax.jit, static_argnames=("width", "height", "spp", "ray_tile"))
def render_hw1(
    vertices: Array,
    normals: Array,
    camera: Camera,
    light_position: Array,
    light_color: Array,
    width: int,
    height: int,
    spp: int = 1,
    offsets: Optional[Array] = None,
    ray_tile: int = DEFAULT_RAY_TILE,
) -> Array:
    """The HW1 pipeline: one brute-force bounce, fixed metal shader.

    Faithful to ``HW1/src/render.cpp:72-116`` including its jitter quirk:
    render.cpp builds fractional coords ``i + offset`` but HW1's camera
    only has an ``(int, int)`` ``get_pixel_position`` overload
    (``HW1/include/camera.h:33-35``), so C++ silently truncates the
    offsets away and every sample shoots through the integer grid point.
    We therefore floor the offsets (pass ``offsets`` (spp, 2) in [0, 1) or
    default to the reference's mt19937(42) stream, which all floor to 0).
    Closest hit over all triangles uses t >= 0 with the FLT_EPSILON det
    cutoff, then ``shade_hw1``.
    """
    if offsets is None:
        offsets = jnp.asarray(rnglib.jittered_samples(spp, 42, centered=False))
    offsets = jnp.floor(offsets)  # the reference's int-truncation quirk
    xs, ys = _pixel_grid(width, height)
    num_rays = width * height

    def one_sample(s):
        px = xs.astype(jnp.float32) + offsets[s, 0]
        py = ys.astype(jnp.float32) + offsets[s, 1]
        origins, dirs = camera.get_rays(px, py)

        def tile_fn(args):
            o, d = args
            hits = intersect_closest(
                o, d, vertices, tmin=0.0, det_eps=FLT_EPSILON
            )
            p, n, _ = make_hit_frame(o, d, hits, vertices, normals, mode="hw1")
            return shading.shade_hw1(
                o, d, p, n, hits.hit, light_position, light_color
            )

        return _tile_map(tile_fn, (origins, dirs), num_rays, ray_tile)

    accum, _ = jax.lax.scan(
        lambda acc, s: (acc + one_sample(s), None),
        jnp.zeros((num_rays, 3), jnp.float32),
        jnp.arange(spp, dtype=jnp.int32),
    )
    return (accum / float(spp)).reshape(height, width, 3)
