"""Benchmark: path-tracing throughput on the reference's frog workload.

Prints ONE JSON line to stdout, e.g.
  {"metric": "rays_per_s", "value": N, "unit": "rays/s", "frame_ms": ...,
   "platform": "gpu", "device_kind": "...", "device_count": 1}

The default workload mirrors the reference's headline configuration
(``GPUandCPU/assets/json_files/frog.json``: frog mesh, 1920x1080, spp 1,
depth 8, diffuse bounces): camera rays/s = W*H*spp / frame_time, with the
reference's discipline — warmup pass to exclude compile cost, device sync
before stopping timers (``main.cu:361-378``, ``warmup.h:10-90``).

Modes: default (one frame per dispatch), ``--quick`` (320x180),
``--grad`` (one Adam step of the inverse-rendering loss), ``--sharded``
(``render_scene_sharded`` on a 1-device mesh) and ``--large N`` (the
frog subdivided to >= N triangles).  Every mode needs a GPU and fails
without one.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def _device_info():
    """Platform facts every result line carries (with the card's name and
    power limit from ``nvidia-smi``); exits without a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs a GPU; JAX found platform {dev.platform!r}")
    try:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = "unknown"
    info = {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()), "card": card}
    print(f"device: {info}", file=sys.stderr)
    return info


def _timed(label, fn, iters):
    """Median wall time of ``fn(i)`` (synced) after one warmup call."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(0))
    print(f"{label} warmup (compile + run): {time.perf_counter() - t0:.2f}s",
          file=sys.stderr)
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i + 1))
        times.append(time.perf_counter() - t0)
    dt = sorted(times)[len(times) // 2]
    print(f"{label}: {dt * 1e3:.3f} ms", file=sys.stderr)
    return dt


def _frog(args, **kw):
    from __graft_entry__ import _frog_scene

    scene = _frog_scene(width=args.width, height=args.height, spp=args.spp,
                        max_bounces=args.bounces,
                        diffuse_bounce=not args.no_diffuse, **kw)
    if args.no_pallas:
        scene = dataclasses.replace(scene, use_pallas=False)
    return scene


def _bench_backward(args, info):
    """One jitted value_and_grad + Adam step of the inverse-rendering
    pixel loss w.r.t. albedo + light + vertices (BASELINE config 4) in the
    detached-traversal differentiable mode; backward rays/s = W*H*spp /
    step time.  ``--grad-brute`` uses the brute-force intersector."""
    import optax

    from raytracinginonesemester_tpu.diff.inverse import make_train_step

    scene, params, target = grad_problem(
        args.width or 960, args.height or 540, args.spp or 1,
        args.bounces or 2, brute=args.grad_brute, scene_path=args.scene)
    if args.no_pallas:
        scene = dataclasses.replace(scene, use_pallas=False)
    opt = optax.adam(1e-3)
    step = make_train_step(opt, jitter_mode="center",
                           spp_override=args.spp or 1)
    state = {"p": params, "s": opt.init(params)}

    def one(_):
        state["p"], state["s"], loss = step(state["p"], state["s"], scene,
                                            target)
        return loss

    dt = _timed("grad step", one, args.iters)
    cam = scene.camera
    rays = cam.width * cam.height * (args.spp or 1)
    print(json.dumps({
        "metric": "backward_rays_per_s", "value": rays / dt,
        "unit": "rays/s", "step_ms": dt * 1e3, **info}))


def grad_problem(width, height, spp=1, bounces=2, brute=False,
                 scene_path=None):
    """BASELINE config 4's inverse-rendering problem: the sphere scene
    rendered as a target, and parameters (albedo, light intensity,
    vertices) perturbed 5% away from it.  Returns (scene, params,
    target)."""
    import jax.numpy as jnp
    import numpy as np

    import raytracinginonesemester_tpu as rt
    from raytracinginonesemester_tpu.core.camera import Camera
    from raytracinginonesemester_tpu.diff.inverse import extract_params

    scene_path = scene_path or os.path.join(
        REPO, "tests/assets/scenes/gpu_spheres.json")
    if brute:
        scene = rt.load_scene(scene_path, accel="none")
    else:
        scene = dataclasses.replace(
            rt.load_scene(scene_path, accel="blocks"), differentiable=True)
    cam = Camera.create(
        position=(0.0, -2.5, 1.2), look_at=(0.0, 0.0, 0.5), up=(0, 0, 1),
        focal_length_mm=24.0, width=width, height=height,
    )
    scene = dataclasses.replace(scene, camera=cam, max_bounces=bounces,
                                spp=spp)
    target = rt.render_scene(scene, jitter_mode="center", spp_override=spp)
    params = extract_params(
        scene, keys=("albedo", "light_intensity", "vertices"))
    rs = np.random.RandomState(0)
    params = {
        k: jnp.asarray(np.asarray(v) * (1.0 + 0.05 * rs.standard_normal(
            np.asarray(v).shape).astype(np.float32)))
        for k, v in params.items()
    }
    return scene, params, target


def _bench_large(args, info):
    """The frog subdivided (midpoint 1 -> 4 splits, identical surface)
    to >= ``--large`` triangles: (a) the closest-hit pass on the camera
    rays and (b) a full frame, both through the production traversal."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracinginonesemester_tpu.ops.accel import build_block_grid
    from raytracinginonesemester_tpu.ops.backend import resolve_traversal
    from raytracinginonesemester_tpu.render.renderer import render_scene
    from raytracinginonesemester_tpu.scene.subdivide import subdivide_geometry

    scene = _frog(args)
    levels = 0
    t = int(scene.geometry.num_triangles)
    while t * 4 ** levels < args.large:
        levels += 1
    t0 = time.perf_counter()
    geom = subdivide_geometry(scene.geometry, levels)
    grid = jax.block_until_ready(build_block_grid(
        geom.vertices, jnp.asarray(geom.num_triangles), obj_ids=geom.obj_id,
        block_size=scene.accel.block_size))
    scene = dataclasses.replace(scene, geometry=geom, accel=grid)
    impl = resolve_traversal(scene.use_pallas)
    print(f"large scene: {geom.num_triangles} tris ({levels} subdiv "
          f"levels), {grid.num_blocks} blocks, traversal {impl}, build "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)

    w, h = args.width, args.height
    xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                         np.arange(h, dtype=np.float32))
    o, d = scene.camera.get_rays(jnp.asarray(xs.ravel() + 0.5),
                                 jnp.asarray(ys.ravel() + 0.5))
    if impl == "xla":
        from raytracinginonesemester_tpu.ops.accel import block_closest as closest
    else:
        from raytracinginonesemester_tpu.ops.pallas_kernels import (
            pallas_block_closest as closest)
    run = jax.jit(lambda o, d, s: closest(o, d + 0.0 * s, grid, tmin=1e-4,
                                          det_eps=1e-8).t)
    dt_c = _timed("closest pass", lambda i: run(o, d, jnp.float32(i)),
                  args.iters)
    dt_r = _timed("full frame", lambda i: render_scene(
        scene, jitter_mode="wang", ray_tile=args.ray_tile, sample_offset=i),
        args.iters)
    print(json.dumps({
        "metric": "large_scene_rays_per_s", "value": w * h / dt_r,
        "unit": "rays/s", "tris": int(geom.num_triangles),
        "traversal": impl, "closest_ms": dt_c * 1e3,
        "frame_ms": dt_r * 1e3, **info}))


def _bench_sharded(args, info):
    """``render_scene_sharded`` on a 1-device "data" mesh next to the
    unsharded frame: the sharded path's own overhead."""
    from raytracinginonesemester_tpu.parallel.sharded import (
        make_mesh, render_scene_sharded)
    from raytracinginonesemester_tpu.render.renderer import render_scene

    scene = _frog(args)
    mesh = make_mesh(shape=(1,), axis_names=("data",))
    dt_sh = _timed("sharded (data=1 mesh)", lambda i: render_scene_sharded(
        scene, mesh, jitter_mode="wang", ray_tile=args.ray_tile,
        sample_offset=i), args.iters)
    dt_un = _timed("unsharded", lambda i: render_scene(
        scene, jitter_mode="wang", ray_tile=args.ray_tile, sample_offset=i),
        args.iters)
    rays = args.width * args.height * args.spp
    print(json.dumps({
        "metric": "sharded_rays_per_s", "value": rays / dt_sh,
        "unit": "rays/s", "sharded_ms": dt_sh * 1e3,
        "unsharded_ms": dt_un * 1e3, **info}))


def _bench_frame(args, info):
    import jax

    from raytracinginonesemester_tpu.ops.backend import resolve_traversal
    from raytracinginonesemester_tpu.ops.lbvh import build_lbvh
    from raytracinginonesemester_tpu.render.renderer import render_scene
    from raytracinginonesemester_tpu.utils.timing import measure

    t0 = time.perf_counter()
    if args.scene is not None:
        scene = _scene_from_json(args)
    else:
        scene = _frog(args)
    jax.block_until_ready(scene.accel.tri)
    impl = resolve_traversal(scene.use_pallas)
    print(f"scene build (load + accel): {time.perf_counter() - t0:.2f}s, "
          f"{scene.geometry.num_triangles} tris, {scene.accel.num_blocks} "
          f"blocks, traversal {impl}", file=sys.stderr)

    # LBVH build time — the reference's other headline metric
    # (main.cu:281-293 GPU / :306-317 CPU)
    lbvh = measure(lambda v: build_lbvh(v).aabb_min, scene.geometry.vertices,
                   warmup=1, iters=7)
    print(f"LBVH build ({scene.geometry.padded_triangles} tris): "
          f"{lbvh['median_s'] * 1e3:.3f} ms", file=sys.stderr)

    # each frame renders a different sample index, so no two dispatches
    # are identical
    dt = _timed("frame", lambda i: render_scene(
        scene, jitter_mode="wang", ray_tile=args.ray_tile,
        sample_offset=i), args.iters)
    cam = scene.camera
    rays = cam.width * cam.height * scene.spp
    print(f"frame: {dt * 1e3:.3f} ms @ {cam.width}x{cam.height} "
          f"spp={scene.spp} bounces={scene.max_bounces} -> "
          f"{rays / dt:.4e} rays/s", file=sys.stderr)
    if args.save:
        import numpy as np

        from raytracinginonesemester_tpu.io.image import write_png

        img = render_scene(scene, jitter_mode="wang", ray_tile=args.ray_tile)
        write_png(args.save, np.asarray(img),
                  mode="gpu" if scene.dialect == "gpu" else "cpuonly")
        print(f"saved {args.save}", file=sys.stderr)
    print(json.dumps({
        "metric": "rays_per_s", "value": rays / dt, "unit": "rays/s",
        "frame_ms": dt * 1e3, "lbvh_ms": lbvh["median_s"] * 1e3,
        "traversal": impl, **info}))


def _scene_from_json(args):
    from raytracinginonesemester_tpu.core.camera import Camera
    from raytracinginonesemester_tpu.scene.build import load_scene
    from raytracinginonesemester_tpu.scene.config import load_scene_config

    scene = load_scene(args.scene)
    overrides = {}
    if args.bounces:
        overrides["max_bounces"] = args.bounces
    if args.spp:
        overrides["spp"] = args.spp
    if args.no_pallas:
        overrides["use_pallas"] = False
    if args.width or args.height:
        config = load_scene_config(args.scene)
        overrides["camera"] = Camera.create(
            position=config.camera_position,
            look_at=config.camera_look_at,
            up=config.camera_up,
            focal_length_mm=config.focal_length_mm,
            sensor_height_mm=config.sensor_height_mm,
            sensor_width_mm=config.sensor_width_mm,
            width=args.width or config.pixel_width,
            height=args.height or config.pixel_height,
        )
    return dataclasses.replace(scene, **overrides)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--bounces", type=int, default=None)
    ap.add_argument("--no-diffuse", action="store_true",
                    help="terminal-only variant (no diffuse bounces); the "
                    "faithful frog.json workload has diffuse_bounce=true")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ray-tile", type=int, default=None,
                    help="rays per wavefront tile; <=0 = whole frame; "
                    "default: the traversal's own (renderer."
                    "default_ray_tile)")
    ap.add_argument("--quick", action="store_true",
                    help="small frame for a fast sanity run")
    ap.add_argument("--no-pallas", action="store_true",
                    help="use the XLA block path instead of the kernels")
    ap.add_argument("--save", type=str, default=None,
                    help="write the benchmark render to this PNG path")
    ap.add_argument("--grad", action="store_true",
                    help="benchmark one Adam step of the inverse-rendering "
                    "loss w.r.t. albedo + light + vertices (BASELINE "
                    "config 4) instead")
    ap.add_argument("--grad-brute", action="store_true",
                    help="with --grad: use the brute-force differentiable "
                    "intersector instead of detached traversal")
    ap.add_argument("--sharded", action="store_true",
                    help="benchmark render_scene_sharded on a 1-device "
                    "mesh next to the unsharded frame")
    ap.add_argument("--large", type=int, default=0,
                    help="benchmark the frog subdivided to >= this many "
                    "triangles (e.g. 1000000)")
    ap.add_argument("--scene", type=str, default=None,
                    help="benchmark a reference-format scene JSON instead "
                    "of the frog; --width/--height/--spp/--bounces "
                    "override when given")
    args = ap.parse_args()

    from raytracinginonesemester_tpu.utils.compile_cache import (
        enable_compile_cache)

    enable_compile_cache()
    info = _device_info()
    if args.quick:
        args.width, args.height, args.iters = 320, 180, 2
    if args.grad:
        _bench_backward(args, info)
        return
    if args.scene is None:
        # the faithful frog.json headline workload defaults
        args.width = args.width or 1920
        args.height = args.height or 1080
        args.spp = args.spp or 1
        args.bounces = args.bounces or 8
    if args.large:
        _bench_large(args, info)
    elif args.sharded:
        _bench_sharded(args, info)
    else:
        _bench_frame(args, info)


if __name__ == "__main__":
    main()
