"""Command-line render drivers.

Mirrors the reference's executables:

- ``render scene.json``            — the CPUOnly/GPUandCPU scene renderers
  (``CPUOnly/src/render.cpp:22-169``, ``GPUandCPU/src/main.cu:98-436``);
  dialect auto-detected from the JSON, PNG written like the respective
  reference program (``output/<stem>_output.png`` for cpuonly scenes,
  ``render.png`` for gpu scenes).
- ``render mesh.obj [more.obj...]`` — the HW1 brute-force renderer /
  bvh_viz's obj-list mode (``HW1/src/render.cpp:15-136``,
  ``main.cu:152-158``).
- ``--stage-preview``               — the StagePreview inspection tool
  (``CPUOnly/src/stage_preview.cpp``), written to a PNG.
- ``--export-bvh out.obj``          — the BVH wireframe export
  (``GPUandCPU/include/visualizer.h:10-80``).

Usage:  python -m raytracinginonesemester_tpu.render.cli [options] input...
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="raytracinginonesemester_tpu.render",
        description="JAX ray tracer (scene JSON or OBJ inputs)",
    )
    ap.add_argument("inputs", nargs="+", help="scene .json or mesh .obj file(s)")
    ap.add_argument("-o", "--output", default=None, help="output PNG path")
    ap.add_argument("--dialect", default="auto", choices=("auto", "cpuonly", "gpu"))
    ap.add_argument("--spp", type=int, default=None, help="override samples/pixel")
    ap.add_argument("--bounces", type=int, default=None, help="override max bounces")
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--accel", default="blocks", choices=("blocks", "none"))
    ap.add_argument("--pallas", action="store_true",
                    help="trace through the Pallas (Triton) traversal "
                    "kernels; needs a GPU")
    ap.add_argument("--jitter", default="auto",
                    choices=("auto", "wang", "reference_cpu", "center"))
    ap.add_argument("--ppm", default=None, help="also write a PPM P6 file")
    ap.add_argument("--progressive", type=int, default=0, metavar="CHUNK",
                    help="render spp in CHUNK-sample dispatches "
                    "(progressive accumulation; chunk 1 is bit-identical "
                    "to one-shot)")
    ap.add_argument("--state-dir", default=None,
                    help="with --progressive: persist the accumulator "
                    "here after every chunk and resume from it")
    ap.add_argument("--stage-preview", action="store_true",
                    help="write a stage-preview PNG instead of rendering")
    ap.add_argument("--export-bvh", default=None, metavar="OBJ",
                    help="write the accel structure's AABB wireframes")
    args = ap.parse_args(argv)

    import dataclasses

    import numpy as np

    from ..ops.backend import resolve_traversal
    from ..utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.pallas:
        try:
            resolve_traversal(use_pallas=True)
        except ValueError as e:
            ap.error(str(e))

    from ..io.image import write_png, write_ppm_p6
    from ..scene.build import build_scene, load_scene
    from ..scene.config import load_scene_config
    from .renderer import render_hw1, render_scene

    first = args.inputs[0]
    is_scene = first.endswith(".json") or first.endswith(".scene")

    if args.stage_preview:
        if not is_scene:
            ap.error("--stage-preview needs a scene JSON")
        from ..viz.stage_preview import stage_preview

        config = load_scene_config(first, dialect=args.dialect)
        out = args.output or "stage_preview.png"
        stage_preview(config, scene_path=first, out_png=out)
        print(f"stage preview saved to {out}")
        return 0

    if is_scene:
        scene = load_scene(first, dialect=args.dialect, accel=args.accel)
        overrides = {}
        if args.spp:
            overrides["spp"] = args.spp
        if args.bounces:
            overrides["max_bounces"] = args.bounces
        if args.pallas:
            overrides["use_pallas"] = True
        if args.width or args.height:
            from ..core.camera import Camera

            config = load_scene_config(first, dialect=args.dialect)
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
        if overrides:
            scene = dataclasses.replace(scene, **overrides)

        if args.export_bvh:
            from ..viz.bvh_export import export_block_grid_to_obj

            if scene.accel is None:
                ap.error("--export-bvh needs --accel blocks")
            n = export_block_grid_to_obj(args.export_bvh, scene.accel)
            print(f"exported {n} AABBs to {args.export_bvh}")

        print(f"rendering {scene.camera.width}x{scene.camera.height} "
              f"spp={scene.spp} bounces={scene.max_bounces} "
              f"dialect={scene.dialect}", file=sys.stderr)
        t0 = time.time()
        if args.progressive:
            from .progressive import render_progressive

            def report(done, _preview):
                print(f"  {done}/{scene.spp} spp", file=sys.stderr)

            img = render_progressive(
                scene, chunk=args.progressive, jitter_mode=args.jitter,
                state_dir=args.state_dir, on_chunk=report)
        else:
            img = np.asarray(render_scene(scene, jitter_mode=args.jitter))
        print(f"Render time: {time.time() - t0:.3f} s", file=sys.stderr)

        if args.output:
            out = args.output
        elif scene.dialect == "gpu":
            out = "render.png"  # main.cu:432
        else:
            stem = os.path.splitext(os.path.basename(first))[0]
            os.makedirs("output", exist_ok=True)
            out = os.path.join("output", f"{stem}_output.png")  # render.cpp:152
        write_png(out, img, mode="gpu" if scene.dialect == "gpu" else "cpuonly")
        print(f"Image saved to {out}")
        if args.ppm:
            write_ppm_p6(args.ppm, img, gamma2=False)
            print(f"PPM saved to {args.ppm}")
        return 0

    # OBJ mode: the HW1 pipeline with its hardcoded camera/light
    # (HW1/src/render.cpp:42-60); multiple OBJs concatenate like
    # bvh_viz's obj-list mode.
    import jax.numpy as jnp

    from ..io.obj import append_mesh, load_obj, mesh_to_triangles
    from ..scene.build import geometry_from_mesh

    mesh = None
    next_id = 0
    for path in args.inputs:
        m, next_id = load_obj(path, next_id)
        print(f"Loaded OBJ: {path} ({m.num_vertices} verts, "
              f"{m.num_triangles} tris)", file=sys.stderr)
        mesh = append_mesh(mesh, m)
    verts, normals = mesh_to_triangles(mesh)
    geom = geometry_from_mesh(verts, normals)

    from ..core.camera import Camera

    width = args.width or 320
    height = args.height or 180
    cam = Camera.create(
        position=(0.0, -1.0, 1.0), look_at=(0.0, 0.15, 0.0), up=(0, 0, 1),
        focal_length_mm=255.0, sensor_height_mm=24.0,
        width=width, height=height,
    )
    t0 = time.time()
    img = np.asarray(render_hw1(
        geom.vertices, geom.normals, cam,
        jnp.asarray([-3.0, 0.0, 1.0]), jnp.asarray([1.0, 0.0, 1.0]),
        width, height, spp=args.spp or 1,
    ))
    print(f"Total render time: {time.time() - t0:.3f} s", file=sys.stderr)
    out = args.output or "output.png"  # HW1 render.cpp:60
    write_png(out, img, mode="hw1")
    print(f"Image saved to {out}")
    if args.ppm:
        write_ppm_p6(args.ppm, img, gamma2=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
