"""Interactive stage window — the analog of ``viz::show``.

The reference opens a windowed inspector for the scene stage: HW1's
``viz::show`` (``HW1/include/visualization.h:31``) and CPUOnly's
Polyscope ``StagePreview`` (``CPUOnly/src/stage_preview.cpp:122-186``).
This module provides the same workflow: ``show(config)`` opens an
interactive PyVista window with the camera center, subsampled
camera->pixel rays, every mesh (transform baked), and the lights; on a
headless machine (no display / no pyvista) it falls back to the
matplotlib PNG of ``stage_preview`` — the same inspection content
without a window, which is the right behavior for headless servers.
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["show"]


def _stage_geometry(config, scene_path: str, grid_step: int):
    """Shared stage construction: (meshes, rays, camera_center, lights).

    Reuses the loaders/transforms so the window shows exactly what the
    renderer consumes (the reference's StagePreview draws the same
    baked stage it traces)."""
    from ..core.camera import Camera
    from ..io.obj import load_obj
    from ..scene.config import resolve_mesh_path
    from ..scene.transform import transform_points

    cam = Camera.create(
        position=config.camera_position,
        look_at=config.camera_look_at,
        up=config.camera_up,
        focal_length_mm=config.focal_length_mm,
        sensor_height_mm=config.sensor_height_mm,
        sensor_width_mm=config.sensor_width_mm,
        width=config.pixel_width,
        height=config.pixel_height,
    )
    w, h = config.pixel_width, config.pixel_height
    xs, ys = np.meshgrid(np.arange(0, w, grid_step),
                         np.arange(0, h, grid_step))
    px = np.asarray(cam.pixel_position(xs.ravel(), ys.ravel()))
    center = np.asarray(cam.center)

    meshes = []
    for node in config.nodes:
        if node.type and node.type != "mesh":
            continue
        try:
            mesh, _ = load_obj(resolve_mesh_path(scene_path, node.path))
        except (FileNotFoundError, ValueError):
            continue
        pos = np.asarray(transform_points(node.transform, mesh.positions))
        meshes.append((node.name, pos,
                       np.asarray(mesh.indices).reshape(-1, 3)))
    lights = [np.asarray(li["position"], np.float32)
              for li in config.lights]
    return meshes, px, center, lights


def show(config, scene_path: str = ".", grid_step: int = 32,
         headless: bool | None = None,
         out_png: str = "stage_preview.png") -> str:
    """Open the interactive stage window (or write the headless PNG).

    Returns "window" when an interactive window was shown, else the
    path of the PNG written by the ``stage_preview`` fallback.
    ``headless=None`` auto-detects (no pyvista or no $DISPLAY on a
    platform that needs one -> fallback)."""
    if headless is None:
        headless = False
        try:
            import pyvista  # noqa: F401
        except Exception:
            headless = True
    if not headless:
        try:
            import pyvista as pv

            meshes, px, center, lights = _stage_geometry(
                config, scene_path, grid_step)
            plotter = pv.Plotter()
            for name, v, f in meshes:
                faces = np.concatenate(
                    [np.full((f.shape[0], 1), 3, f.dtype), f], axis=1)
                plotter.add_mesh(pv.PolyData(v, faces.ravel()),
                                 style="wireframe", color="lime",
                                 label=name)
            # camera->pixel ray network (subsampled like the reference)
            n = px.shape[0]
            pts = np.concatenate([np.tile(center, (n, 1)), px])
            lines = np.stack([np.full(n, 2), np.arange(n),
                              np.arange(n) + n], axis=1).ravel()
            plotter.add_mesh(pv.PolyData(pts, lines=lines),
                             color="gray", opacity=0.3)
            plotter.add_points(center[None], color="red",
                               point_size=12, label="camera")
            for lp in lights:
                plotter.add_points(lp[None], color="yellow",
                                   point_size=12)
            plotter.add_axes()
            plotter.show()
            return "window"
        except Exception as e:  # no display / pyvista backend failure
            print(f"interactive stage window unavailable ({e}); "
                  f"writing {out_png}")
    from .stage_preview import stage_preview

    stage_preview(config, scene_path=scene_path, out_png=out_png,
                  grid_step=grid_step)
    return out_png
