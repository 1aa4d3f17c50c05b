"""Scene building: configs + OBJ files -> device-ready flat arrays.

The analog of the reference's per-node bake loops
(``CPUOnly/src/render.cpp:55-98``, ``GPUandCPU/src/main.cu:164-190``):
load each mesh node, bake its transform into world space, assign object
ids, and concatenate everything into one triangle-soup pytree plus a
material table indexed by object id.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import Array

from ..core.camera import Camera
from ..io.obj import MeshArrays, append_mesh, load_obj, mesh_to_triangles
from .config import SceneConfig, load_scene_config, resolve_mesh_path
from .material import MaterialTable, Lights
from .transform import apply_transform

__all__ = ["Geometry", "Scene", "build_scene", "load_scene", "geometry_from_mesh"]


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Geometry:
    """World-space triangle soup (padded to a lane-aligned count).

    ``vertices``/``normals`` are (T, 3, 3) float32; ``obj_id`` is (T,)
    int32; ``num_triangles`` is the un-padded count.  Padding repeats a
    degenerate point-triangle at the first vertex so it can never be hit
    (zero edges -> det == 0 -> miss, ``query.h:84-88``) and never widens
    the scene AABB.
    """

    vertices: Array  # (T, 3, 3)
    normals: Array  # (T, 3, 3)
    obj_id: Array  # (T,)
    num_triangles: int = dataclasses.field(metadata=dict(static=True))

    @property
    def padded_triangles(self) -> int:
        return int(self.vertices.shape[0])


def geometry_from_mesh(
    verts: np.ndarray,
    normals: np.ndarray,
    obj_ids: Optional[np.ndarray] = None,
    pad_to: int = 512,  # must stay a multiple of the intersector chunk
) -> Geometry:
    """Wrap raw per-triangle numpy arrays into a padded device Geometry."""
    t = int(verts.shape[0])
    padded = max(_round_up(t, pad_to), pad_to)
    if obj_ids is None:
        obj_ids = np.zeros(t, dtype=np.int32)
    if padded > t:
        anchor = verts[0, 0] if t > 0 else np.zeros(3, dtype=np.float32)
        pad_v = np.broadcast_to(anchor, (padded - t, 3, 3))
        verts = np.concatenate([verts, pad_v.astype(np.float32)])
        normals = np.concatenate([normals, np.zeros((padded - t, 3, 3), np.float32)])
        obj_ids = np.concatenate([obj_ids, np.full(padded - t, -1, np.int32)])
    return Geometry(
        vertices=jnp.asarray(verts, dtype=jnp.float32),
        normals=jnp.asarray(normals, dtype=jnp.float32),
        obj_id=jnp.asarray(obj_ids, dtype=jnp.int32),
        num_triangles=t,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """Fully-built render input: geometry + materials + lights + camera.

    ``accel`` is an optional block-culling structure (``ops.accel``); when
    present the integrator traces through it instead of brute force — the
    analog of the reference threading BVH pointers through its render
    call chain (``query.cu:90-96``).
    """

    geometry: Geometry
    materials: MaterialTable
    lights: Lights
    camera: Camera
    # static render settings
    max_bounces: int = dataclasses.field(metadata=dict(static=True))
    spp: int = dataclasses.field(metadata=dict(static=True))
    diffuse_bounce: bool = dataclasses.field(metadata=dict(static=True))
    background_kind: str = dataclasses.field(metadata=dict(static=True))  # "sky"|"miss"
    dialect: str = dataclasses.field(metadata=dict(static=True))
    miss_color: Array = dataclasses.field(
        default_factory=lambda: jnp.zeros(3, dtype=jnp.float32)
    )
    accel: object = None  # Optional[ops.accel.BlockGrid]
    # Traversal implementation (ops.backend.resolve_traversal): None =
    # the platform's default, True = the Pallas kernels (GPU only),
    # False = the XLA block path.
    use_pallas: object = dataclasses.field(default=None, metadata=dict(static=True))
    # Run the Pallas kernels in the Pallas interpreter (CPU tests); only
    # ever set explicitly.
    interpret: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # detached-traversal differentiable mode: the block traversal runs
    # under stop_gradient to pick the winner triangle, then a per-ray
    # differentiable Moller-Trumbore on the gathered winner carries the
    # gradients while the primal t/u/v pass through bit-exactly
    # (ops.integrator).  Off by default: the recompute adds a per-ray
    # HBM vertex gather per bounce, wasted work for forward-only renders.
    differentiable: bool = dataclasses.field(default=False,
                                             metadata=dict(static=True))


def build_scene(config: SceneConfig, scene_path: str = ".", accel: str = "blocks") -> Scene:
    """Load meshes, bake transforms, and assemble the device scene.

    Follows ``GPUandCPU/src/main.cu:164-190``: object ids are assigned by
    the OBJ loader (one or more per file via o/g tags), every id from a
    node maps to that node's material.
    """
    global_mesh: Optional[MeshArrays] = None
    materials: List[dict] = []
    next_object_id = 0

    for node in config.nodes:
        if node.type and node.type != "mesh":
            continue
        path = resolve_mesh_path(scene_path, node.path)
        obj_id_begin = next_object_id
        # native tokenizer when a C compiler is available (byte-equivalent
        # to load_obj; see io.fast_obj), else the pure-Python loader
        from ..io.fast_obj import load_obj_fast

        mesh, next_object_id = load_obj_fast(path, next_object_id)
        mesh = apply_transform(mesh, node.transform)
        while len(materials) < next_object_id:
            materials.append(dict(node.material))
        for oid in range(obj_id_begin, next_object_id):
            materials[oid] = dict(node.material)
        global_mesh = append_mesh(global_mesh, mesh)

    if global_mesh is None:
        raise ValueError("scene contains no mesh nodes")

    verts, normals = mesh_to_triangles(global_mesh)
    geometry = geometry_from_mesh(verts, normals, global_mesh.triangle_obj_ids)

    camera = Camera.create(
        position=config.camera_position,
        look_at=config.camera_look_at,
        up=config.camera_up,
        focal_length_mm=config.focal_length_mm,
        sensor_height_mm=config.sensor_height_mm,
        sensor_width_mm=config.sensor_width_mm,
        width=config.pixel_width,
        height=config.pixel_height,
    )

    accel_struct = None
    if accel == "blocks":
        from ..ops.accel import build_block_grid

        # triangles per block; results are identical across block sizes
        # (ties break on global triangle id).  Default chosen on the
        # H100 (PERF.md).
        block_size = int(os.environ.get("RT_BLOCK_SIZE", "128"))
        accel_struct = build_block_grid(
            geometry.vertices, jnp.asarray(geometry.num_triangles),
            obj_ids=geometry.obj_id, block_size=block_size,
        )
    elif accel not in (None, "none", "bruteforce"):
        raise ValueError(f"unknown accel {accel!r}")

    bg_kind, bg_color = config.background
    return Scene(
        accel=accel_struct,
        geometry=geometry,
        materials=MaterialTable.from_dicts(materials),
        lights=Lights.from_dicts(config.lights),
        camera=camera,
        max_bounces=max(1, config.max_bounces),
        spp=config.spp,
        diffuse_bounce=config.diffuse_bounce,
        background_kind=bg_kind,
        dialect=config.dialect,
        miss_color=jnp.asarray(bg_color if bg_color is not None else (0.0, 0.0, 0.0),
                               dtype=jnp.float32),
    )


def load_scene(path: str, dialect: str = "auto", accel: str = "blocks") -> Scene:
    """One-call convenience: JSON path -> device Scene."""
    config = load_scene_config(path, dialect=dialect)
    return build_scene(config, scene_path=path, accel=accel)
