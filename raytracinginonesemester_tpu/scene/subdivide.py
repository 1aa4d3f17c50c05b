"""Midpoint (1 -> 4) triangle subdivision for scale testing.

The reference keeps buddha/dragon-class meshes for exercising its LBVH
at scale (``GPUandCPU/include/bvh.cu:93-206``); those blobs are
stripped from this environment (``/root/reference/.MISSING_LARGE_BLOBS``),
so large scenes are synthesized instead by subdividing a real mesh:
each triangle splits at its edge midpoints into 4 coplanar children.
The surface (and therefore the rendered image, up to shading-normal
interpolation) is unchanged while the triangle count scales 4x per
level — a traversal stressor whose structure outgrows the cache.

Vertex normals at the midpoints are the average of the edge endpoints'
normals (the piecewise-linear interpolation the renderer itself uses),
left un-normalized: ``make_hit_frame``/the kernels normalize the
interpolated result anyway, and averaging first is what barycentric
interpolation of the parent would produce at the midpoint.
"""

from __future__ import annotations

import numpy as np

__all__ = ["subdivide_tris", "subdivide_geometry"]


def subdivide_tris(verts: np.ndarray, normals: np.ndarray,
                   obj_ids: np.ndarray, levels: int = 1):
    """Subdivide (T, 3, 3) triangle soup ``levels`` times -> 4^levels x.

    Returns (verts, normals, obj_ids) as numpy arrays; children keep
    their parent's object id and appear in parent-major order (child
    order: corner0, corner1, corner2, center), so spatial locality —
    what the Morton block layout consumes — is preserved.
    """
    verts = np.asarray(verts, np.float32)
    normals = np.asarray(normals, np.float32)
    obj_ids = np.asarray(obj_ids, np.int32)
    for _ in range(levels):
        v0, v1, v2 = verts[:, 0], verts[:, 1], verts[:, 2]
        n0, n1, n2 = normals[:, 0], normals[:, 1], normals[:, 2]
        m01, m12, m02 = (v0 + v1) * 0.5, (v1 + v2) * 0.5, (v0 + v2) * 0.5
        k01, k12, k02 = (n0 + n1) * 0.5, (n1 + n2) * 0.5, (n0 + n2) * 0.5
        verts = np.stack([
            np.stack([v0, m01, m02], 1),
            np.stack([m01, v1, m12], 1),
            np.stack([m02, m12, v2], 1),
            np.stack([m01, m12, m02], 1),
        ], 1).reshape(-1, 3, 3)
        normals = np.stack([
            np.stack([n0, k01, k02], 1),
            np.stack([k01, n1, k12], 1),
            np.stack([k02, k12, n2], 1),
            np.stack([k01, k12, k02], 1),
        ], 1).reshape(-1, 3, 3)
        obj_ids = np.repeat(obj_ids, 4)
    return verts, normals, obj_ids


def subdivide_geometry(geom, levels: int = 1):
    """Subdivided copy of a built ``Geometry`` (padding re-applied)."""
    from .build import geometry_from_mesh

    t = int(geom.num_triangles)
    v, n, o = subdivide_tris(
        np.asarray(geom.vertices)[:t], np.asarray(geom.normals)[:t],
        np.asarray(geom.obj_id)[:t], levels)
    return geometry_from_mesh(v, n, o)
