"""Mesh-backed shapes: triangle meshes, polylines, heightfields and convex
polyhedra (counterpart of ``wgmath_tpu/shapes/mesh.py``).

A mesh is flattened into the ``ShapeSet``'s shared vertex / index buffers
with (first, count) references, its primitives Morton-ordered into
``MESH_LEAF`` clusters with one AABB each (``queries/mesh_accel.py``). The
buffers are built on the host in numpy, as in the JAX package, so both
packages hold the same arrays; ``device`` says where the set goes
(``None`` means the card). The step takes the 3D kinds; a polyline is 2D
contact geometry, which waits for the port of 2D."""

from __future__ import annotations

import numpy as np
import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.queries.mesh_accel import build_clusters
from wgmath_tpu_torch.shapes import shape as shp

TRI_MARGIN = 0.02  # the collision-margin shell around mesh triangles


def _mesh_set(tag: int, params: np.ndarray, vertices: np.ndarray,
              indices: np.ndarray, cmin: np.ndarray, cmax: np.ndarray,
              device) -> shp.ShapeSet:
    dev = resolve_device(device)
    return shp.ShapeSet(
        torch.tensor([tag], dtype=torch.int64, device=dev),
        torch.from_numpy(params).to(dev),
        torch.from_numpy(np.ascontiguousarray(vertices)).to(dev),
        torch.from_numpy(indices.astype(np.int64)).to(dev),
        torch.from_numpy(np.ascontiguousarray(cmin)).to(dev),
        torch.from_numpy(np.ascontiguousarray(cmax)).to(dev),
        kinds=frozenset((tag,)))


def _bound(vertices: np.ndarray, pad: float = 0.0) -> np.ndarray:
    """The symmetric local bound |centre| + half extent (+ pad)."""
    he = (vertices.max(0) - vertices.min(0)) / 2.0
    center = (vertices.max(0) + vertices.min(0)) / 2.0
    return np.abs(center) + he + pad


def trimesh(vertices: np.ndarray, indices: np.ndarray, *,
            device=None) -> shp.ShapeSet:
    """One triangle-mesh collider (3D). Its bound includes twice the
    triangle margin, so contacts engage at the margin's standoff."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    n_tris = len(indices)
    indices, cmin, cmax = build_clusters(vertices, indices,
                                         margin=TRI_MARGIN)
    params = np.zeros((1, shp.NUM_PARAMS), np.float32)
    params[0, 1] = len(vertices)
    params[0, 3] = n_tris  # the real count; rows past it are padding
    params[0, 4:7] = _bound(vertices, 2.0 * TRI_MARGIN)
    return _mesh_set(shp.TRIMESH, params, vertices, indices, cmin, cmax,
                     device)


def polyline(vertices: np.ndarray, *, closed: bool = False,
             device=None) -> shp.ShapeSet:
    """One polyline collider (a 2D boundary or a 3D wire), its segments
    Morton-clustered like a trimesh's triangles. Only the constructor:
    its contacts are 2D (ROADMAP item 4)."""
    vertices = np.asarray(vertices, np.float32)
    n = len(vertices)
    segs = [[i, i + 1] for i in range(n - 1)]
    if closed:
        segs.append([n - 1, 0])
    indices = np.asarray(segs, np.int32)
    n_segs = len(indices)
    indices, cmin, cmax = build_clusters(vertices, indices)
    dim = vertices.shape[1]
    params = np.zeros((1, shp.NUM_PARAMS), np.float32)
    params[0, 1] = n
    params[0, 3] = n_segs
    params[0, 4:4 + dim] = _bound(vertices)
    return _mesh_set(shp.POLYLINE, params, vertices, indices, cmin, cmax,
                     device)


def heightfield(heights: np.ndarray, scale_x: float = 1.0,
                scale_z: float = 1.0, *, device=None) -> shp.ShapeSet:
    """A grid heightfield as a trimesh, centred on the origin: vertex
    (i, j) at x = (i - (nx - 1) / 2)·scale_x, y = heights[i, j],
    z = (j - (nz - 1) / 2)·scale_z, two triangles a cell."""
    heights = np.asarray(heights, np.float32)
    nx, nz = heights.shape
    xs = (np.arange(nx) - (nx - 1) / 2.0) * scale_x
    zs = (np.arange(nz) - (nz - 1) / 2.0) * scale_z
    verts = np.stack(np.meshgrid(xs, zs, indexing="ij"), -1)
    verts = np.concatenate([verts[..., :1], heights[..., None],
                            verts[..., 1:]], axis=-1).reshape(-1, 3)
    a = (np.arange(nx - 1)[:, None] * nz + np.arange(nz - 1)[None, :])
    a = a.reshape(-1)
    b, c = a + 1, a + nz
    d = c + 1
    # the JAX package's loop order: cell by cell, [a, b, c] then [b, d, c]
    tris = np.stack([np.stack([a, b, c], -1), np.stack([b, d, c], -1)],
                    1).reshape(-1, 3)
    return trimesh(verts, tris.astype(np.int32), device=device)


def _hull_faces(vertices: np.ndarray) -> np.ndarray:
    """Outward-wound hull triangles [F, 3] by qhull (empty on degenerate
    input: the support arg-max still works from the raw vertices)."""
    from scipy.spatial import ConvexHull, QhullError

    try:
        hull = ConvexHull(np.asarray(vertices, np.float64))
    except (QhullError, ValueError):  # coplanar or duplicate inputs
        return np.zeros((0, 3), np.int32)
    faces = hull.simplices.astype(np.int32)
    # qhull's simplices are not wound consistently: turn each so its
    # geometric normal agrees with qhull's outward plane
    va, vb, vc = (vertices[faces[:, i]] for i in range(3))
    n_geom = np.cross(vb - va, vc - va)
    flip = np.sum(n_geom * hull.equations[:, :3], axis=-1) < 0.0
    faces[flip] = faces[flip][:, ::-1]
    return faces


def convex_polyhedron(vertices: np.ndarray, *,
                      device=None) -> shp.ShapeSet:
    """One convex polyhedron collider (3D) from its hull vertices:
    support-mapped (GJK / EPA) from the vertices, with the hull's
    outward-wound triangles in the index buffer (clustered like a
    trimesh's, so ``ShapeSet.concat``'s alignment holds) for the ray cast
    and the support faces."""
    vertices = np.asarray(vertices, np.float32)
    faces = _hull_faces(vertices)
    n_faces = len(faces)
    indices, cmin, cmax = build_clusters(vertices, faces)
    params = np.zeros((1, shp.NUM_PARAMS), np.float32)
    params[0, 1] = len(vertices)
    params[0, 3] = n_faces  # the real count; rows past it are padding
    params[0, 4:7] = _bound(vertices)
    return _mesh_set(shp.CONVEX, params, vertices, indices.reshape(-1, 3),
                     cmin, cmax, device)
