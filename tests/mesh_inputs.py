"""Seeded numpy inputs of the mesh tests: what
``scripts/export_mesh_npz.py`` feeds the JAX package and what the port's
tests (``tests/test_torch_mesh.py``, ``tests/test_torch_pipeline_mesh.py``,
``tests/test_torch_cuda.py``) and ``chip_smoke.py`` feed the port, so both
sides take the same arrays. numpy only: no JAX, no torch."""

from __future__ import annotations

import hashlib

import numpy as np

def field_heights(n: int, amp: float = 1.0, seed=None) -> np.ndarray:
    """amp·sin(x_i)·cos(x_j) over x = linspace(-2π, 2π, n), plus seeded
    noise of 0.2 if ``seed`` is given."""
    xs = np.linspace(-2 * np.pi, 2 * np.pi, n)
    h = amp * np.sin(xs)[:, None] * np.cos(xs)[None, :]
    if seed is not None:
        h = h + 0.2 * np.random.default_rng(seed).standard_normal((n, n))
    return h.astype(np.float32)


SMALL_FIELD = dict(n=12, spacing=0.5, seed=3)  # 242 triangles: dense
LARGE_FIELD = dict(n=40, spacing=0.25, seed=4)  # 3,042: clustered


def cube_corners(he) -> np.ndarray:
    return np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                     for sz in (-1, 1)], np.float32) * np.asarray(
                         he, np.float32)


def random_hull(seed: int = 5, n: int = 12) -> np.ndarray:
    """``n`` points on a squashed sphere of radius ~0.3."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * np.asarray([0.3, 0.2, 0.25])).astype(np.float32)


def cube_mesh():
    """The 12 triangles of the cube of half extent 0.5."""
    f = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                  [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                  [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    return cube_corners(0.5), f


def topk_points(heights: np.ndarray, spacing: float, seed: int = 6,
                n_random: int = 48) -> np.ndarray:
    """Mesh-local query points over a field: random ones up to 1 m above
    the surface, then points 0.1 m above the middle of each of 8 shared
    diagonal edges (two triangles tie) and 0.2 m above 8 interior
    vertices (six tie)."""
    n = heights.shape[0]
    rng = np.random.default_rng(seed)
    c = (n - 1) / 2.0
    ij = rng.uniform(1, n - 2, (n_random, 2))
    i0, j0 = np.floor(ij).astype(int).T
    pts = [np.stack([(ij[:, 0] - c) * spacing,
                     heights[i0, j0] + rng.uniform(-0.3, 1.0, n_random),
                     (ij[:, 1] - c) * spacing], -1)]
    cells = rng.integers(1, n - 2, (8, 2))
    for i, j in cells:  # the diagonal b-c of cell (i, j): (i, j+1)-(i+1, j)
        y = 0.5 * (heights[i, j + 1] + heights[i + 1, j]) + 0.1
        pts.append(np.asarray([[(i + 0.5 - c) * spacing, y,
                                (j + 0.5 - c) * spacing]]))
    for i, j in cells:
        pts.append(np.asarray([[(i - c) * spacing, heights[i, j] + 0.2,
                                (j - c) * spacing]]))
    return np.concatenate(pts).astype(np.float32)


def contact_scene(heights: np.ndarray, spacing: float, seed: int = 7):
    """Bodies 1..16 near the field (body 0): 4 balls, 4 cuboids, 4
    capsules and 4 convex polyhedra (``random_hull``), each with a seeded
    rotation and a centre 0-0.3 m over the surface under it. Returns
    (translations [17, 3], rotations [17, 4], ball radius, cuboid half
    extent, capsule half height, capsule radius)."""
    n = heights.shape[0]
    rng = np.random.default_rng(seed)
    c = (n - 1) / 2.0
    ij = rng.integers(2, n - 2, (16, 2))
    q = rng.normal(size=(17, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    q[0] = (0, 0, 0, 1)
    trans = np.zeros((17, 3), np.float32)
    trans[1:, 0] = (ij[:, 0] - c) * spacing
    trans[1:, 2] = (ij[:, 1] - c) * spacing
    trans[1:, 1] = (heights[ij[:, 0], ij[:, 1]]
                    + rng.uniform(0.0, 0.3, 16)).astype(np.float32)
    return trans, q, 0.2, 0.15, 0.15, 0.1


def tri_pairs(seed: int = 8, n: int = 64):
    """Random triangles (A, shape-local, pose at the identity) against
    cuboids, capsules and convex polyhedra (B, alternating, seeded
    poses) 0-0.4 m from the triangle's centroid: separated, touching and
    deep pairs."""
    rng = np.random.default_rng(seed)
    tri = rng.normal(size=(n, 3, 3)).astype(np.float32) * 0.4
    cen = tri.mean(1)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tb = (cen + d * rng.uniform(0.0, 0.4, (n, 1))).astype(np.float32)
    qb = rng.normal(size=(n, 4)).astype(np.float32)
    qb /= np.linalg.norm(qb, axis=-1, keepdims=True)
    return tri, tb, qb


def query_inputs(seed: int = 9, n: int = 128):
    """(origins, unit directions, points) for the casts and projections:
    origins 4 m out, points within 2 m of the origin."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 4
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d, p


def field_rays(heights: np.ndarray, spacing: float, seed: int = 10,
               n: int = 128):
    """Rays from 3 m above a field, tilted up to 30° off straight down."""
    rng = np.random.default_rng(seed)
    half = (heights.shape[0] - 1) / 2.0 * spacing
    o = np.stack([rng.uniform(-half, half, n), np.full(n, 3.0),
                  rng.uniform(-half, half, n)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.5, 0.5, n), -np.ones(n),
                  rng.uniform(-0.5, 0.5, n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def bvh_boxes(seed: int = 11, n: int = 300):
    c = np.random.default_rng(seed).uniform(-5, 5, (n, 3)).astype(np.float32)
    return c - 0.1, c + 0.2


def digest(a) -> np.ndarray:
    """SHA-1 of an array's dtype, shape and bytes (int64 indices as int32)."""
    a = np.asarray(a)
    if a.dtype == np.int64:
        a = a.astype(np.int32)
    h = hashlib.sha1(f"{a.dtype.str}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return np.asarray(h.hexdigest())


# mesh10k: the 225 x 225 field at 0.2 m of tests/test_mesh_accel.py's
# 100k-triangle test, a 100 x 100 lattice of its vertices (i, j = 12 + 2k),
# balls and cuboids in a checkerboard
MESH10K_GRID, MESH10K_SPACING, MESH10K_SIDE = 225, 0.2, 100
MESH10K_BALL_R, MESH10K_BOX_HE = 0.15, 0.12


def mesh10k_layout():
    """(heights [225, 225], ball centres [5000, 3], cuboid centres [5000,
    3]): balls at h + r + 0.001 over their vertex, cuboids at the highest
    of the 3 x 3 vertices around theirs + he + 0.001."""
    h = field_heights(MESH10K_GRID, amp=0.5)
    k = 12 + 2 * np.arange(MESH10K_SIDE)
    ii, jj = (a.reshape(-1) for a in np.meshgrid(k, k, indexing="ij"))
    c = (MESH10K_GRID - 1) / 2.0
    x = (ii - c) * MESH10K_SPACING
    z = (jj - c) * MESH10K_SPACING
    ball = ((ii - 12) // 2 + (jj - 12) // 2) % 2 == 0
    top = np.max(np.stack([h[ii + di, jj + dj] for di in (-1, 0, 1)
                           for dj in (-1, 0, 1)]), axis=0)
    y = np.where(ball, h[ii, jj] + MESH10K_BALL_R + 0.001,
                 top + MESH10K_BOX_HE + 0.001)
    pos = np.stack([x, y, z], -1).astype(np.float32)
    return h, pos[ball], pos[~ball]


def mesh10k_config() -> dict:
    """The testbed's configuration with the mesh batch at 16,384 pairs
    (the JAX package never regrows it) and 4-point manifolds."""
    return dict(pair_capacity=16384, mesh_pair_capacity=16384,
                manifold_points=4)
