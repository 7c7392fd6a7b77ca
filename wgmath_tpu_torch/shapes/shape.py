"""Shape tagged union as structure of arrays (counterpart of
``wgmath_tpu/shapes/shape.py``): one i64 tag per body plus an f32 param
row, and the shared vertex / index buffers that mesh-backed shapes point
into. ``kinds`` is the static set of tags present; it gates the
narrow-phase kernels and the per-tag branches of the queries.

Param layout per tag (params[:, 0:8]):
- BALL:     [radius]
- CUBOID:   [hx, hy(, hz)]
- CAPSULE:  [half_height, radius]           (segment along local Y)
- CONE:     [half_height, radius]           (3D; apex +Y)
- CYLINDER: [half_height, radius]           (3D)
- SEGMENT:  [ax, ay, az, bx, by, bz]
- TRIANGLE: vertex buffer ref [first_vtx, 3]
- POLYLINE / TRIMESH / CONVEX: [first_vtx, num_vtx, first_idx, num_idx]
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.geometry import quat, rot2
from wgmath_tpu_torch.geometry.sim import Sim

BALL = 0
CUBOID = 1
CAPSULE = 2
CONE = 3
CYLINDER = 4
SEGMENT = 5
TRIANGLE = 6
POLYLINE = 7
TRIMESH = 8
CONVEX = 9

NUM_PARAMS = 8
ALL_KINDS = frozenset(range(10))
# the tags the physics step takes: analytic ball and cuboid contacts, the
# support-mapped (GJK / EPA / PFM) contacts of the other three
SUPPORTED_KINDS = frozenset((BALL, CUBOID, CAPSULE, CONE, CYLINDER))


@dataclasses.dataclass
class ShapeSet:
    tag: torch.Tensor  # i64 [N]
    params: torch.Tensor  # f32 [N, NUM_PARAMS]
    vertices: torch.Tensor  # f32 [V, dim]
    indices: torch.Tensor  # i64 [I, dim] (triangles in 3D, segments in 2D)
    # the mesh clusters of the JAX package's two-level acceleration: one
    # AABB per run of primitives; empty unless a mesh built them
    cluster_min: torch.Tensor | None = None  # f32 [C, dim]
    cluster_max: torch.Tensor | None = None  # f32 [C, dim]
    kinds: frozenset = ALL_KINDS

    def __post_init__(self):
        if self.cluster_min is None:
            empty = torch.zeros((0, self.vertices.shape[1]),
                                device=self.vertices.device)
            self.cluster_min, self.cluster_max = empty, empty.clone()

    @property
    def num_shapes(self) -> int:
        return self.tag.shape[0]

    @staticmethod
    def _of(tag: int, params: torch.Tensor, dim: int) -> "ShapeSet":
        n, dev = params.shape[0], params.device
        return ShapeSet(torch.full((n,), tag, dtype=torch.int64, device=dev),
                        params, torch.zeros((0, dim), device=dev),
                        torch.zeros((0, dim), dtype=torch.int64, device=dev),
                        kinds=frozenset((tag,)))

    @staticmethod
    def _leading(*cols: torch.Tensor) -> torch.Tensor:
        """A param matrix whose first columns are ``cols``, the rest 0."""
        params = torch.zeros((cols[0].shape[0], NUM_PARAMS),
                             dtype=torch.float32, device=cols[0].device)
        for i, c in enumerate(cols):
            params[:, i] = c.to(torch.float32)
        return params

    @staticmethod
    def balls(radii: torch.Tensor, dim: int = 3) -> "ShapeSet":
        return ShapeSet._of(BALL, ShapeSet._leading(radii), dim)

    @staticmethod
    def cuboids(half_extents: torch.Tensor) -> "ShapeSet":
        he = half_extents.to(torch.float32)
        n, dim = he.shape
        params = torch.zeros((n, NUM_PARAMS), dtype=torch.float32,
                             device=he.device)
        params[:, :dim] = he
        return ShapeSet._of(CUBOID, params, dim)

    @staticmethod
    def capsules(half_heights: torch.Tensor, radii: torch.Tensor,
                 dim: int = 3) -> "ShapeSet":
        """Capsules along local Y."""
        return ShapeSet._of(CAPSULE, ShapeSet._leading(half_heights, radii),
                            dim)

    @staticmethod
    def cylinders(half_heights: torch.Tensor,
                  radii: torch.Tensor) -> "ShapeSet":
        """3D cylinders, axis +Y."""
        return ShapeSet._of(CYLINDER,
                            ShapeSet._leading(half_heights, radii), 3)

    @staticmethod
    def cones(half_heights: torch.Tensor, radii: torch.Tensor) -> "ShapeSet":
        """3D cones, apex +Y, base disk at −half_height."""
        return ShapeSet._of(CONE, ShapeSet._leading(half_heights, radii), 3)

    @staticmethod
    def concat(*sets: "ShapeSet") -> "ShapeSet":
        """Concatenate shape sets, rebasing mesh buffer references."""
        if any(s.cluster_min.shape[0] for s in sets):
            raise NotImplementedError(
                "concat of cluster-accelerated meshes needs "
                "queries/mesh_accel.py (ROADMAP item 15)")
        params, idxs = [], []
        v_off = i_off = 0
        for s in sets:
            p = s.params.clone()
            is_mesh = (s.tag >= POLYLINE) | (s.tag == TRIANGLE)
            p[:, 0] = torch.where(is_mesh, p[:, 0] + v_off, p[:, 0])
            p[:, 2] = torch.where(s.tag >= POLYLINE, p[:, 2] + i_off, p[:, 2])
            params.append(p)
            idxs.append(s.indices + v_off)
            v_off += s.vertices.shape[0]
            i_off += s.indices.shape[0]
        return ShapeSet(torch.cat([s.tag for s in sets]), torch.cat(params),
                        torch.cat([s.vertices for s in sets]),
                        torch.cat(idxs),
                        kinds=frozenset().union(*(s.kinds for s in sets)))


def local_aabb_half_extents(shapes: ShapeSet, dim: int) -> torch.Tensor:
    """Symmetric local AABB half extents [N, dim]: exact for ball/cuboid,
    the height+radius box for capsule, cone and cylinder, the per-axis
    largest |endpoint| for a segment, and the bound stored in
    params[4:4+dim] for mesh-backed shapes. Only the tags in
    ``shapes.kinds`` are evaluated."""
    p = shapes.params
    tag = shapes.tag[:, None]
    kinds = shapes.kinds
    hh, rad = p[:, 0:1], p[:, 1:2]
    mid = [rad] if dim == 3 else []
    he = p[:, 4:4 + dim]  # mesh-backed shapes
    if SEGMENT in kinds:
        he = torch.where(tag == SEGMENT, torch.maximum(
            torch.abs(p[:, :dim]), torch.abs(p[:, dim:2 * dim])), he)
    if kinds & {CONE, CYLINDER}:
        he = torch.where((tag == CONE) | (tag == CYLINDER),
                         torch.cat([rad, hh] + mid, dim=1), he)
    if CAPSULE in kinds:
        he = torch.where(tag == CAPSULE, torch.cat([rad, hh + rad] + mid,
                                                   dim=1), he)
    if CUBOID in kinds:
        he = torch.where(tag == CUBOID, p[:, :dim], he)
    if BALL in kinds:
        he = torch.where(tag == BALL, p[:, 0:1].expand(-1, dim), he)
    return he


def world_aabbs(shapes: ShapeSet, poses: Sim, *, margin: float = 0.0):
    """(mins, maxs) world AABBs [N, dim]: |R|·he, he itself for balls."""
    dim = poses.translation.shape[-1]
    he = local_aabb_half_extents(shapes, dim) * poses.scale[:, None]
    rot = quat if dim == 3 else rot2
    rmat = torch.abs(rot.to_matrix(poses.rotation))
    world_he = torch.sum(rmat * he[:, None, :], dim=-1)
    world_he = torch.where((shapes.tag == BALL)[:, None], he,
                           world_he) + margin
    center = poses.translation
    return center - world_he, center + world_he


def ball_radii_or_nan(shapes: ShapeSet, poses: Sim) -> torch.Tensor:
    """[N] scale-adjusted ball radius, NaN for non-ball shapes."""
    r = shapes.params[:, 0] * poses.scale
    return torch.where(shapes.tag == BALL, r,
                       torch.full_like(r, float("nan")))
