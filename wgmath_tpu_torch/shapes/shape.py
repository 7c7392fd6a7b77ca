"""Shape tagged union as structure of arrays (counterpart of
``wgmath_tpu/shapes/shape.py``): one i32 tag per body plus an f32 param
row. This slice carries balls and cuboids; ``kinds`` is the static set of
tags present and gates the narrow-phase kernels.

Param layout: BALL ``[radius]``, CUBOID ``[hx, hy, hz]``.
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.geometry import quat
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
SUPPORTED_KINDS = frozenset((BALL, CUBOID))


@dataclasses.dataclass
class ShapeSet:
    tag: torch.Tensor  # i64 [N]
    params: torch.Tensor  # f32 [N, NUM_PARAMS]
    vertices: torch.Tensor  # f32 [0, 3] (no meshes in this slice)
    indices: torch.Tensor  # i64 [0, 3]
    kinds: frozenset = SUPPORTED_KINDS

    @staticmethod
    def balls(radii: torch.Tensor) -> "ShapeSet":
        radii = radii.to(torch.float32)
        n = radii.shape[0]
        params = torch.zeros((n, NUM_PARAMS), dtype=torch.float32,
                             device=radii.device)
        params[:, 0] = radii
        return ShapeSet(torch.full((n,), BALL, dtype=torch.int64,
                                   device=radii.device), params,
                        torch.zeros((0, 3), device=radii.device),
                        torch.zeros((0, 3), dtype=torch.int64,
                                    device=radii.device),
                        kinds=frozenset((BALL,)))

    @staticmethod
    def cuboids(half_extents: torch.Tensor) -> "ShapeSet":
        he = half_extents.to(torch.float32)
        n, dim = he.shape
        params = torch.zeros((n, NUM_PARAMS), dtype=torch.float32,
                             device=he.device)
        params[:, :dim] = he
        return ShapeSet(torch.full((n,), CUBOID, dtype=torch.int64,
                                   device=he.device), params,
                        torch.zeros((0, dim), device=he.device),
                        torch.zeros((0, dim), dtype=torch.int64,
                                    device=he.device),
                        kinds=frozenset((CUBOID,)))

    @staticmethod
    def concat(*sets: "ShapeSet") -> "ShapeSet":
        kinds = frozenset().union(*(s.kinds for s in sets))
        return ShapeSet(torch.cat([s.tag for s in sets]),
                        torch.cat([s.params for s in sets]),
                        torch.cat([s.vertices for s in sets]),
                        torch.cat([s.indices for s in sets]), kinds=kinds)


def local_aabb_half_extents(shapes: ShapeSet, dim: int) -> torch.Tensor:
    """Symmetric local AABB half extents [N, dim] (exact for ball/cuboid)."""
    p = shapes.params
    ball_he = p[:, 0:1].expand(-1, dim)
    cuboid_he = p[:, :dim]
    return torch.where((shapes.tag == BALL)[:, None], ball_he, cuboid_he)


def world_aabbs(shapes: ShapeSet, poses: Sim, *, margin: float = 0.0):
    """(mins, maxs) world AABBs [N, 3]: |R|·he for boxes, he for balls."""
    he = local_aabb_half_extents(shapes, 3) * poses.scale[:, None]
    rmat = torch.abs(quat.to_matrix(poses.rotation))
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
