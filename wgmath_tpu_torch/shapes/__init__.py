"""Collision shapes (counterpart of ``wgmath_tpu/shapes``, with the same
names)."""

from wgmath_tpu_torch.shapes.shape import (  # noqa: F401
    BALL,
    CAPSULE,
    CONE,
    CONVEX,
    CUBOID,
    CYLINDER,
    POLYLINE,
    SEGMENT,
    TRIANGLE,
    TRIMESH,
    ShapeSet,
    local_aabb_half_extents,
    world_aabbs,
)
