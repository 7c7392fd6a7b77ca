"""Ray casts against shapes (counterpart of ``wgmath_tpu/queries/ray.py``).

Every cast is batched and branch-free; a miss is ``t = +inf`` and an origin
inside a solid shape hits at ``t = 0``. Shapes are evaluated in local
space; :func:`cast` moves each ray into its collider's frame and evaluates
every analytic formula the scene's ``kinds`` can need, masked by tag.

Meshes are cast densely (every ray against every triangle or segment of
the index buffer, masked to its own range) below ``ACCEL_MIN_PRIMS``
primitives, and through the clusters of ``queries/mesh_accel.py`` above
it (:func:`_ray_mesh_clustered`: rounds of the nearest-entry clusters,
one host read a round). Convex polyhedra are cast against the hull faces
they store.
"""

from __future__ import annotations

import torch

from wgmath_tpu_torch.core.dispatch import host_int
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.quat import cross, dot
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries.mesh_accel import (  # noqa: F401 (the threshold)
    ACCEL_MIN_PRIMS,
    MESH_LEAF,
    cluster_range,
    gather_prims,
    smallest_k,
    use_clusters,
)
from wgmath_tpu_torch.shapes import shape as shp

INF = float("inf")


def _safe_div(a, b):
    tiny = torch.where(b < 0, -1e-30, 1e-30)
    return a / torch.where(torch.abs(b) < 1e-30, tiny, b)


def _zero_y(v):
    out = v.clone()
    out[..., 1] = 0.0
    return out


def ray_ball(origin, direction, radius):
    """Quadratic |o + t·d|² = r²; the smallest t >= 0 (inf on a miss).
    Origins inside the ball hit at t = 0."""
    a = dot(direction, direction)
    b = dot(origin, direction)
    c = dot(origin, origin) - radius * radius
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = _safe_div(-b - sq, a)
    inside = c <= 0.0
    t = torch.where(inside, 0.0, t0)
    hit = (disc >= 0.0) & (t >= 0.0)
    return torch.where(hit, t, INF)


def ray_cuboid(origin, direction, half_extents):
    """Slab test; solid (inside → t = 0)."""
    inv_d = _safe_div(torch.ones_like(direction), direction)
    t1 = (-half_extents - origin) * inv_d
    t2 = (half_extents - origin) * inv_d
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin < 0.0, 0.0, tmin)
    return torch.where(hit, t, INF)


def ray_capsule(origin, direction, half_height, radius):
    """Capsule = segment {y ∈ [−h, h]} ⊕ ball(r): the least of the lateral
    cylinder hit (within the segment's span) and both cap-sphere hits."""
    o_xz, d_xz = _zero_y(origin), _zero_y(direction)
    a = dot(d_xz, d_xz)
    b = dot(o_xz, d_xz)
    c = dot(o_xz, o_xz) - radius * radius
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cyl = _safe_div(-b - sq, a)
    y_hit = origin[..., 1] + t_cyl * direction[..., 1]
    cyl_ok = ((disc >= 0.0) & (t_cyl >= 0.0)
              & (torch.abs(y_hit) <= half_height) & (a > 1e-30))
    t_cyl = torch.where(cyl_ok, t_cyl, INF)

    up = torch.zeros_like(origin)
    up[..., 1] = half_height
    t_top = ray_ball(origin - up, direction, radius)
    t_bot = ray_ball(origin + up, direction, radius)
    inside = (c <= 0.0) & (torch.abs(origin[..., 1]) <= half_height)
    t = torch.minimum(torch.minimum(t_cyl, t_top), t_bot)
    return torch.where(inside, 0.0, t)


def ray_cylinder(origin, direction, half_height, radius):
    """Finite cylinder (flat caps), solid."""
    o_xz, d_xz = _zero_y(origin), _zero_y(direction)
    a = dot(d_xz, d_xz)
    b = dot(o_xz, d_xz)
    c = dot(o_xz, o_xz) - radius * radius
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = _safe_div(-b - sq, a)
    y_side = origin[..., 1] + t_side * direction[..., 1]
    side_ok = ((disc >= 0.0) & (t_side >= 0.0)
               & (torch.abs(y_side) <= half_height) & (a > 1e-30))
    t_side = torch.where(side_ok, t_side, INF)

    def cap(sign):
        t = _safe_div(sign * half_height - origin[..., 1], direction[..., 1])
        p = origin + t[..., None] * direction
        r2 = p[..., 0] ** 2 + p[..., 2] ** 2
        ok = ((t >= 0.0) & (r2 <= radius * radius)
              & (torch.abs(direction[..., 1]) > 1e-30))
        return torch.where(ok, t, INF)

    inside = (c <= 0.0) & (torch.abs(origin[..., 1]) <= half_height)
    t = torch.minimum(t_side, torch.minimum(cap(1.0), cap(-1.0)))
    return torch.where(inside, 0.0, t)


def ray_cone(origin, direction, half_height, radius):
    """Finite cone, apex at +h, base disk at −h, solid."""
    k = radius / (2.0 * half_height)
    oy = half_height - origin[..., 1]  # distance below the apex
    dy = -direction[..., 1]
    a = direction[..., 0] ** 2 + direction[..., 2] ** 2 - k * k * dy * dy
    b = (origin[..., 0] * direction[..., 0]
         + origin[..., 2] * direction[..., 2] - k * k * oy * dy)
    c = origin[..., 0] ** 2 + origin[..., 2] ** 2 - k * k * oy * oy
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = _safe_div(-b - sq, a)
    t1 = _safe_div(-b + sq, a)

    def side_ok(t):
        y = origin[..., 1] + t * direction[..., 1]
        return ((disc >= 0.0) & (t >= 0.0) & (y >= -half_height)
                & (y <= half_height))

    t_side = torch.where(side_ok(t0), t0,
                         torch.where(side_ok(t1), t1, INF))

    t_base = _safe_div(-half_height - origin[..., 1], direction[..., 1])
    p = origin + t_base[..., None] * direction
    base_ok = ((t_base >= 0.0)
               & (p[..., 0] ** 2 + p[..., 2] ** 2 <= radius * radius)
               & (torch.abs(direction[..., 1]) > 1e-30))
    t_base = torch.where(base_ok, t_base, INF)

    inside = ((c <= 0.0) & (origin[..., 1] >= -half_height)
              & (origin[..., 1] <= half_height))
    t = torch.minimum(t_side, t_base)
    return torch.where(inside, 0.0, t)


def ray_triangle(origin, direction, va, vb, vc):
    """Möller–Trumbore, two-sided; t (inf on a miss)."""
    e1 = vb - va
    e2 = vc - va
    h = cross(direction, e2)
    det = dot(e1, h)
    inv_det = _safe_div(torch.ones_like(det), det)
    s = origin - va
    u = dot(s, h) * inv_det
    q = cross(s, e1)
    v = dot(direction, q) * inv_det
    t = dot(e2, q) * inv_det
    eps = 1e-7
    hit = ((torch.abs(det) > 1e-12) & (u >= -eps) & (v >= -eps)
           & (u + v <= 1 + eps) & (t >= 0.0))
    return torch.where(hit, t, INF)


def ray_segment_2d(origin, direction, va, vb):
    """2D ray vs segment: o + t·d = a + u·(b−a) with t >= 0, u ∈ [0, 1].
    Collinear overlaps count as misses."""
    ab = vb - va
    ao = va - origin

    def cross2(p, q):
        return p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]

    denom = cross2(direction, ab)
    inv = _safe_div(torch.ones_like(denom), denom)
    t = cross2(ao, ab) * inv
    u = cross2(ao, direction) * inv
    hit = ((torch.abs(denom) > 1e-12) & (t >= 0.0) & (u >= 0.0)
           & (u <= 1.0))
    return torch.where(hit, t, INF)


def _ray_mesh_clustered(origin, direction, shapes: shp.ShapeSet,
                        first_idx, num_idx, prim_fn, k_clusters: int = 4):
    """The exact nearest hit through the clusters: each round tests the
    ``k_clusters`` remaining clusters of least slab-entry t of every ray
    and retires them; the rounds end when no ray has a remaining cluster
    entered before its best hit (a hit inside a cluster cannot precede
    its entry). Memory is [rays, clusters]."""
    cmin, cmax = shapes.cluster_min, shapes.cluster_max
    dev = origin.device
    n_rays = origin.shape[0]
    fc, nc = cluster_range(first_idx, num_idx)
    cid = torch.arange(cmin.shape[0], device=dev)
    in_range = ((cid[None, :] >= fc[:, None])
                & (cid[None, :] < (fc + nc)[:, None]))
    inv_d = _safe_div(torch.ones_like(direction), direction)
    t1 = (cmin[None] - origin[:, None, :]) * inv_d[:, None, :]
    t2 = (cmax[None] - origin[:, None, :]) * inv_d[:, None, :]
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    entry0 = torch.clamp(tmin, min=0.0)
    entry = torch.where((tmax >= entry0) & in_range, entry0, INF)
    lane = torch.arange(MESH_LEAF, device=dev)
    last = (first_idx + num_idx)[:, None]
    t_best = torch.full((n_rays,), INF, device=dev)
    while host_int(torch.any(torch.amin(entry, dim=-1) < t_best)):
        neg, best = smallest_k(entry, k_clusters)
        cand = (best[:, :, None] * MESH_LEAF + lane).reshape(
            n_rays, k_clusters * MESH_LEAF)
        t = prim_fn(origin[:, None, :], direction[:, None, :],
                    *gather_prims(shapes, cand))
        ok = ((cand >= first_idx[:, None]) & (cand < last)
              & torch.isfinite(neg).repeat_interleave(MESH_LEAF, dim=1))
        t_best = torch.minimum(t_best, torch.amin(
            torch.where(ok, t, INF), dim=-1))
        entry = entry.scatter(1, best, INF)
    return t_best


def _ray_mesh(origin, direction, shapes, first_idx, num_idx, prim_fn):
    """Least t over each ray's own primitive range: every primitive of the
    index buffer tested ([rays, P]), or the clustered route."""
    prims = shapes.indices
    if prims.shape[0] == 0:
        return torch.full(origin.shape[:-1], INF, device=origin.device)
    if use_clusters(shapes):
        return _ray_mesh_clustered(origin, direction, shapes, first_idx,
                                   num_idx, prim_fn)
    verts = [shapes.vertices[prims[:, i]][None] for i in range(prims.shape[1])]
    t = prim_fn(origin[:, None, :], direction[:, None, :], *verts)
    ids = torch.arange(prims.shape[0], device=origin.device)
    in_range = ((ids[None, :] >= first_idx[:, None])
                & (ids[None, :] < (first_idx + num_idx)[:, None]))
    t = torch.where(in_range, t, INF)
    return torch.amin(t, dim=-1)


def ray_trimesh(origin, direction, shapes: shp.ShapeSet, first_idx, num_idx):
    """Least t over a mesh's triangle range."""
    return _ray_mesh(origin, direction, shapes, first_idx, num_idx,
                           ray_triangle)


def ray_polyline(origin, direction, shapes: shp.ShapeSet, first_idx,
                 num_idx):
    """Least t over a 2D polyline's segment range."""
    return _ray_mesh(origin, direction, shapes, first_idx, num_idx,
                           ray_segment_2d)


def cast(shapes: shp.ShapeSet, poses: Sim, origins: torch.Tensor,
         dirs: torch.Tensor, max_toi: float = INF) -> torch.Tensor:
    """World-space ray i against collider i: ``[N]`` times of impact, +inf
    for a miss or a hit beyond ``max_toi``."""
    o_loc = sim_ops.inv_mul_pt(poses, origins)
    d_loc = sim_ops.inv_mul_unit_vec(poses, dirs)  # unit dirs; scale via t
    p = shapes.params
    tag = shapes.tag
    t = torch.full(origins.shape[:-1], INF, device=origins.device)
    t = torch.where(tag == shp.BALL, ray_ball(o_loc, d_loc, p[:, 0]), t)
    dim = origins.shape[-1]
    t = torch.where(tag == shp.CUBOID, ray_cuboid(o_loc, d_loc, p[:, :dim]),
                    t)
    if dim == 2 and shp.POLYLINE in shapes.kinds:
        t_poly = ray_polyline(o_loc, d_loc, shapes, p[:, 2].to(torch.int64),
                              p[:, 3].to(torch.int64))
        t = torch.where(tag == shp.POLYLINE, t_poly, t)
    if dim == 3:
        t = torch.where(tag == shp.CAPSULE,
                        ray_capsule(o_loc, d_loc, p[:, 0], p[:, 1]), t)
        t = torch.where(tag == shp.CYLINDER,
                        ray_cylinder(o_loc, d_loc, p[:, 0], p[:, 1]), t)
        t = torch.where(tag == shp.CONE,
                        ray_cone(o_loc, d_loc, p[:, 0], p[:, 1]), t)
        if shapes.kinds & {shp.TRIMESH, shp.CONVEX}:
            # convex shapes are cast against the hull faces they store
            is_mesh = (tag == shp.TRIMESH) | (tag == shp.CONVEX)
            num = torch.where(is_mesh, p[:, 3], 0.0).to(torch.int64)
            t_mesh = ray_trimesh(o_loc, d_loc, shapes,
                                 p[:, 2].to(torch.int64), num)
            t = torch.where(is_mesh, t_mesh, t)
    # the local direction is a unit vector; the world distance is the local
    # one times the pose's scale
    t = t * poses.scale
    return torch.where(t <= max_toi, t, INF)


register_module(
    KernelModule(
        "queries.ray",
        deps=("geometry.sim",),
        provides={
            "ray_ball": ray_ball,
            "ray_cuboid": ray_cuboid,
            "ray_capsule": ray_capsule,
            "ray_cylinder": ray_cylinder,
            "ray_cone": ray_cone,
            "ray_triangle": ray_triangle,
            "ray_cast": cast,
            "ray_trimesh": ray_trimesh,
            "ray_polyline": ray_polyline,
            "ray_segment_2d": ray_segment_2d,
        },
        entries={
            "cast_balls": EntryPoint(
                fn=lambda o, d: ray_ball(o, d, 1.0),
                example_args=lambda device: (
                    torch.ones((1024, 3), device=device) * 3,
                    -torch.ones((1024, 3), device=device)),
            )
        },
        doc="Batched ray casts.",
    )
)
