"""Point projection onto shapes (counterpart of
``wgmath_tpu/queries/projection.py``).

Two flavours per the reference's contract, chosen by ``boundary``:

- ``boundary=False``: the closest point of the *solid* shape (a point
  inside is its own projection, ``is_inside=True``);
- ``boundary=True``: the closest boundary point, from inside as well.

Every function is batched and works in local space; :func:`project`
dispatches world-space points over the tagged union. Radii and half
heights may be scalars or one value per point.

A convex polyhedron is projected by GJK / EPA (the point as a ball of
radius 0 against the polyhedron); a trimesh or polyline by its nearest
primitive, over the whole index buffer on a small mesh and by the cluster
rounds of ``queries/mesh_accel.py`` on a large one (an open mesh has no
inside).
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.quat import cross, dot
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries.gjk import dot_fma, fma, norm_fma
from wgmath_tpu_torch.shapes import shape as shp


@dataclasses.dataclass
class Projection:
    point: torch.Tensor
    is_inside: torch.Tensor


def _per_point(x, pt):
    """A scalar or per-point parameter broadcast to ``pt.shape[:-1]``."""
    return torch.broadcast_to(torch.as_tensor(x, dtype=pt.dtype,
                                              device=pt.device),
                              pt.shape[:-1])


def _norm(v):
    return torch.sqrt(dot(v, v))


def _unit(v, fallback_axis=0):
    n = _norm(v)[..., None]
    fb = torch.zeros_like(v)
    fb[..., fallback_axis] = 1.0
    return torch.where(n > 1e-9, v / torch.clamp(n, min=1e-30), fb)


def _stack(*cols):
    return torch.stack(cols, dim=-1)


def _no_inside(pt):
    return torch.zeros(pt.shape[:-1], dtype=torch.bool, device=pt.device)


def project_ball(pt, radius, *, boundary: bool):
    r = _per_point(radius, pt)
    inside = _norm(pt) <= r
    on_sphere = _unit(pt) * r[..., None]
    point = on_sphere if boundary else torch.where(inside[..., None], pt,
                                                   on_sphere)
    return Projection(point, inside)


def project_cuboid(pt, half_extents, *, boundary: bool):
    he = torch.broadcast_to(torch.as_tensor(half_extents, dtype=pt.dtype,
                                            device=pt.device), pt.shape)
    clamped = torch.clamp(pt, -he, he)
    inside = torch.all(torch.abs(pt) <= he, dim=-1)
    if not boundary:
        return Projection(torch.where(inside[..., None], pt, clamped),
                          inside)
    # inside → the nearest face
    axis = torch.argmin(he - torch.abs(pt), dim=-1, keepdim=True)
    coord = torch.gather(pt, -1, axis)
    sign = torch.where(coord >= 0.0, 1.0, -1.0)
    face_pt = pt.scatter(-1, axis, sign * torch.gather(he, -1, axis))
    return Projection(torch.where(inside[..., None], face_pt, clamped),
                      inside)


def project_segment(pt, a, b):
    ab = b - a
    t = torch.clamp(dot(pt - a, ab) / torch.clamp(dot(ab, ab), min=1e-30),
                    0.0, 1.0)
    return Projection(a + t[..., None] * ab, _no_inside(pt))


def project_capsule(pt, half_height, radius, *, boundary: bool):
    hh, r = _per_point(half_height, pt), _per_point(radius, pt)
    y = torch.clamp(pt[..., 1], -hh, hh)
    seg_pt = torch.zeros_like(pt)
    seg_pt[..., 1] = y
    d = pt - seg_pt
    inside = _norm(d) <= r
    on_surface = seg_pt + _unit(d) * r[..., None]
    point = (on_surface if boundary
             else torch.where(inside[..., None], pt, on_surface))
    return Projection(point, inside)


def project_triangle(pt, va, vb, vc):
    """Closest point on a 3D triangle (Ericson's regions, branch-free). The
    products that feed a sum are contracted as XLA contracts them
    (:func:`fma`), so the distances a mesh ranks its triangles by are the
    JAX package's to the bit and equal ones tie alike."""
    ab = vb - va
    ac = vc - va
    ap = pt - va
    d1 = dot_fma(ab, ap)
    d2 = dot_fma(ac, ap)
    bp = pt - vb
    d3 = dot_fma(ab, bp)
    d4 = dot_fma(ac, bp)
    cp = pt - vc
    d5 = dot_fma(ab, cp)
    d6 = dot_fma(ac, cp)

    va_r = fma(d3, d6, -(d5 * d4))
    vb_r = fma(d5, d2, -(d1 * d6))
    vc_r = fma(d1, d4, -(d3 * d2))

    denom = torch.clamp(va_r + vb_r + vc_r, min=1e-30)
    v = vb_r / denom
    w = vc_r / denom
    p_face = fma(ac, w[..., None], fma(ab, v[..., None], va))

    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0.0, 1.0)
    p_ab = fma(ab, t_ab[..., None], va)
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0.0, 1.0)
    p_ac = fma(ac, t_ac[..., None], va)
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6),
                                               min=1e-30), 0.0, 1.0)
    p_bc = fma(vc - vb, t_bc[..., None], vb)

    regions = (
        ((va_r <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), p_bc),
        ((vb_r <= 0) & (d2 >= 0) & (d6 <= 0), p_ac),
        ((vc_r <= 0) & (d1 >= 0) & (d3 <= 0), p_ab),
        ((d6 >= 0) & (d5 <= d6), vc),
        ((d3 >= 0) & (d4 <= d3), vb),
        ((d1 <= 0) & (d2 <= 0), va),
    )
    point = p_face
    for cond, p in regions:  # later regions take precedence
        point = torch.where(cond[..., None], p, point)
    return Projection(point, _no_inside(pt))


def _planar_parts(pt):
    """(planar distance, unit 2D direction) of pt.xz, shared by the cone
    and the cylinder."""
    xz = _stack(pt[..., 0], pt[..., 2])
    planar = _norm(xz)
    fb = torch.zeros_like(xz)
    fb[..., 0] = 1.0
    dir2 = torch.where(planar[..., None] > 0.0,
                       xz / torch.clamp(planar[..., None], min=1e-30), fb)
    return planar, dir2


def project_cone(pt, half_height, radius, *, boundary: bool):
    """Point projection on a 3D cone, apex +Y."""
    hh, r = _per_point(half_height, pt), _per_point(radius, pt)
    zero = torch.zeros_like(hh)
    planar, dir2 = _planar_parts(pt)
    on_basis = _stack(pt[..., 0], -hh, pt[..., 2])
    basis_cond = (pt[..., 1] < -hh) & (planar <= r)
    circle = _stack(dir2[..., 0] * r, -hh, dir2[..., 1] * r)
    apex = _stack(zero, hh, zero)
    proj_seg = project_segment(pt, apex, circle).point
    seg_dir = circle - apex
    apex_to_base = _stack(zero, -2.0 * hh, zero)
    inside = ((pt[..., 1] >= -hh) & (pt[..., 1] <= hh)
              & (dot(cross(seg_dir, pt - apex),
                     cross(seg_dir, apex_to_base)) >= 0.0))
    is_in = inside & ~basis_cond
    if not boundary:
        point = torch.where(basis_cond[..., None], on_basis,
                            torch.where(inside[..., None], pt, proj_seg))
        return Projection(point, is_in)
    d_seg = dot(proj_seg - pt, proj_seg - pt)
    d_basis = dot(on_basis - pt, on_basis - pt)
    inside_pt = torch.where((d_seg > d_basis)[..., None], on_basis, proj_seg)
    point = torch.where(basis_cond[..., None], on_basis,
                        torch.where(inside[..., None], inside_pt, proj_seg))
    return Projection(point, is_in)


def project_cylinder(pt, half_height, radius, *, boundary: bool):
    """Point projection on a 3D cylinder, axis Y."""
    hh, r = _per_point(half_height, pt), _per_point(radius, pt)
    planar, dir2 = _planar_parts(pt)
    y = pt[..., 1]
    inside = (y >= -hh) & (y <= hh) & (planar <= r)
    in_disk = planar <= r
    cap_y = torch.where(y > 0.0, hh, -hh)
    on_cap = _stack(pt[..., 0], cap_y, pt[..., 2])
    on_cap_circle = _stack(dir2[..., 0] * r, cap_y, dir2[..., 1] * r)
    on_side = _stack(dir2[..., 0] * r, torch.clamp(y, -hh, hh),
                     dir2[..., 1] * r)
    # outside: above or below → the cap plane (in the disk) or its circle;
    # otherwise the side
    out_pt = torch.where((torch.abs(y) > hh)[..., None],
                         torch.where(in_disk[..., None], on_cap,
                                     on_cap_circle),
                         on_side)
    if not boundary:
        return Projection(torch.where(inside[..., None], pt, out_pt), inside)
    # inside → the nearest of top, bottom and side
    d_top = hh - y
    d_bottom = y + hh
    d_side = r - planar
    top_pt = _stack(pt[..., 0], hh, pt[..., 2])
    bottom_pt = _stack(pt[..., 0], -hh, pt[..., 2])
    side_pt = _stack(dir2[..., 0] * r, y, dir2[..., 1] * r)
    use_top = (d_top < d_bottom) & (d_top < d_side)
    use_bottom = ~use_top & (d_bottom < d_top) & (d_bottom < d_side)
    in_pt = torch.where(use_top[..., None], top_pt,
                        torch.where(use_bottom[..., None], bottom_pt,
                                    side_pt))
    return Projection(torch.where(inside[..., None], in_pt, out_pt), inside)


def _project_convex(shapes: shp.ShapeSet, p_loc, mask, *, boundary: bool,
                    epa_cap: int):
    """The closest point of convex polyhedron i to the LOCAL point: a ball
    of radius 0 at the point against the polyhedron at the identity, GJK's
    witness outside and EPA's exit inside."""
    from wgmath_tpu_torch.queries.gjk import pfm_contact

    n = p_loc.shape[0]
    rot = torch.zeros((n, 4), device=p_loc.device)
    rot[:, 3] = 1.0
    ones = torch.ones((n,), device=p_loc.device)
    normal, _, dist, _ = pfm_contact(
        torch.zeros_like(shapes.tag), torch.zeros_like(shapes.params),
        Sim(rot, p_loc, ones), shapes.tag, shapes.params,
        Sim(rot, torch.zeros_like(p_loc), ones), mask=mask, epa_cap=epa_cap,
        vertices=shapes.vertices, window=shp.vertex_window(shapes))
    # A (the point) → B: the surface point is pt + n·dist outside (dist >
    # 0) and inside (dist < 0, back out along −n)
    surf = p_loc + normal * dist[..., None]
    inside = dist < 0.0
    point = surf if boundary else torch.where(inside[..., None], p_loc,
                                              surf)
    return Projection(point, inside)


def _project_mesh(shapes: shp.ShapeSet, p_loc, mask, *,
                  k_clusters: int = 4):
    """The closest boundary point of mesh i (trimesh: triangles;
    polyline: segments) to the LOCAL point; ``is_inside`` is False."""
    from wgmath_tpu_torch.queries.mesh_accel import (
        gather_prims,
        point_topk_prims,
        use_clusters,
    )

    first_idx = shapes.params[:, 2].to(torch.int64)
    num_idx = torch.where(mask, shapes.params[:, 3],
                          torch.zeros_like(shapes.params[:, 3])).to(
                              torch.int64)
    if shapes.indices.shape[1] == 3:
        def proj_fn(pt, *verts):
            return project_triangle(pt, *verts).point
    else:
        def proj_fn(pt, *verts):
            return project_segment(pt, *verts).point

    def score_fn(pt, *verts):
        return norm_fma(proj_fn(pt, *verts) - pt)

    if use_clusters(shapes):
        best = point_topk_prims(shapes, first_idx, num_idx, p_loc, 1,
                                score_fn, k_clusters=k_clusters)[0][:, 0]
    else:  # a masked arg-min over the whole (small) index buffer
        cand = torch.arange(max(shapes.indices.shape[0], 1),
                            device=p_loc.device).expand(p_loc.shape[0], -1)
        s = score_fn(p_loc[:, None, :], *gather_prims(shapes, cand))
        ok = ((cand >= first_idx[:, None])
              & (cand < (first_idx + num_idx)[:, None]))
        best = torch.argmin(torch.where(ok, s, torch.inf), dim=-1)
    verts = gather_prims(shapes, best[:, None])
    return Projection(proj_fn(p_loc, *(v[:, 0] for v in verts)),
                      _no_inside(p_loc))


def project(shapes: shp.ShapeSet, poses: Sim, points: torch.Tensor,
            *, boundary: bool = False, epa_cap: int = 256) -> Projection:
    """World-space projection of point i onto collider i (masked dispatch
    over the tags in ``shapes.kinds``; a tag without a projection raises
    ``ValueError``). ``epa_cap``: the EPA batch of the convex branch."""
    p_loc = sim_ops.inv_mul_pt(poses, points)
    par = shapes.params
    tag = shapes.tag
    dim = points.shape[-1]
    kinds = shapes.kinds

    handled = {shp.BALL, shp.CUBOID, shp.CAPSULE, shp.SEGMENT, shp.TRIANGLE,
               shp.CONVEX, shp.TRIMESH, shp.POLYLINE}
    if dim == 3:
        handled |= {shp.CONE, shp.CYLINDER}
    unhandled = set(kinds) - handled
    if unhandled:
        raise ValueError(
            f"project(): no projection kernel for shape tags {unhandled} "
            f"in {dim}D (scene kinds: {sorted(kinds)})")

    res_pt = p_loc
    res_in = _no_inside(p_loc)

    def put(cond, proj):
        nonlocal res_pt, res_in
        res_pt = torch.where(cond[..., None], proj.point, res_pt)
        res_in = torch.where(cond, proj.is_inside, res_in)

    if shp.BALL in kinds:
        put(tag == shp.BALL, project_ball(p_loc, par[:, 0],
                                          boundary=boundary))
    if shp.CUBOID in kinds:
        put(tag == shp.CUBOID, project_cuboid(p_loc, par[:, :dim],
                                              boundary=boundary))
    if shp.CAPSULE in kinds and dim == 3:
        put(tag == shp.CAPSULE, project_capsule(p_loc, par[:, 0], par[:, 1],
                                                boundary=boundary))
    if shp.CAPSULE in kinds and dim == 2:
        # a 2D capsule: a segment along local Y plus a radius
        hh = par[:, 0]
        zero = torch.zeros_like(hh)
        seg = project_segment(p_loc, _stack(zero, -hh),
                              _stack(zero, hh)).point
        d = p_loc - seg
        inside = _norm(d) <= par[:, 1]
        on_surface = seg + _unit(d) * par[:, 1][..., None]
        pt2 = (on_surface if boundary
               else torch.where(inside[..., None], p_loc, on_surface))
        put(tag == shp.CAPSULE, Projection(pt2, inside))
    if shp.CONE in kinds and dim == 3:
        put(tag == shp.CONE, project_cone(p_loc, par[:, 0], par[:, 1],
                                          boundary=boundary))
    if shp.CYLINDER in kinds and dim == 3:
        put(tag == shp.CYLINDER, project_cylinder(p_loc, par[:, 0],
                                                  par[:, 1],
                                                  boundary=boundary))
    if shp.SEGMENT in kinds:
        put(tag == shp.SEGMENT,
            project_segment(p_loc, par[:, :dim], par[:, dim:2 * dim]))
    if shp.TRIANGLE in kinds and dim == 3:
        first = par[:, 0].to(torch.int64)
        vmax = max(shapes.vertices.shape[0] - 1, 0)
        va, vb, vc = (shapes.vertices[torch.clamp(first + i, 0, vmax)]
                      for i in range(3))
        put(tag == shp.TRIANGLE, project_triangle(p_loc, va, vb, vc))
    if shp.CONVEX in kinds and dim == 3:
        put(tag == shp.CONVEX,
            _project_convex(shapes, p_loc, tag == shp.CONVEX,
                            boundary=boundary, epa_cap=epa_cap))
    if kinds & {shp.TRIMESH, shp.POLYLINE}:
        is_mesh = (tag == shp.TRIMESH) | (tag == shp.POLYLINE)
        put(is_mesh, _project_mesh(shapes, p_loc, is_mesh))

    return Projection(sim_ops.mul_pt(poses, res_pt), res_in)


register_module(
    KernelModule(
        "queries.projection",
        deps=("geometry.sim",),
        provides={
            "project_ball": project_ball,
            "project_cuboid": project_cuboid,
            "project_segment": project_segment,
            "project_capsule": project_capsule,
            "project_triangle": project_triangle,
            "project_cone": project_cone,
            "project_cylinder": project_cylinder,
            "project": project,
        },
        entries={
            "project_balls": EntryPoint(
                fn=lambda p: project_ball(p, 1.0, boundary=False),
                example_args=lambda device: (
                    torch.ones((512, 3), device=device),),
            )
        },
        doc="Point projection queries.",
    )
)
