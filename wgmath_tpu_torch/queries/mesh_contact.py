"""The mesh narrow phase: contacts of balls and support-mapped convex
shapes against triangle meshes (counterpart of
``wgmath_tpu/queries/mesh_contact.py``, 3D).

Mesh pairs are compacted into a fixed batch; each pair keeps its
``k_best`` best triangles, found by a dense [pairs, triangles] scoring on a
small mesh or by the certified cluster rounds of
``queries/mesh_accel.py`` on a large one, and each of those triangles
emits a one-point manifold. The rows of one pair share its dynamic body.
Pairs past the batch's capacity are dropped without a count, as in the
JAX package (ROADMAP C12; :func:`mesh_pair_demand` reads the demand).
Plain tensor code on the caller's device, no kernel. The 2D polyline
contacts wait for the port of 2D (ROADMAP item 4)."""

from __future__ import annotations

import functools

import torch

from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.dynamics.constraint import Contacts
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries.gjk import _unit, norm_fma, pfm_contact
from wgmath_tpu_torch.queries.mesh_accel import (
    point_topk_prims,
    smallest_k,
    use_clusters,
)
from wgmath_tpu_torch.queries.narrow_phase import _compact_mask, graph_call
from wgmath_tpu_torch.queries.projection import project_triangle
from wgmath_tpu_torch.shapes import shape as shp
from wgmath_tpu_torch.shapes.mesh import TRI_MARGIN

# the convex kinds a trimesh pairs with through per-triangle GJK
CONVEX_KINDS = (shp.CUBOID, shp.CAPSULE, shp.CONE, shp.CYLINDER, shp.CONVEX)


def _is_convex(tag: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(tag, dtype=torch.bool)
    for k in CONVEX_KINDS:
        out |= tag == k
    return out


def _mesh_flags(shapes: shp.ShapeSet, pairs: PairList):
    """(ball, convex) masks of the valid pairs of a trimesh with a ball
    and with a convex shape."""
    tag_a, tag_b = shapes.tag[pairs.body_a], shapes.tag[pairs.body_b]
    mesh_a, mesh_b = tag_a == shp.TRIMESH, tag_b == shp.TRIMESH
    ball = ((mesh_a & (tag_b == shp.BALL)) | (mesh_b & (tag_a == shp.BALL)))
    cvx = (mesh_a & _is_convex(tag_b)) | (mesh_b & _is_convex(tag_a))
    return ball & pairs.valid, cvx & pairs.valid


def mesh_pair_demand(shapes: shp.ShapeSet, pairs: PairList) -> torch.Tensor:
    """[2] the unclamped counts of trimesh-ball and trimesh-convex pairs in
    ``pairs``: the demand on :func:`mesh_ball_contacts`' and
    :func:`mesh_convex_contacts`' capacities, which the step neither
    reports nor regrows (ROADMAP C12). A device tensor, no sync."""
    ball, cvx = _mesh_flags(shapes, pairs)
    return torch.stack([ball.sum(), cvx.sum()])


def _topk_by_score(shapes: shp.ShapeSet, first_idx, num_idx, c_local,
                   active, k_best: int, score_fn, offset, max_score,
                   k_clusters: int = 4, rounds: list | None = None):
    """The exact ``k_best`` best primitives by ``score_fn`` around the
    mesh-local point ``c_local``, a pair row: a dense [P, T] scoring of the
    whole index buffer on a small mesh, the cluster rounds
    (``mesh_accel.point_topk_prims``) on a clustered large one. Either way
    ``(ids [P, K], scores [P, K])``, global ids, 1e9-padded scores, equal
    scores by the lower id first. ``score_fn`` must satisfy ``score >=
    dist(point, primitive AABB) - offset``; scores at or above
    ``max_score`` are not exact."""
    if use_clusters(shapes):
        return point_topk_prims(
            shapes, first_idx, num_idx * active, c_local, k_best, score_fn,
            offset=offset, k_clusters=k_clusters, max_score=max_score,
            rounds=rounds)
    prims = shapes.indices
    verts = tuple(shapes.vertices[prims[:, i]][None]
                  for i in range(prims.shape[1]))
    s = score_fn(c_local[:, None, :], *verts)
    ids = torch.arange(prims.shape[0], device=c_local.device)
    mask = ((ids[None, :] >= first_idx[:, None])
            & (ids[None, :] < (first_idx + num_idx)[:, None])
            & active[:, None])
    best_s, best = smallest_k(torch.where(mask, s, 1e9), k_best)
    return best, best_s


def _gather_prim_verts(shapes: shp.ShapeSet, ids: torch.Tensor) -> tuple:
    """Global primitive ids [P, K] → one [P, K, dim] array a corner."""
    prim = shapes.indices[torch.clamp(ids, 0,
                                      max(shapes.indices.shape[0] - 1, 0))]
    return tuple(shapes.vertices[prim[..., i]]
                 for i in range(shapes.indices.shape[1]))


def _broadcast(pose: Sim) -> Sim:
    """``pose`` [P] as [P, 1] for per-(pair, k) arithmetic."""
    return Sim(pose.rotation[:, None], pose.translation[:, None],
               pose.scale[:, None])


def _tri_dist(pt, va, vb, vc):
    return norm_fma(pt - project_triangle(pt, va, vb, vc).point)


def mesh_ball_contacts(poses: Sim, shapes: shp.ShapeSet, pairs: PairList,
                       prediction: float, *, pair_cap: int = 512,
                       k_best: int = 4, p_max: int = 4) -> Contacts:
    """Contacts of (trimesh, ball) pairs, the ``k_best`` nearest triangles
    a pair: a ``Contacts`` buffer of ``pair_cap * k_best`` rows with the
    ball as body A (one point on its surface a row)."""
    dev = poses.translation.device
    flags, _ = _mesh_flags(shapes, pairs)
    sel, active, _ = _compact_mask(flags, pair_cap)
    pa, pb = pairs.body_a[sel], pairs.body_b[sel]
    mesh_is_a = shapes.tag[pa] == shp.TRIMESH
    mesh_body = torch.where(mesh_is_a, pa, pb)
    ball_body = torch.where(mesh_is_a, pb, pa)
    mesh_pose, ball_pose = poses.take(mesh_body), poses.take(ball_body)
    radius = shapes.params[ball_body, 0] * ball_pose.scale
    first_idx = shapes.params[mesh_body, 2].to(torch.int64)
    num_idx = shapes.params[mesh_body, 3].to(torch.int64)
    # the ball's centre in the mesh's frame
    c_local = sim_ops.inv_mul_pt(mesh_pose, ball_pose.translation)

    def score_fn(pt, va, vb, vc):
        return _tri_dist(pt, va, vb, vc) - radius[:, None]

    best, best_d = _topk_by_score(
        shapes, first_idx, num_idx, c_local, active, k_best, score_fn,
        offset=radius, max_score=prediction)
    hit = best_d < prediction

    # a point on the ball's surface and the normal ball → mesh, each row
    va, vb, vc = _gather_prim_verts(shapes, best)
    bpt = project_triangle(c_local[:, None, :], va, vb, vc).point
    n_mesh = c_local[:, None, :] - bpt
    nn = norm_fma(n_mesh)[..., None]
    n_mesh = torch.where(nn > 1e-9, n_mesh / torch.clamp(nn, min=1e-30),
                         _unit(1, n_mesh))
    n_ab = -sim_ops.mul_unit_vec(_broadcast(mesh_pose), n_mesh)
    ball_b = _broadcast(ball_pose)
    n_a_local = sim_ops.inv_mul_unit_vec(ball_b, n_ab)
    pt_world = ball_pose.translation[:, None, :] + n_ab * radius[:, None,
                                                                 None]
    pt_a_local = sim_ops.inv_mul_pt(ball_b, pt_world)

    cap = pair_cap * k_best
    valid = (hit & active[:, None]).reshape(cap)
    points = torch.zeros((cap, p_max, 3), device=dev)
    points[:, 0] = pt_a_local.reshape(cap, 3)
    dists = torch.full((cap, p_max), 1e9, device=dev)
    dists[:, 0] = best_d.reshape(cap)
    return Contacts(
        ball_body[:, None].expand(pair_cap, k_best).reshape(cap),
        mesh_body[:, None].expand(pair_cap, k_best).reshape(cap),
        n_a_local.reshape(cap, 3), points, dists, valid.to(torch.int64),
        valid)


def concat_contacts(a: Contacts, b: Contacts) -> Contacts:
    return Contacts(*(torch.cat([getattr(a, f), getattr(b, f)]) for f in
                      ("body_a", "body_b", "normal_a", "points_a", "dist",
                       "num_points", "valid")))


def _tri_gjk(rot_t, tr_t, sc_t, rot_c, tr_c, sc_c, tag_c, par_c, mask,
             tri_v, *, vertices, window: int, tri_margin: float):
    """``pfm_contact`` of triangles (A, their vertices ``tri_v``, dilated
    by ``tri_margin``) against convex shapes (B), no EPA: the normal, the
    point on A and the distance."""
    n = tri_v.shape[0]
    return pfm_contact(
        torch.full((n,), shp.TRIANGLE, dtype=torch.int64,
                   device=tri_v.device),
        torch.zeros((n, shp.NUM_PARAMS), device=tri_v.device),
        Sim(rot_t, tr_t, sc_t), tag_c, par_c, Sim(rot_c, tr_c, sc_c),
        mask=mask, vertices=vertices, tri_verts_a=tri_v,
        tri_margin=tri_margin, use_epa=False, window=window)[:3]


def mesh_convex_contacts(poses: Sim, shapes: shp.ShapeSet, pairs: PairList,
                         prediction: float, *, pair_cap: int = 256,
                         k_best: int = 4, tri_margin: float = TRI_MARGIN,
                         p_max: int = 4) -> Contacts:
    """Contacts of (trimesh, convex) pairs by per-triangle GJK: the
    ``k_best`` triangles nearest the convex's centre (by surface distance,
    up to its bounding radius + ``tri_margin`` + ``prediction``), each
    dilated by ``tri_margin``; a core overlap past the margin is pushed
    along the centre axis (``pfm_contact(use_epa=False)``). The convex is
    body A. On the card the per-triangle GJK runs as a CUDA graph
    (``narrow_phase.graph_call``; the eager run's bits)."""
    dev = poses.translation.device
    _, flags = _mesh_flags(shapes, pairs)
    sel, active, _ = _compact_mask(flags, pair_cap)
    pa, pb = pairs.body_a[sel], pairs.body_b[sel]
    mesh_is_a = shapes.tag[pa] == shp.TRIMESH
    mesh_body = torch.where(mesh_is_a, pa, pb)
    cvx_body = torch.where(mesh_is_a, pb, pa)
    mesh_pose, cvx_pose = poses.take(mesh_body), poses.take(cvx_body)
    first_idx = shapes.params[mesh_body, 2].to(torch.int64)
    num_idx = shapes.params[mesh_body, 3].to(torch.int64)

    # a triangle contacts only if its surface comes within the convex's
    # bounding radius + margin + prediction of the centre (mesh units)
    c_local = sim_ops.inv_mul_pt(mesh_pose, cvx_pose.translation)
    he_cvx = shp.local_aabb_half_extents(shapes, 3)[cvx_body]
    cvx_rad = norm_fma(he_cvx) * cvx_pose.scale
    reach = (cvx_rad + tri_margin + prediction) / torch.clamp(
        mesh_pose.scale, min=1e-9)
    best, best_s = _topk_by_score(
        shapes, first_idx, num_idx, c_local, active, k_best, _tri_dist,
        offset=0.0, max_score=reach)
    cand_ok = best_s < torch.clamp(reach[:, None], max=1e8)

    # (pair, k) pseudo-pairs: A = the triangle (mesh frame), B = the convex
    mk = pair_cap * k_best
    tri_v = shapes.vertices[shapes.indices[best.reshape(mk)]]  # [MK, 3, 3]

    def rep(x):
        return x.repeat_interleave(k_best, dim=0)

    pose_tri = Sim(rep(mesh_pose.rotation), rep(mesh_pose.translation),
                   rep(mesh_pose.scale))
    pose_cvx = Sim(rep(cvx_pose.rotation), rep(cvx_pose.translation),
                   rep(cvx_pose.scale))
    act_mk = (active[:, None] & cand_ok).reshape(mk)
    window = shp.vertex_window(shapes)
    gjk = functools.partial(_tri_gjk, vertices=shapes.vertices,
                            window=window, tri_margin=tri_margin)
    args = (pose_tri.rotation, pose_tri.translation, pose_tri.scale,
            pose_cvx.rotation, pose_cvx.translation, pose_cvx.scale,
            shapes.tag[rep(cvx_body)], shapes.params[rep(cvx_body)], act_mk,
            tri_v)
    if dev.type == "cuda":
        # a window reads the vertex buffer, which the graph then holds
        key = ("mesh_gjk", dev, window, float(tri_margin),
               shapes.vertices.data_ptr() if window else None)
        n_tri, pt_tri, dist = graph_call(key, gjk, args)
    else:
        n_tri, pt_tri, dist = gjk(*args)
    # dist is to the dilated surface: bodies rest a margin above the
    # triangles. With the convex as body A the normal turns round, and
    # the point moves onto A's surface
    n_world = sim_ops.mul_unit_vec(pose_tri, n_tri)
    n_a = sim_ops.inv_mul_unit_vec(pose_cvx, -n_world)
    pt_a_world = sim_ops.mul_pt(pose_tri, pt_tri) + n_world * dist[:, None]
    pt_a = sim_ops.inv_mul_pt(pose_cvx, pt_a_world)

    valid = act_mk & (dist < prediction + tri_margin * 0.5)
    points = torch.zeros((mk, p_max, 3), device=dev)
    points[:, 0] = pt_a
    dists = torch.full((mk, p_max), 1e9, device=dev)
    dists[:, 0] = dist
    return Contacts(rep(cvx_body), rep(mesh_body), n_a, points, dists,
                    valid.to(torch.int64), valid)


def append_mesh_contacts(contacts: Contacts, poses: Sim,
                         shapes: shp.ShapeSet, pairs: PairList,
                         prediction: float, *, pair_capacity: int,
                         k_best: int, p_max: int) -> Contacts:
    """The step's mesh rows after the narrow phase's: the trimesh-ball
    pairs at ``pair_capacity``, then the trimesh-convex pairs at half of
    it, ``k_best`` rows a pair each (the JAX pipeline's order)."""
    if shp.TRIMESH not in shapes.kinds:
        return contacts
    contacts = concat_contacts(contacts, mesh_ball_contacts(
        poses, shapes, pairs, prediction, pair_cap=pair_capacity,
        k_best=k_best, p_max=p_max))
    return concat_contacts(contacts, mesh_convex_contacts(
        poses, shapes, pairs, prediction, pair_cap=pair_capacity // 2,
        k_best=k_best, p_max=p_max))
