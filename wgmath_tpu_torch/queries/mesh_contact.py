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
In 2D the polylines take balls (the ``k_best`` nearest segments) and
cuboids (the ``k_best`` deepest segments by a three-axis SAT, two points
a face). Plain tensor code on the caller's device, no kernel."""

from __future__ import annotations

import functools

import torch

from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.dynamics.constraint import Contacts
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries.gjk import _sqrt, _unit, norm_fma, pfm_contact
from wgmath_tpu_torch.queries.mesh_accel import (
    point_topk_prims,
    smallest_k,
    use_clusters,
)
from wgmath_tpu_torch.queries.narrow_phase import _compact_mask, graph_call
from wgmath_tpu_torch.queries.projection import (
    project_segment,
    project_triangle,
)
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
    it, ``k_best`` rows a pair each; with a polyline its ball pairs, then
    its cuboid pairs, each at half the capacity, two rows a pair (the JAX
    pipeline's order)."""
    if shp.POLYLINE in shapes.kinds:
        if shp.BALL in shapes.kinds:
            contacts = concat_contacts(contacts, polyline_ball_contacts(
                poses, shapes, pairs, prediction,
                pair_cap=pair_capacity // 2, k_best=2, p_max=p_max))
        if shp.CUBOID in shapes.kinds:
            contacts = concat_contacts(contacts, polyline_cuboid_contacts(
                poses, shapes, pairs, prediction,
                pair_cap=pair_capacity // 2, k_best=2))
    if shp.TRIMESH not in shapes.kinds:
        return contacts
    contacts = concat_contacts(contacts, mesh_ball_contacts(
        poses, shapes, pairs, prediction, pair_cap=pair_capacity,
        k_best=k_best, p_max=p_max))
    return concat_contacts(contacts, mesh_convex_contacts(
        poses, shapes, pairs, prediction, pair_cap=pair_capacity // 2,
        k_best=k_best, p_max=p_max))


def _polyline_batch(shapes: shp.ShapeSet, pairs: PairList, other: int,
                    pair_cap: int):
    """The valid (polyline, ``other``-tag) pairs compacted into a batch of
    ``pair_cap``: (polyline body, other body, active)."""
    tag_a, tag_b = shapes.tag[pairs.body_a], shapes.tag[pairs.body_b]
    flags = (((tag_a == shp.POLYLINE) & (tag_b == other))
             | ((tag_b == shp.POLYLINE) & (tag_a == other))) & pairs.valid
    sel, active, _ = _compact_mask(flags, pair_cap)
    pa, pb = pairs.body_a[sel], pairs.body_b[sel]
    mesh_is_a = shapes.tag[pa] == shp.POLYLINE
    return (torch.where(mesh_is_a, pa, pb), torch.where(mesh_is_a, pb, pa),
            active)


def _seg_dist(pt, va, vb):
    d = pt - project_segment(pt, va, vb).point
    return _sqrt(torch.sum(d * d, dim=-1))


def polyline_ball_contacts(poses: Sim, shapes: shp.ShapeSet,
                           pairs: PairList, prediction: float, *,
                           pair_cap: int = 256, k_best: int = 2,
                           p_max: int = 2) -> Contacts:
    """2D contacts of (polyline, ball) pairs, the ``k_best`` nearest
    segments a pair (the JAX package's ``polyline_ball_contacts``): a
    ``Contacts`` buffer of ``pair_cap * k_best`` rows with the ball as body
    A, one point on its surface a row."""
    dev = poses.translation.device
    mesh_body, ball_body, active = _polyline_batch(shapes, pairs, shp.BALL,
                                                   pair_cap)
    mesh_pose, ball_pose = poses.take(mesh_body), poses.take(ball_body)
    radius = shapes.params[ball_body, 0] * ball_pose.scale
    first_idx = shapes.params[mesh_body, 2].to(torch.int64)
    num_idx = shapes.params[mesh_body, 3].to(torch.int64)
    c_local = sim_ops.inv_mul_pt(mesh_pose, ball_pose.translation)

    def score_fn(pt, va, vb):
        return _seg_dist(pt, va, vb) - radius[:, None]

    best, best_d = _topk_by_score(
        shapes, first_idx, num_idx, c_local, active, k_best, score_fn,
        offset=radius, max_score=prediction)
    hit = best_d < prediction
    va, vb = _gather_prim_verts(shapes, best)
    bpt = project_segment(c_local[:, None, :], va, vb).point
    n_mesh = c_local[:, None, :] - bpt
    nn = _sqrt(torch.sum(n_mesh * n_mesh, dim=-1, keepdim=True))
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
    points = torch.zeros((cap, p_max, 2), device=dev)
    points[:, 0] = pt_a_local.reshape(cap, 2)
    dists = torch.full((cap, p_max), 1e9, device=dev)
    dists[:, 0] = best_d.reshape(cap)
    return Contacts(
        ball_body[:, None].expand(pair_cap, k_best).reshape(cap),
        mesh_body[:, None].expand(pair_cap, k_best).reshape(cap),
        n_a_local.reshape(cap, 2), points, dists, valid.to(torch.int64),
        valid)


def polyline_cuboid_contacts(poses: Sim, shapes: shp.ShapeSet,
                             pairs: PairList, prediction: float, *,
                             pair_cap: int = 256,
                             k_best: int = 2) -> Contacts:
    """2D contacts of (polyline, cuboid) pairs (the JAX package's
    ``polyline_cuboid_contacts``): each segment against the box by SAT
    over the box's two face axes and the segment's normal, the ``k_best``
    deepest segments a pair, a face manifold of up to two points (the
    segment clipped to the face's slab) or the deepest corner against the
    segment. The box is body A; the arithmetic runs in its frame, so
    normals and points come out in the output's convention."""
    mesh_body, box_body, active = _polyline_batch(shapes, pairs, shp.CUBOID,
                                                  pair_cap)
    mesh_pose, box_pose = poses.take(mesh_body), poses.take(box_body)
    he = shapes.params[box_body, :2]
    first_idx = shapes.params[mesh_body, 2].to(torch.int64)
    num_idx = shapes.params[mesh_body, 3].to(torch.int64)
    c_box_local = sim_ops.inv_mul_pt(mesh_pose, box_pose.translation)
    if use_clusters(shapes):
        # a segment farther from the box centre than its reach is
        # separated by more than the prediction: the preselect is exact
        reach = ((_sqrt(torch.sum(he * he, dim=-1)) + prediction)
                 * box_pose.scale / torch.clamp(mesh_pose.scale, min=1e-9))
        pre_ids, pre_s = point_topk_prims(
            shapes, first_idx, num_idx * active, c_box_local,
            max(4 * k_best, 8), _seg_dist, offset=0.0, max_score=reach)
        sv0, sv1 = _gather_prim_verts(shapes, pre_ids)
        seg_mask = pre_s < torch.clamp(reach[:, None], max=1e8)
    else:
        segs = shapes.indices
        sv0 = shapes.vertices[segs[:, 0]][None]
        sv1 = shapes.vertices[segs[:, 1]][None]
        seg_ids = torch.arange(max(segs.shape[0], 1), device=he.device)
        seg_mask = ((seg_ids[None, :] >= first_idx[:, None])
                    & (seg_ids[None, :] < (first_idx + num_idx)[:, None])
                    & active[:, None])
    mesh_b, box_b = _broadcast(mesh_pose), _broadcast(box_pose)
    p0 = sim_ops.inv_mul_pt(box_b, sim_ops.mul_pt(mesh_b, sv0))
    p1 = sim_ops.inv_mul_pt(box_b, sim_ops.mul_pt(mesh_b, sv1))

    # SAT over three axes: the box's x and y, the segment's normal
    lo, hi = torch.minimum(p0, p1), torch.maximum(p0, p1)
    heb = he[:, None, :]
    sep_pos, sep_neg = lo - heb, -hi - heb
    face_sep_xy = torch.maximum(sep_pos, sep_neg)  # [P, S, 2]
    face_sign = torch.where(sep_pos >= sep_neg, 1.0, -1.0)
    face_sep, face_axis = torch.max(face_sep_xy, dim=-1)
    d = p1 - p0
    seg_len = _sqrt(torch.sum(d * d, dim=-1))
    n_s = (torch.stack([-d[..., 1], d[..., 0]], dim=-1)
           / torch.clamp(seg_len, min=1e-30)[..., None])
    c = torch.sum(n_s * p0, dim=-1)
    r_box = torch.sum(torch.abs(n_s) * heb, dim=-1)
    sep_n = torch.where(seg_len > 1e-9, torch.abs(c) - r_box,
                        torch.full_like(c, -1e9))
    n_dir = n_s * torch.sign(c)[..., None]  # A→B (box → segment)
    use_face = face_sep > sep_n - 1e-3  # face manifolds near ties
    sep = torch.maximum(face_sep, sep_n)
    best_sep, best = smallest_k(torch.where(seg_mask, sep, 1e9), k_best)

    def takek(x):  # per (pair, selected segment)
        if x.dim() == 2:
            return torch.gather(x, 1, best)
        return torch.gather(x, 1, best[..., None].expand(-1, -1,
                                                         x.shape[-1]))

    p0k, dk = takek(p0.expand(best.shape[0], -1, -1)), takek(
        d.expand(best.shape[0], -1, -1))
    axk = takek(face_axis)
    sgk = takek(face_sign)
    sgk = torch.where(axk == 0, sgk[..., 0], sgk[..., 1])
    usek = takek(use_face)
    n_dirk = takek(n_dir.expand(best.shape[0], -1, -1))
    hit = (best_sep < prediction) & active[:, None]
    hex_, hey = he[:, None, 0], he[:, None, 1]
    he_i = torch.where(axk == 0, hex_, hey)
    he_j = torch.where(axk == 0, hey, hex_)

    def comp(v, i):  # component i (0 or 1) of [..., 2]
        return torch.where(i == 0, v[..., 0], v[..., 1])

    # the face case: the segment's parameters clipped to the tangential
    # slab |x_j| <= he_j
    j = 1 - axk
    p0j, dj = comp(p0k, j), comp(dk, j)
    tiny = torch.where(dj < 0, -1e-12, 1e-12)
    inv_dj = 1.0 / torch.where(torch.abs(dj) < 1e-12, tiny, dj)
    ta, tb = (-he_j - p0j) * inv_dj, (he_j - p0j) * inv_dj
    t_lo = torch.clamp(torch.minimum(ta, tb), min=0.0)
    t_hi = torch.clamp(torch.maximum(ta, tb), max=1.0)
    slab_hit = t_hi >= t_lo
    q0 = p0k + t_lo[..., None] * dk
    q1 = p0k + t_hi[..., None] * dk
    d0 = sgk * comp(q0, axk) - he_i
    d1 = sgk * comp(q1, axk) - he_i
    zk = torch.zeros_like(sgk)
    x_face = (axk == 0)[..., None]
    n_face = torch.where(x_face, torch.stack([sgk, zk], -1),
                         torch.stack([zk, sgk], -1))

    def on_face(q):  # the clipped point projected onto the face
        qi = sgk * he_i
        return torch.where(x_face, torch.stack([qi, q[..., 1]], -1),
                           torch.stack([q[..., 0], qi], -1))

    f_pt0, f_pt1 = on_face(q0), on_face(q1)
    # the corner case: the deepest box corner against the segment
    sgn_c = torch.where(n_dirk >= 0.0, 1.0, -1.0)
    corner = sgn_c * torch.stack([hex_.expand_as(sgk), hey.expand_as(sgk)],
                                 -1)
    t_c = torch.clamp(torch.sum((corner - p0k) * dk, dim=-1)
                      / torch.clamp(torch.sum(dk * dk, dim=-1), min=1e-30),
                      0.0, 1.0)
    delta = p0k + t_c[..., None] * dk - corner
    d_c = _sqrt(torch.sum(delta * delta, dim=-1))
    into = torch.sum(delta * n_dirk, dim=-1)
    pen = into < 0.0  # the corner past the segment's line
    n_corner = torch.where((pen | (d_c < 1e-9))[..., None], n_dirk,
                           delta / torch.clamp(d_c, min=1e-30)[..., None])
    dist_corner = torch.where(pen, into, d_c)

    scale = box_pose.scale[:, None]
    use_f = usek & slab_hit
    n_out = torch.where(use_f[..., None], n_face, n_corner)
    pt0 = torch.where(use_f[..., None], f_pt0, corner)
    pt1 = torch.where(use_f[..., None], f_pt1, corner)
    di0 = torch.where(use_f, d0, dist_corner) * scale
    di1 = torch.where(use_f, d1, dist_corner) * scale
    v0 = hit & (torch.where(use_f, d0, dist_corner) < prediction)
    v1 = hit & use_f & (d1 < prediction)
    # live points fill the first num_points slots: slot 1 moves down
    # where slot 0 missed
    shift = ~v0 & v1
    pt0 = torch.where(shift[..., None], pt1, pt0)
    di0 = torch.where(shift, di1, di0)
    v0, v1 = v0 | shift, v1 & ~shift
    cap = pair_cap * k_best
    pts = torch.stack([pt0, pt1], dim=2).reshape(cap, 2, 2)
    dis = torch.where(torch.stack([v0, v1], 2), torch.stack([di0, di1], 2),
                      torch.full_like(di0, 1e9)[..., None]).reshape(cap, 2)
    nump = (v0.to(torch.int64) + v1.to(torch.int64)).reshape(cap)
    valid = (v0 | v1).reshape(cap)
    return Contacts(
        box_body[:, None].expand(pair_cap, k_best).reshape(cap),
        mesh_body[:, None].expand(pair_cap, k_best).reshape(cap),
        n_out.reshape(cap, 2), pts, dis, nump, valid)
