"""SAT cuboid-cuboid contact manifolds (counterpart of
``wgmath_tpu/queries/sat.py``: ``cuboid_cuboid_manifold`` and its helpers
in 3D, ``cuboid_cuboid_manifold_2d``).

Batched and branch-free, as in the JAX package: 15 candidate axes (6 face
axes and 9 edge cross products), a preference for face axes over edge
axes, incident-face clipping into a fixed 8-vertex polygon buffer, and a
reduction to at most 4 points by plane extremes. Plain tensor code on the
caller's device; the JAX package runs it as plain ``jnp`` too.

The scenes that use it are lattices of equal, axis-aligned boxes, where
separations tie exactly. Every 3-term sum below is written out left to
right (``_dot3``, ``_mat_vec``, ``_mat_t_vec``), the order of the JAX
package's contractions on the CPU, and every ``argmax`` takes the first
maximal index, as ``jnp.argmax`` does, so ties resolve to the same axis.
"""

from __future__ import annotations

import torch

from wgmath_tpu_torch.geometry import quat, rot2
from wgmath_tpu_torch.geometry.sim import Sim

_FACE_BIAS = 0.98  # relative preference for face axes over edge axes
_EPS = 1e-6
_MAX_V = 8  # the clipped polygon's fixed vertex buffer
# the incident face's corners, in the two tangent coordinates
_CORNERS = ((1.0, 1.0), (1.0, -1.0), (-1.0, -1.0), (-1.0, 1.0))


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over the last axis of 3, summed left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + \
        a[..., 2] * b[..., 2]


def _mat_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("nij,nj->ni")``: m @ v, each row summed left to right."""
    return _dot3(m, v[:, None, :])


def _mat_t_vec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``einsum("nij,ni->nj")``: mᵀ @ v, summed over i left to right."""
    return _dot3(m.transpose(1, 2), v[:, None, :])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[n, idx[n]]`` over the last axis."""
    return torch.gather(x, -1, idx[:, None])[:, 0]


def cuboid_cuboid_manifold(pose_a: Sim, pose_b: Sim, he_a: torch.Tensor,
                           he_b: torch.Tensor, prediction: float):
    """Batched box-box manifold. Returns ``(normal_a, points_a, dists,
    num_points)``: the normal [N, 3] in A's local frame pointing A→B, the
    points [N, 4, 3] on or near A's surface in A's frame, their signed
    distances [N, 4] (< 0 penetrating; 1e9 in unused slots) and the point
    count [N] (int64)."""
    q_ab = quat.mul(quat.inv(pose_a.rotation), pose_b.rotation)
    r = quat.to_matrix(q_ab)  # columns: B's axes in A's frame
    t = quat.inv_mul_vec(pose_a.rotation,
                         pose_b.translation - pose_a.translation)
    t = t / pose_a.scale[..., None]
    he_b_eff = he_b * (pose_b.scale / pose_a.scale)[..., None]
    abs_r = torch.abs(r) + _EPS

    # separations on the 15 axes
    sep_a = torch.abs(t) - (he_a + _mat_vec(abs_r, he_b_eff))
    t_b = _mat_t_vec(r, t)
    sep_b = torch.abs(t_b) - (_mat_t_vec(abs_r, he_a) + he_b_eff)
    zero = torch.zeros_like(t[:, 0])
    edge_sep, edge_axis = [], []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            # e_i × R[:, j] in A's frame
            axis = torch.stack([
                zero if i == 0 else (-r[:, 2, j] if i == 1 else r[:, 1, j]),
                r[:, 2, j] if i == 0 else (zero if i == 1 else -r[:, 0, j]),
                -r[:, 1, j] if i == 0 else (r[:, 0, j] if i == 1 else zero),
            ], dim=-1)
            ln = torch.sqrt(_dot3(axis, axis))
            ok = ln > 1e-4  # near-parallel edges: no axis
            axis_u = axis / torch.clamp(ln, min=1e-30)[:, None]
            ra = (he_a[:, i1] * torch.abs(axis_u[:, i1])
                  + he_a[:, i2] * torch.abs(axis_u[:, i2]))
            proj_b = torch.abs(_mat_t_vec(r, axis_u))
            rb = he_b_eff[:, j1] * proj_b[:, j1] + he_b_eff[:, j2] * proj_b[:, j2]
            sep = torch.abs(_dot3(t, axis_u)) - (ra + rb)
            edge_sep.append(torch.where(ok, sep, -torch.inf))
            edge_axis.append(axis_u)
    edge_sep = torch.stack(edge_sep, dim=-1)  # [N, 9]
    edge_axis = torch.stack(edge_axis, dim=-2)  # [N, 9, 3]

    face_sep = torch.cat([sep_a, sep_b], dim=-1)  # [N, 6]
    # torch.argmax, like jnp.argmax, takes the first maximal entry (an all
    # -inf row gives 0)
    best_face = torch.argmax(face_sep, dim=-1)
    best_face_sep = _take(face_sep, best_face)
    best_edge = torch.argmax(edge_sep, dim=-1)
    best_edge_sep = _take(edge_sep, best_edge)
    # an edge axis wins only if clearly better (sign-safe: a multiplicative
    # bias alone flips its meaning for negative separations)
    use_edge = best_edge_sep > best_face_sep * _FACE_BIAS + 1.0e-3
    separation = torch.maximum(
        best_face_sep, torch.where(use_edge, best_edge_sep, -torch.inf))

    # the contact normal, A's frame, oriented A→B
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    face_axis_a = eye[best_face % 3]
    face_axis_b = torch.gather(
        r, 2, torch.clamp(best_face - 3, min=0)[:, None, None].expand(
            -1, 3, 1))[:, :, 0]
    n_face = torch.where((best_face < 3)[:, None], face_axis_a, face_axis_b)
    n_edge = torch.gather(edge_axis, 1, best_edge[:, None, None].expand(
        -1, 1, 3))[:, 0]
    normal = torch.where(use_edge[:, None], n_edge, n_face)
    flip = _dot3(normal, t) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)

    pts_face, dist_face, np_face = _face_clip_manifold(
        r, t, he_a, he_b_eff, normal, best_face, prediction)
    pts_edge, dist_edge = _edge_edge_point(r, t, he_a, he_b_eff, normal,
                                           best_edge)
    points = torch.where(
        use_edge[:, None, None],
        torch.cat([pts_edge[:, None], torch.zeros_like(pts_face[:, :3])],
                  dim=1),
        pts_face)
    dists = torch.where(
        use_edge[:, None],
        torch.cat([dist_edge[:, None], torch.full_like(dist_face[:, :3],
                                                       1e9)], dim=1),
        dist_face)
    num_points = torch.where(use_edge, 1, np_face)
    num_points = torch.where(separation < prediction, num_points, 0)
    return normal, points, dists, num_points


def _box_face_vertices(he: torch.Tensor, axis_idx: torch.Tensor,
                       sign: torch.Tensor) -> torch.Tensor:
    """The 4 vertices [N, 4, 3] of the box face whose outward normal is
    ``sign · e_axis``."""
    a1 = (axis_idx + 1) % 3
    a2 = (axis_idx + 2) % 3
    normal_c = (sign * _take(he, axis_idx))[:, None]
    h1, h2 = _take(he, a1)[:, None], _take(he, a2)[:, None]
    verts = []
    for c1, c2 in _CORNERS:
        v = torch.zeros_like(he)
        v = v.scatter(-1, axis_idx[:, None], normal_c)
        v = v.scatter(-1, a1[:, None], c1 * h1)
        v = v.scatter(-1, a2[:, None], c2 * h2)
        verts.append(v)
    return torch.stack(verts, dim=1)


def _face_clip_manifold(r, t, he_a, he_b, normal, best_face, prediction):
    """The reference face against the incident face: up to 4 points in A's
    frame, their distances and count."""
    n = t.shape[0]
    a_is_ref = best_face < 3
    ref_axis_idx = torch.where(a_is_ref, best_face, best_face - 3)
    # the reference face's outward normal: +normal on A, −normal on B
    ref_n = torch.where(a_is_ref[:, None], normal, -normal)

    # the incident face: the other box's face most anti-parallel to ref_n
    ref_n_in_b = _mat_t_vec(r, ref_n)
    inc_axis_b = torch.argmax(torch.abs(ref_n_in_b), dim=-1)
    inc_sign_b = -torch.sign(_take(ref_n_in_b, inc_axis_b))
    verts_b = _box_face_vertices(he_b, inc_axis_b, inc_sign_b)
    # t + R @ v for each vertex, each row summed left to right
    verts_b_in_a = t[:, None, :] + _dot3(r[:, None, :, :],
                                         verts_b[:, :, None, :])
    inc_axis_a = torch.argmax(torch.abs(ref_n), dim=-1)
    inc_sign_a = -torch.sign(_take(ref_n, inc_axis_a))
    verts_a = _box_face_vertices(he_a, inc_axis_a, inc_sign_a)
    inc_verts = torch.where(a_is_ref[:, None, None], verts_b_in_a, verts_a)

    # the reference face's centre and tangent axes, A's frame
    he_ref = torch.where(a_is_ref[:, None], he_a, he_b)
    ref_sign = torch.where(a_is_ref,
                           torch.sign(_take(ref_n, ref_axis_idx)),
                           torch.sign(_take(ref_n_in_b, ref_axis_idx)))
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    a1_idx = (ref_axis_idx + 1) % 3
    a2_idx = (ref_axis_idx + 2) % 3
    he_ref_n = _take(he_ref, ref_axis_idx)
    he_t1 = _take(he_ref, a1_idx)
    he_t2 = _take(he_ref, a2_idx)

    def to_a_frame(v_local):
        return torch.where(a_is_ref[:, None], v_local, _mat_vec(r, v_local))

    ref_center = (to_a_frame(eye[ref_axis_idx])
                  * (ref_sign * he_ref_n)[:, None]
                  + torch.where(a_is_ref[:, None], 0.0, t))
    t1 = to_a_frame(eye[a1_idx])
    t2 = to_a_frame(eye[a2_idx])

    poly = torch.cat([inc_verts, torch.zeros((n, _MAX_V - 4, 3),
                                             dtype=t.dtype, device=t.device)],
                     dim=1)
    count = torch.full((n,), 4, dtype=torch.int64, device=t.device)
    for plane_t, plane_d, sgn in ((t1, he_t1, 1.0), (t1, he_t1, -1.0),
                                  (t2, he_t2, 1.0), (t2, he_t2, -1.0)):
        poly, count = _clip_polygon(poly, count, ref_center, sgn * plane_t,
                                    plane_d)

    # distances to the reference plane (positive outside)
    rel = poly - ref_center[:, None, :]
    d = _dot3(rel, ref_n[:, None, :])
    slot = torch.arange(_MAX_V, device=t.device)
    keep = (slot[None, :] < count[:, None]) & (d < prediction)

    # down to 4: the extremes along the face plane's four diagonals
    score_base = torch.where(keep, 0.0, -torch.inf)
    c1 = _dot3(rel, t1[:, None, :])
    c2 = _dot3(rel, t2[:, None, :])
    picks = torch.stack([
        torch.argmax(score, dim=-1) for score in (
            score_base + c1 + c2, score_base + c1 - c2,
            score_base - c1 - c2, score_base - c1 + c2)], dim=1)
    pts = torch.gather(poly, 1, picks[:, :, None].expand(-1, -1, 3))
    dsel = torch.gather(d, 1, picks)
    any_keep = keep.any(dim=-1)
    first_new = [torch.ones_like(any_keep)]
    for i in range(1, 4):
        dup = torch.zeros_like(any_keep)
        for j in range(i):
            dup = dup | (picks[:, i] == picks[:, j])
        first_new.append(~dup)
    valid_pts = torch.stack(first_new, dim=1) & any_keep[:, None]
    dsel = torch.where(valid_pts, dsel, 1e9)
    num = valid_pts.sum(-1)
    # real points first, in pick order
    order = torch.argsort(torch.where(valid_pts, 0, 1), dim=-1, stable=True)
    pts = torch.gather(pts, 1, order[:, :, None].expand(-1, -1, 3))
    dsel = torch.gather(dsel, 1, order)
    # points on A's surface: with A's face as reference, the clipped points
    # sit on B's incident face at depth d; slide them onto A's face
    shift = torch.where((dsel < 1e8) & a_is_ref[:, None], dsel, 0.0)
    pts = pts - ref_n[:, None, :] * shift[:, :, None]
    return pts, dsel, num


def _clip_polygon(poly, count, center, axis, limit):
    """One Sutherland-Hodgman step against the plane
    ``(p − center) · axis ≤ limit`` in the fixed vertex buffer."""
    n, cap, _ = poly.shape
    dev = poly.device
    d = _dot3(poly - center[:, None, :], axis[:, None, :]) - limit[:, None]
    slot = torch.arange(cap, device=dev)
    valid = slot[None, :] < count[:, None]
    nxt = torch.where(slot[None, :] + 1 >= count[:, None], 0,
                      slot[None, :] + 1)
    p_nxt = torch.gather(poly, 1, nxt[:, :, None].expand(-1, -1, 3))
    d_nxt = torch.gather(d, 1, nxt)
    inside_cur = d <= 0.0
    inside_nxt = d_nxt <= 0.0
    den = d - d_nxt
    tt = d / torch.where(torch.abs(den) < 1e-12, 1e-12, den)
    p_int = poly + (p_nxt - poly) * tt[:, :, None]
    emit_cur = valid & inside_cur
    emit_int = valid & (inside_cur != inside_nxt)
    # interleaved cur_0, int_0, cur_1, int_1, ...: keeps the winding
    flags = torch.stack([emit_cur, emit_int], dim=2).reshape(n, 2 * cap)
    pts = torch.stack([poly, p_int], dim=2).reshape(n, 2 * cap, 3)
    pos = torch.cumsum(flags.to(torch.int64), dim=1) - 1
    pos = torch.where(flags & (pos < _MAX_V), pos, _MAX_V)
    out = torch.zeros((n, _MAX_V + 1, 3), dtype=poly.dtype, device=dev)
    out.scatter_(1, pos[:, :, None].expand(-1, -1, 3), pts)
    new_count = torch.clamp(flags.sum(dim=1), max=_MAX_V)
    return out[:, :_MAX_V], new_count


def _edge_edge_point(r, t, he_a, he_b, normal, best_edge):
    """The closest-point contact of the winning edge-edge axis: the point
    on A's edge (A's frame) and the distance along the normal."""
    i = best_edge // 3  # A's edge direction
    j = best_edge % 3  # B's edge direction
    n = t.shape[0]
    eye = torch.eye(3, dtype=t.dtype, device=t.device)
    dir_a = eye[i]
    dir_b = torch.gather(r, 2, j[:, None, None].expand(-1, 3, 1))[:, :, 0]

    def edge_center(he, axes, free_idx, n_dir, base):
        """The supporting edge's midpoint: each non-free axis at the
        corner's sign along ``n_dir``."""
        c = torch.zeros((n, 3), dtype=t.dtype, device=t.device)
        for k in range(3):
            s = torch.sign(_dot3(n_dir, axes[:, :, k]))
            s = torch.where(s == 0, 1.0, s)
            c = c + torch.where((free_idx == k)[:, None], 0.0,
                                (s * he[:, k])[:, None] * axes[:, :, k])
        return base + c

    center_a = edge_center(he_a, eye.expand(n, 3, 3), i, normal,
                           torch.zeros_like(t))
    center_b = edge_center(he_b, r, j, -normal, t)
    # the closest points of the two lines, clamped to the edges
    d1, d2 = dir_a, dir_b
    r12 = center_b - center_a
    a11 = _dot3(d1, d1)
    a22 = _dot3(d2, d2)
    a12 = _dot3(d1, d2)
    b1 = _dot3(d1, r12)
    b2 = _dot3(d2, r12)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    s = (b1 * a22 - b2 * a12) / det
    u = (b1 * a12 - b2 * a11) / det
    he_ai = _take(he_a, i)
    he_bj = _take(he_b, j)
    s = torch.maximum(torch.minimum(s, he_ai), -he_ai)
    u = torch.maximum(torch.minimum(u, he_bj), -he_bj)
    p_a = center_a + d1 * s[:, None]
    p_b = center_b + d2 * u[:, None]
    return p_a, _dot3(p_b - p_a, normal)


def _dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over the last axis of 2."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _col(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Column ``idx[n]`` of each [N, 2, 2] matrix: [N, 2]."""
    return torch.gather(m, 2, idx[:, None, None].expand(-1, 2, 1))[:, :, 0]


def cuboid_cuboid_manifold_2d(pose_a: Sim, pose_b: Sim, he_a: torch.Tensor,
                              he_b: torch.Tensor, prediction: float):
    """Batched 2D box-box manifold (the JAX package's
    ``cuboid_cuboid_manifold_2d``): four face axes, the reference edge
    against the incident edge clipped to its side planes, up to two
    points. Returns ``(normal_a [N, 2], points_a [N, 2, 2], dists [N, 2],
    num_points [N])`` as :func:`cuboid_cuboid_manifold`."""
    r_a = rot2.to_matrix(pose_a.rotation)  # world <- A
    r_b = rot2.to_matrix(pose_b.rotation)
    # B in A's frame: r = R_aᵀ R_b
    r = _dot2(r_a.transpose(1, 2)[:, :, None, :],
              r_b.transpose(1, 2)[:, None, :, :])
    t = rot2.inv_mul_vec(pose_a.rotation,
                         pose_b.translation - pose_a.translation)
    t = t / pose_a.scale[..., None]
    he_b_eff = he_b * (pose_b.scale / pose_a.scale)[..., None]
    abs_r = torch.abs(r) + _EPS

    def mat_vec(m, v):  # einsum("nij,nj->ni")
        return _dot2(m, v[:, None, :])

    def mat_t_vec(m, v):  # einsum("nij,ni->nj")
        return _dot2(m.transpose(1, 2), v[:, None, :])

    sep_a = torch.abs(t) - (he_a + mat_vec(abs_r, he_b_eff))
    t_b = mat_t_vec(r, t)
    sep_b = torch.abs(t_b) - (mat_t_vec(abs_r, he_a) + he_b_eff)
    face_sep = torch.cat([sep_a, sep_b], dim=-1)  # [N, 4]
    best = torch.argmax(face_sep, dim=-1)
    separation = _take(face_sep, best)

    eye = torch.eye(2, dtype=t.dtype, device=t.device)
    n_a = eye[best % 2]
    n_b = _col(r, torch.clamp(best - 2, min=0))
    a_is_ref = best < 2
    normal = torch.where(a_is_ref[:, None], n_a, n_b)
    flip = _dot2(normal, t) < 0.0
    normal = torch.where(flip[:, None], -normal, normal)
    ref_n = torch.where(a_is_ref[:, None], normal, -normal)

    def edge_verts(he, rot_cols, center, n_ref_in_box):
        """The incident edge's two corners: the box's axis most parallel
        to the reference normal, on the side facing it."""
        ax = torch.argmax(torch.abs(n_ref_in_box), dim=-1)
        sgn = -torch.sign(_take(n_ref_in_box, ax))
        other = 1 - ax
        he_ax, he_ot = _take(he, ax), _take(he, other)
        col_ax, col_ot = _col(rot_cols, ax), _col(rot_cols, other)
        mid = center + col_ax * (sgn * he_ax)[:, None]
        return (mid + col_ot * he_ot[:, None],
                mid - col_ot * he_ot[:, None])

    eye_cols = eye.expand(r.shape[0], 2, 2)
    n_ref_in_b = mat_t_vec(r, ref_n)
    vb0, vb1 = edge_verts(he_b_eff, r, t, n_ref_in_b)
    va0, va1 = edge_verts(he_a, eye_cols, torch.zeros_like(t), ref_n)
    p0 = torch.where(a_is_ref[:, None], vb0, va0)
    p1 = torch.where(a_is_ref[:, None], vb1, va1)

    # clip against the reference edge's side planes
    ref_he = torch.where(a_is_ref[:, None], he_a, he_b_eff)
    ref_ax = torch.argmax(torch.abs(torch.where(a_is_ref[:, None], ref_n,
                                                mat_t_vec(r, ref_n))),
                          dim=-1)
    ref_t_idx = 1 - ref_ax
    t_dir_local = _col(torch.where(a_is_ref[:, None, None], eye_cols, r),
                       ref_t_idx)
    ref_center = torch.where(a_is_ref[:, None], torch.zeros_like(t), t)
    he_t = _take(ref_he, ref_t_idx)

    def clip(p0, p1, axis_dir, center, lim):
        d0 = _dot2(p0 - center, axis_dir) - lim
        d1 = _dot2(p1 - center, axis_dir) - lim
        tt = d0 / torch.where(torch.abs(d0 - d1) < 1e-12,
                              torch.full_like(d0, 1e-12), d0 - d1)
        pi = p0 + (p1 - p0) * tt[:, None]
        p0n = torch.where((d0 > 0)[:, None],
                          torch.where((d1 <= 0)[:, None], pi, p0), p0)
        p1n = torch.where((d1 > 0)[:, None],
                          torch.where((d0 <= 0)[:, None], pi, p1), p1)
        return p0n, p1n

    for sgn_t in (1.0, -1.0):
        p0, p1 = clip(p0, p1, sgn_t * t_dir_local, ref_center, he_t)

    ref_face_n = torch.where(a_is_ref[:, None], normal, -normal)
    he_n = _take(ref_he, ref_ax)
    face_pt = ref_center + ref_face_n * he_n[:, None]
    d0 = _dot2(p0 - face_pt, ref_face_n)
    d1 = _dot2(p1 - face_pt, ref_face_n)
    keep0, keep1 = d0 < prediction, d1 < prediction
    # incident points slide onto A's surface when the reference face is A's
    zero = torch.zeros_like(d0)
    p0 = p0 - ref_face_n * torch.where(keep0 & a_is_ref, d0, zero)[:, None]
    p1 = p1 - ref_face_n * torch.where(keep1 & a_is_ref, d1, zero)[:, None]
    pts = torch.stack([p0, p1], dim=1)
    big = torch.full_like(d0, 1e9)
    dists = torch.stack([torch.where(keep0, d0, big),
                         torch.where(keep1, d1, big)], dim=1)
    swap = ~keep0 & keep1  # a kept point first
    pts = torch.where(swap[:, None, None], torch.flip(pts, [1]), pts)
    dists = torch.where(swap[:, None], torch.flip(dists, [1]), dists)
    num = keep0.to(torch.int64) + keep1.to(torch.int64)
    num = torch.where(separation < prediction, num, torch.zeros_like(num))
    return normal, pts, dists, num
