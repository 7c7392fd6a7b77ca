"""Contact manifolds of up to 4 points for support-mapped (PFM) pairs
(counterpart of ``wgmath_tpu/queries/pfm_manifold.py``).

After GJK / EPA give the contact normal, both shapes' support features
along ±n (a point, a segment or a 4-point face) are clipped against each
other in the contact plane, and the candidates are reduced to at most 4
points. Every pair evaluates every fixed-size group of candidates under
masks, as in the JAX package: 4 vertices of feature 1 inside feature 2,
4 of feature 2 inside feature 1, 16 projected edge crossings and a 2-point
clip of parallel segments; the reference's early exits are gates. Plain
tensor code on the caller's device; the groups of 4 and of 16 run as
batches (each candidate's arithmetic is the JAX package's, in its order).
"""

from __future__ import annotations

import torch

from wgmath_tpu_torch.geometry.quat import cross
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries.gjk import (
    _const,
    _norm3,
    _sqrt,
    relative_pose,
    support_core,
)
from wgmath_tpu_torch.queries.sat import (
    _box_face_vertices,
    _dot3,
    _mat_t_vec,
)
from wgmath_tpu_torch.shapes import shape as shp

_EPS = 1.1920929e-7
_COS_PI_8 = 0.92387953251


def _dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def _orthonormal_basis(v):
    """Two unit vectors orthogonal to the unit v [N, 3] (the branchless
    construction of Duff et al.)."""
    sign = torch.where(v[:, 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v[:, 2])
    b = v[:, 0] * v[:, 1] * a
    t1 = torch.stack([1.0 + sign * v[:, 0] * v[:, 0] * a, sign * b,
                      -sign * v[:, 0]], -1)
    t2 = torch.stack([b, sign + v[:, 1] * v[:, 1] * a, -v[:, 1]], -1)
    return t1, t2


def _rim_square(dx, dz, r, y):
    """A 4-point square standing for a disc of radius r at height y, one
    corner along (dx, dz)."""
    y = y.expand_as(dx)
    return torch.stack([torch.stack([dx * r, y, dz * r], -1),
                        torch.stack([-dz * r, y, dx * r], -1),
                        torch.stack([-dx * r, y, -dz * r], -1),
                        torch.stack([dz * r, y, -dx * r], -1)], 1)


def support_face(tag, par, d, vertices=None, indices=None):
    """The support feature of each shape's CORE along the unit d (local
    frame): up to 4 vertices and their count, ``(verts [N, 4, 3], nv
    [N])``. The dilation radius is left to the caller; unused slots repeat
    a valid vertex so the edge arithmetic stays finite."""
    n = d.shape[0]
    dev = d.device
    sup, _ = support_core(tag, par, d, vertices)
    verts = sup[:, None, :].expand(n, 4, 3)
    nv = torch.ones((n,), dtype=torch.int64, device=dev)

    def blend(mask, v_new, nv_new):
        return (torch.where(mask[:, None, None], v_new, verts),
                torch.where(mask, nv_new, nv))

    zero = torch.zeros_like(d[:, 0])
    hh = par[:, 0]

    # capsule core: the whole segment
    cap = torch.stack([torch.stack([zero, zero - hh, zero], -1),
                       torch.stack([zero, zero + hh, zero], -1)], 1)
    verts, nv = blend(tag == shp.CAPSULE, torch.cat([cap, cap], 1), 2)

    # standalone segment: params [a | b]
    segf = torch.stack([par[:, :3], par[:, 3:6]], 1)
    verts, nv = blend(tag == shp.SEGMENT, torch.cat([segf, segf], 1), 2)

    # cuboid: the face whose outward axis is nearest d
    axis = torch.argmax(torch.abs(d), dim=-1)
    sgn = torch.where(torch.gather(d, 1, axis[:, None])[:, 0] >= 0.0,
                      1.0, -1.0)
    verts, nv = blend(tag == shp.CUBOID,
                      _box_face_vertices(par[:, :3], axis, sgn), 4)

    # cylinder and cone: d's direction in the xz plane
    lxz = _sqrt(d[:, 0] * d[:, 0] + d[:, 2] * d[:, 2])[:, None]
    dxz = torch.where(lxz > _EPS, torch.stack([d[:, 0], d[:, 2]], -1)
                      / torch.clamp(lxz, min=1e-30),
                      _const((1.0, 0.0), d))
    dx, dz = dxz[:, 0], dxz[:, 1]
    r = par[:, 1]

    side = torch.stack([torch.stack([dx * r, -hh, dz * r], -1),
                        torch.stack([dx * r, hh, dz * r], -1)], 1)
    cap_sq = _rim_square(dx, dz, r, torch.where(d[:, 1] >= 0.0, hh, -hh))
    cyl_side = torch.abs(d[:, 1]) < 0.5
    verts, nv = blend(tag == shp.CYLINDER,
                      torch.where(cyl_side[:, None, None],
                                  torch.cat([side, side], 1), cap_sq),
                      torch.where(cyl_side, 2, 4))

    apex = torch.stack([zero, zero + hh, zero], -1)
    slant = torch.stack([torch.stack([dx * r, -hh, dz * r], -1), apex], 1)
    cone_up = d[:, 1] > 0.0
    verts, nv = blend(tag == shp.CONE,
                      torch.where(cone_up[:, None, None],
                                  torch.cat([slant, slant], 1),
                                  _rim_square(dx, dz, r, -hh)),
                      torch.where(cone_up, 2, 4))

    if vertices is not None and vertices.shape[0] > 0:
        # standalone triangle: params [first_vtx, 3]
        first = par[:, 0].to(torch.int64)
        vmax = vertices.shape[0] - 1
        tri = torch.stack([vertices[torch.clamp(first + k, max=vmax)]
                           for k in (0, 1, 2, 2)], 1)
        verts, nv = blend(tag == shp.TRIANGLE, tri, 3)
        if indices is not None and indices.shape[0] > 0:
            # convex polyhedron: the stored hull face whose unit normal is
            # nearest d, faces at params [first_idx, num_idx)
            fv = vertices[indices]  # [F, 3, 3]
            fn = cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
            fl = _norm3(fn, keepdim=True)
            fn = torch.where(fl > 0.0, fn / torch.clamp(fl, min=1e-30),
                             torch.zeros_like(fn))
            first_f = par[:, 2].to(torch.int64)
            num_f = par[:, 3].to(torch.int64)
            f_idx = torch.arange(indices.shape[0], device=dev)
            dots = _dot3(d[:, None, :], fn[None])
            in_rng = ((f_idx[None, :] >= first_f[:, None])
                      & (f_idx[None, :] < (first_f + num_f)[:, None]))
            bf = fv[torch.argmax(torch.where(in_rng, dots, -torch.inf), dim=-1)]
            verts, nv = blend(tag == shp.CONVEX,
                              torch.cat([bf, bf[:, 2:3]], 1), 3)
    return verts, nv


def _points_in_poly(p, poly, nvp):
    """Whether each 2D point p [N, K, 2] lies in the convex polygon poly
    [N, 4, 2] of ``nvp`` vertices (either winding; zero-length edges
    ignored): no two live edges see it on opposite sides."""
    pos = torch.zeros(p.shape[:2], dtype=torch.bool, device=p.device)
    neg = torch.zeros_like(pos)
    for k in range(4):
        jn = torch.where(k + 1 >= nvp, 0, k + 1)
        a = poly[:, k][:, None, :]
        b = torch.gather(poly, 1, jn[:, None, None].expand(-1, 1, 2))
        perp = ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
                - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))
        live = (k < nvp)[:, None]
        pos = pos | (live & (perp > 0.0))
        neg = neg | (live & (perp < 0.0))
    return ~(pos & neg)


def _point_in_poly(p, poly, nvp):
    """:func:`_points_in_poly` of one point p [N, 2] a row."""
    return _points_in_poly(p[:, None, :], poly, nvp)[:, 0]


def _closest_line2d(a1, b1, a2, b2):
    """Barycentric (s, t) of the crossing of two 2D lines; (inf, inf) when
    they are parallel."""
    d1 = b1 - a1
    d2 = b2 - a2
    r = a1 - a2
    a = _dot2(d1, d1)
    e = _dot2(d2, d2)
    f = _dot2(d2, r)
    c = _dot2(d1, r)
    b = _dot2(d1, d2)
    denom = a * e - b * b
    ok = (a > _EPS) & (e > _EPS) & (denom > _EPS)
    s = torch.where(ok, (b * f - c * e) / torch.where(ok, denom, 1.0),
                    torch.inf)
    t = torch.where(ok, (b * s + f) / torch.where(e > _EPS, e, 1.0),
                    torch.inf)
    return s, t


def _reduce4(pts, dist, valid, normal):
    """Masked candidates [N, C] down to at most 4 manifold points: the
    deepest, the farthest from it, then the two extremes along the
    tangent. Unused slots get dist 1e9."""
    c = dist.shape[1]
    idx = torch.arange(c, device=dist.device)[None, :]
    count = valid.sum(-1)
    inf = 1e10

    def take(x, i):
        return torch.gather(x, 1, i[:, None, None].expand(-1, 1, 3))[:, 0]

    i0 = torch.argmin(torch.where(valid, dist, inf), dim=-1)
    p0 = take(pts, i0)
    rel = pts - p0[:, None, :]
    sq = _dot3(rel, rel)
    m1 = valid & (idx != i0[:, None])
    i1 = torch.argmax(torch.where(m1, sq, -inf), dim=-1)
    tangent = cross(take(pts, i1) - p0, normal)
    td = _dot3(rel, tangent[:, None, :])
    m2 = m1 & (idx != i1[:, None])
    i2 = torch.argmin(torch.where(m2, td, inf), dim=-1)
    i3 = torch.argmax(torch.where(m2, td, -inf), dim=-1)

    sel = torch.stack([i0, i1, i2, i3], -1)
    ok = torch.stack([count >= 1, count >= 2, count >= 3,
                      (count >= 4) & (i2 != i3)], -1)
    out_p = torch.gather(pts, 1, sel[..., None].expand(-1, -1, 3))
    out_d = torch.where(ok, torch.gather(dist, 1, sel), 1e9)
    out_p = torch.where(ok[..., None], out_p, 0.0)
    return out_p, out_d, ok.sum(-1)


def _edges(poly, nvp):
    """Each of the 4 edges' two ends [N, 4, D] (k to its successor, the
    last live vertex back to 0)."""
    k = torch.arange(4, device=poly.device)[None, :]
    jn = torch.where(k + 1 >= nvp[:, None], 0, k + 1)
    return poly, torch.gather(poly, 1, jn[..., None].expand(
        -1, -1, poly.shape[-1]))


def feature_contacts(f1, nv1, f2, nv2, n_a, prediction):
    """Candidate contact points between two polygonal features, both in A's
    frame, separated along the unit axis ``n_a`` (A→B): ``(pts [N, 26, 3]
    on A, dist [N, 26], valid [N, 26])``."""
    t1, t2 = _orthonormal_basis(n_a)

    def proj(v):
        return torch.stack([_dot3(v, t1[:, None, :]),
                            _dot3(v, t2[:, None, :])], -1)

    p1, p2 = proj(f1), proj(f2)  # [N, 4, 2]
    k4 = torch.arange(4, device=f1.device)[None, :]
    if torch.is_tensor(prediction) and prediction.dim() == 1:
        pred = prediction[:, None]
    else:
        pred = prediction

    # group A: f1's vertices inside f2's projected face
    n2 = cross(f2[:, 2] - f2[:, 1], f2[:, 0] - f2[:, 1])
    den2 = _dot3(n2, n_a)
    g_a = (nv2 > 2) & (torch.abs(den2) > _EPS)
    inside = _points_in_poly(p1, p2, nv2)
    live = g_a[:, None] & (k4 < nv1[:, None])
    out_a = torch.any(live & ~inside, dim=1)
    d_a = (_dot3(f2[:, 0:1] - f1, n2[:, None, :])
           / torch.where(den2 != 0.0, den2, 1.0)[:, None])
    valid_a = live & inside & (d_a <= pred)
    # the reference's early exit: every f1 vertex inside f2 ends the clip
    gate_b = ~(g_a & ~out_a)

    # group B: f2's vertices inside f1's projected face
    n1 = cross(f1[:, 2] - f1[:, 1], f1[:, 0] - f1[:, 1])
    den1 = -_dot3(n1, n_a)
    g_b = gate_b & (nv1 > 2) & (torch.abs(den1) > _EPS)
    inside = _points_in_poly(p2, p1, nv1)
    live = g_b[:, None] & (k4 < nv2[:, None])
    out_b = torch.any(live & ~inside, dim=1)
    d_b = (_dot3(f1[:, 0:1] - f2, n1[:, None, :])
           / torch.where(den1 != 0.0, den1, 1.0)[:, None])
    valid_b = live & inside & (d_b <= pred)
    pts_b = f2 - d_b[..., None] * n_a[:, None, :]
    gate_c = gate_b & ~(g_b & ~out_b)

    # group C: projected edge crossings, f1's edge i against f2's edge j
    # (a 2-vertex feature has one real edge, a 1-vertex feature none)
    ne1 = torch.where(nv1 > 2, nv1, nv1 - 1)
    ne2 = torch.where(nv2 > 2, nv2, nv2 - 1)
    e1a2, e1b2 = _edges(p1, nv1)
    e1a3, e1b3 = _edges(f1, nv1)
    e2a2, e2b2 = _edges(p2, nv2)
    e2a3, e2b3 = _edges(f2, nv2)
    s, t = _closest_line2d(e1a2[:, :, None], e1b2[:, :, None],
                           e2a2[:, None], e2b2[:, None])  # [N, 4, 4]
    crossing = (s > 0.0) & (s < 1.0) & (t > 0.0) & (t < 1.0)
    p1c = e1a3[:, :, None] + (e1b3 - e1a3)[:, :, None] * torch.where(
        crossing, s, 0.0)[..., None]
    p2c = e2a3[:, None] + (e2b3 - e2a3)[:, None] * torch.where(
        crossing, t, 0.0)[..., None]
    d_c = _dot3(p2c - p1c, n_a[:, None, None, :])
    pred_c = pred[..., None] if torch.is_tensor(pred) else pred
    valid_c = (gate_c[:, None, None] & (k4[:, :, None] < ne1[:, None, None])
               & (k4[:, None, :] < ne2[:, None, None]) & crossing
               & (d_c <= pred_c))
    n = f1.shape[0]

    # group D: the range clip of two parallel segments (the only source of
    # two points for segment features)
    is_ee = (nv1 == 2) & (nv2 == 2)
    u3 = f1[:, 1] - f1[:, 0]
    l1 = _norm3(u3)
    u = u3 / torch.clamp(l1, min=1e-30)[:, None]
    t1p = p1[:, 1] - p1[:, 0]
    t2p = p2[:, 1] - p2[:, 0]
    l1p = _sqrt(_dot2(t1p, t1p))
    l2p = _sqrt(_dot2(t2p, t2p))
    cosang = torch.abs(_dot2(t1p, t2p) / torch.clamp(l1p * l2p, min=1e-30))
    parallel = (l1p <= _EPS) | (l2p <= _EPS) | (cosang >= _COS_PI_8)
    ta = _dot3(f2[:, 0] - f1[:, 0], u)
    tb = _dot3(f2[:, 1] - f1[:, 0], u)
    lo = torch.clamp(torch.minimum(ta, tb), min=0.0)
    hi = torch.minimum(l1, torch.maximum(ta, tb))
    nonempty = lo <= hi
    denom_t = torch.where(torch.abs(tb - ta) > 1e-12, tb - ta, 1.0)
    bound = torch.stack([lo, hi], 1)  # [N, 2]
    p1d = f1[:, 0:1] + u[:, None, :] * bound[..., None]
    s2 = (bound - ta[:, None]) / denom_t[:, None]
    p2d = f2[:, 0:1] + (f2[:, 1] - f2[:, 0])[:, None, :] * s2[..., None]
    d_d = _dot3(p2d - p1d, n_a[:, None, :])
    valid_d = (is_ee & parallel & nonempty)[:, None] & (d_d <= pred)

    pts = torch.cat([f1, pts_b, p1c.reshape(n, 16, 3), p1d], 1)
    dist = torch.cat([d_a, d_b, d_c.reshape(n, 16), d_d], 1)
    valid = torch.cat([valid_a, valid_b, valid_c.reshape(n, 16), valid_d],
                      1)
    return pts, dist, valid


def pfm_manifold(tag_a, par_a, pose_a: Sim, tag_b, par_b, pose_b: Sim,
                 n_gjk, pt_gjk, dist_gjk, prediction, vertices=None,
                 indices=None):
    """A manifold of up to 4 points built on a ``pfm_contact`` result (the
    normal ``n_gjk``, witness ``pt_gjk`` and ``dist_gjk``, A's frame, the
    dilation radii applied): ``(points [N, 4, 3] on A's surface in A's
    frame, dist [N, 4], num_points [N])``. The GJK / EPA witness is
    appended when the clip gives fewer than 4 points, so every pair has at
    least one."""
    n = n_gjk.shape[0]
    r_ab, t_ab = relative_pose(pose_a, pose_b)
    d0 = torch.zeros_like(n_gjk)
    d0[:, 1] = 1.0
    _, rad = support_core(torch.cat([tag_a, tag_b]),
                          torch.cat([par_a, par_b]), torch.cat([d0, d0]))
    rad_a, rad_b = rad[:n], rad[n:]

    f1, nv1 = support_face(tag_a, par_a, n_gjk, vertices, indices)
    n_b = _mat_t_vec(r_ab, -n_gjk)
    f2_loc, nv2 = support_face(tag_b, par_b, n_b, vertices, indices)
    f2 = t_ab[:, None, :] + _dot3(r_ab[:, None], f2_loc[:, :, None, :])

    # the cores clip against a prediction widened by both radii
    total_pred = prediction + rad_a + rad_b
    c_pts, c_dist, c_valid = feature_contacts(f1, nv1, f2, nv2, n_gjk,
                                              total_pred)
    pts4, d4, len4 = _reduce4(c_pts, c_dist, c_valid, n_gjk)
    # out to A's real surface, the radii off the distances
    pts4 = pts4 + (n_gjk * rad_a[:, None])[:, None, :]
    d4 = torch.where(d4 < 1e8, d4 - (rad_a + rad_b)[:, None], d4)

    app = len4 < 4
    slot = torch.clamp(len4, max=3)
    one_hot = ((torch.arange(4, device=n_gjk.device)[None, :]
                == slot[:, None]) & app[:, None])
    pts4 = torch.where(one_hot[..., None], pt_gjk[:, None, :], pts4)
    d4 = torch.where(one_hot, dist_gjk[:, None], d4)
    return pts4, d4, len4 + app.to(len4.dtype)
