"""EPA: penetration depth and normal of pairs whose convex cores overlap
(counterpart of ``wgmath_tpu/queries/epa.py``: ``epa_penetration``).

A fixed-capacity polytope (``V_CAP`` vertices, ``F_CAP`` faces) seeded by
the octahedron of the CSO's supports along ±x, ±y, ±z, then ``ITERS``
expansions at the face nearest the origin; each expansion's horizon comes
from counting directed edges among the faces the new point sees (an
all-pairs masked compare, branch-free). A slab candidate taken from the
seed's plane rescues flat CSOs (crossed segment cores). In 2D
(``epa2_penetration``) the polytope is a polygon ring in the z = 0 plane.
Plain tensor code on the caller's device, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from wgmath_tpu_torch.geometry.quat import cross
from wgmath_tpu_torch.queries.gjk import (
    _const,
    _Cso,
    _norm3,
    _sqrt,
    _weighted,
)
from wgmath_tpu_torch.queries.sat import _dot3

V_CAP = 30
F_CAP = 56
ITERS = 14
_BIG = 1.0e10
_SEED_DIRS = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
              (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
# the octahedron's faces over the seed vertices, wound outward
_OCT_FACES = ((0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
              (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[m, idx[m]]`` for x [M, R, ...] and idx [M]."""
    return torch.gather(x, 1, idx.view(-1, 1, *([1] * (x.dim() - 2)))
                        .expand(-1, 1, *x.shape[2:]))[:, 0]


def _face_planes(verts, faces, fvalid):
    """Each face's unit normal [M, F, 3] and its plane's offset [M, F]
    (``_BIG`` for an invalid or degenerate face). A face whose offset is
    negative keeps its outward winding: expanding there recovers the part
    of the hull a collapsed seed missed."""
    m = verts.shape[0]
    pts = torch.gather(verts, 1, faces.reshape(m, -1, 1).expand(-1, -1, 3))
    pts = pts.reshape(m, F_CAP, 3, 3)
    v0, v1, v2 = pts[:, :, 0], pts[:, :, 1], pts[:, :, 2]
    n = cross(v1 - v0, v2 - v0)
    nn = _norm3(n, keepdim=True)
    n = n / torch.clamp(nn, min=1e-30)
    d = _dot3(n, v0)
    degen = nn[..., 0] < 1e-12
    return n, torch.where(fvalid & ~degen, d, torch.full_like(d, _BIG))


def _expand(cso, verts, wit_a, nverts, faces, fvalid, done):
    """One expansion of every pair's polytope at its face nearest the
    origin (a pair that has converged or is full changes nothing but its
    unused vertex slot)."""
    m = verts.shape[0]
    dev = verts.device
    normals, dists = _face_planes(verts, faces, fvalid)
    best = torch.argmin(dists, dim=-1)
    best_n = _take_rows(normals, best)
    best_d = _take_rows(dists, best)

    s = cso(best_n)
    newly_done = _dot3(s.w, best_n) - best_d < 1e-4
    grow = ~done & ~newly_done & (nverts < V_CAP)
    done = done | newly_done | (nverts >= V_CAP)

    # the faces the new point sees
    vis = fvalid & (_dot3(normals, s.w[:, None, :]) - dists > 1e-7)
    vis = vis & grow[:, None]

    # horizon: a directed edge of a visible face whose reverse is not an
    # edge of a visible face
    edges_a = faces.reshape(m, -1)
    edges_b = faces[..., _const((1, 2, 0), faces)].reshape(m, -1)
    evalid = vis.repeat_interleave(3, dim=-1)
    key_fwd = edges_a * V_CAP + edges_b
    key_rev = edges_b * V_CAP + edges_a
    has_rev = torch.any((key_fwd[:, None, :] == key_rev[:, :, None])
                        & evalid[:, None, :] & evalid[:, :, None], dim=-1)
    horizon = evalid & ~has_rev

    # the new vertex goes to slot nverts (every pair writes it; only a
    # growing pair counts it)
    vslot = torch.clamp(nverts, max=V_CAP - 1)
    at = vslot[:, None, None].expand(-1, 1, 3)
    verts = verts.scatter(1, at, s.w[:, None, :])
    wit_a = wit_a.scatter(1, at, s.p_a[:, None, :])
    nverts = torch.where(grow, nverts + 1, nverts)

    # free the visible faces' slots, then one new face per horizon edge in
    # the free slots, in order
    fvalid_new = fvalid & ~vis
    hor_rank = torch.cumsum(horizon.to(torch.int64), dim=-1) - 1
    slot_idx = torch.argsort(torch.where(fvalid_new, 1, 0), dim=-1,
                             stable=True)  # free slots first
    n_free = (~fvalid_new).sum(-1)
    target = torch.gather(slot_idx, 1,
                          torch.clamp(hor_rank, 0, F_CAP - 1))
    can_place = horizon & (hor_rank < n_free[:, None]) & grow[:, None]
    tgt = torch.where(can_place, target, torch.full_like(target, F_CAP))
    new_face = torch.stack([edges_a, edges_b,
                            vslot[:, None].expand_as(edges_a)], dim=-1)
    faces = torch.cat([faces, torch.zeros((m, 1, 3), dtype=faces.dtype,
                                          device=dev)], dim=1)
    faces = faces.scatter(1, tgt[..., None].expand(-1, -1, 3), new_face)
    fvalid = torch.cat([fvalid_new, torch.zeros((m, 1), dtype=torch.bool,
                                                device=dev)], dim=1)
    fvalid = fvalid.scatter(1, tgt, torch.ones_like(tgt, dtype=torch.bool))
    return (verts, wit_a, nverts, faces[:, :F_CAP], fvalid[:, :F_CAP],
            done)


def _slab(cso, seed):
    """The flat-CSO candidate: the seed's best-fit plane normal (any
    perpendicular of its longest edge when the seed is a line) and the
    CSO's two supports along it. h(±n) is a certified upper bound on the
    depth (moving B by h·n separates the pair). Returns (normal, depth,
    point on A, the seed's scale)."""
    seed_e = seed[:, 1:6] - seed[:, :1]  # [M, 5, 3]
    pi, pj = torch.triu_indices(5, 5, 1, device=seed.device)
    crs = cross(seed_e[:, pi], seed_e[:, pj])  # [M, 10, 3]
    crn = _norm3(crs)
    n_pl = _take_rows(crs, torch.argmax(crn, dim=-1))
    e_len = _norm3(seed_e)
    scale = torch.amax(e_len, dim=-1)
    e_long = _take_rows(seed_e, torch.argmax(e_len, dim=-1))
    x_axis = _const((1.0, 0.0, 0.0), seed)
    y_axis = _const((0.0, 1.0, 0.0), seed)
    alt = torch.where(torch.abs(e_long[:, :1])
                      < 0.9 * torch.clamp(scale, min=1e-30)[:, None],
                      x_axis, y_axis)
    perp = cross(e_long, alt)
    line_degen = torch.amax(crn, dim=-1) <= 1e-6 * scale * scale
    n_pl = torch.where(line_degen[:, None], perp, n_pl)
    n_pl = n_pl / torch.clamp(_norm3(n_pl, keepdim=True), min=1e-30)
    s = cso(torch.stack([n_pl, -n_pl], dim=1))
    h_p = _dot3(s.w[:, 0], n_pl)
    h_n = -_dot3(s.w[:, 1], n_pl)
    slab_pos = h_p <= h_n
    depth = torch.clamp(torch.where(slab_pos, h_p, h_n), min=0.0)
    normal = torch.where(slab_pos[:, None], n_pl, -n_pl)
    point = torch.where(slab_pos[:, None], s.p_a[:, 0], s.p_a[:, 1])
    return normal, depth, point, scale


def epa_penetration(tag_a, par_a, tag_b, par_b, r_ab, t_ab, vertices=None):
    """Penetration normal, depth and deepest point for pairs [M] whose
    cores overlap, in A's frame: ``(normal [M, 3], depth [M], point_a
    [M, 3])``, the normal pointing from A to B (the direction to push B),
    ``depth >= 0``, ``point_a`` the contact's deepest point on A."""
    m = t_ab.shape[0]
    dev, dt = t_ab.device, t_ab.dtype
    cso = _Cso(tag_a, par_a, tag_b, par_b, r_ab, t_ab, vertices)

    dirs = _const(_SEED_DIRS, t_ab)
    s = cso(dirs[None].expand(m, -1, -1))
    verts = torch.zeros((m, V_CAP, 3), dtype=dt, device=dev)
    wit_a = torch.zeros((m, V_CAP, 3), dtype=dt, device=dev)
    verts[:, :6] = s.w
    wit_a[:, :6] = s.p_a
    nverts = torch.full((m,), 6, dtype=torch.int64, device=dev)
    faces = torch.zeros((m, F_CAP, 3), dtype=torch.int64, device=dev)
    faces[:, :8] = _const(_OCT_FACES, faces)
    fvalid = torch.zeros((m, F_CAP), dtype=torch.bool, device=dev)
    fvalid[:, :8] = True

    slab_n, slab_depth, slab_pt, scale = _slab(cso, verts)

    done = torch.zeros((m,), dtype=torch.bool, device=dev)
    for _ in range(ITERS):
        verts, wit_a, nverts, faces, fvalid, done = _expand(
            cso, verts, wit_a, nverts, faces, fvalid, done)

    normals, dists = _face_planes(verts, faces, fvalid)
    best = torch.argmin(dists, dim=-1)
    n = _take_rows(normals, best)
    raw = _take_rows(dists, best)
    failed = raw >= _BIG * 0.5
    depth = torch.where(failed, torch.zeros_like(raw), raw)

    # the witness: barycentric coordinates of the origin's projection on
    # the best face
    fidx = _take_rows(faces, best)  # [M, 3]
    wv = torch.gather(verts, 1, fidx[..., None].expand(-1, -1, 3))
    wa = torch.gather(wit_a, 1, fidx[..., None].expand(-1, -1, 3))
    proj = n * depth[:, None]
    v0 = wv[:, 1] - wv[:, 0]
    v1 = wv[:, 2] - wv[:, 0]
    v2 = proj - wv[:, 0]
    d00 = _dot3(v0, v0)
    d01 = _dot3(v0, v1)
    d11 = _dot3(v1, v1)
    d20 = _dot3(v2, v0)
    d21 = _dot3(v2, v1)
    den = torch.clamp(d00 * d11 - d01 * d01, min=1e-30)
    v = (d11 * d20 - d01 * d21) / den
    w = (d00 * d21 - d01 * d20) / den
    u = 1.0 - v - w
    point_a = _weighted(torch.stack([u, v, w], -1), wa)

    # the slab's certified bound beats a failed or degenerate polytope (a
    # converged EPA depth is never above it); on a tie it wins too, its
    # fitted normal being better than a tiny face's, and a clearly
    # negative depth is degenerate as well
    use_slab = (failed | (depth < -1e-6 * scale)
                | (slab_depth <= depth * 1.0001 + 1e-6 * scale))
    n = torch.where(use_slab[:, None], slab_n, n)
    depth = torch.where(use_slab, slab_depth, depth)
    point_a = torch.where(use_slab[:, None], slab_pt, point_a)
    return n, depth, point_a


# ---------------------------------------------------------------------------
# 2D EPA: a polygon expanded in the embedded z = 0 plane (the 2D
# support-mapped narrow phase)
# ---------------------------------------------------------------------------

V2_CAP = 24
ITERS2 = 16
_SEED2_ANGLES = 2.0 * np.pi * np.arange(8) / 8.0
_SEED2_DIRS = tuple(map(tuple, np.stack(
    [np.cos(_SEED2_ANGLES), np.sin(_SEED2_ANGLES),
     np.zeros_like(_SEED2_ANGLES)], -1).astype(np.float32).tolist()))


def _edge_planes(verts, nv):
    """Each ring edge's outward normal [M, V2_CAP, 3] (z = 0), its offset
    from the origin (``_BIG`` for a slot past the ring or a degenerate
    edge) and its end's slot. A negative offset keeps its outward normal:
    expanding there recovers the hull corner a collapsed seed missed."""
    idx = torch.arange(V2_CAP, device=verts.device)
    nxt = torch.where(idx[None, :] + 1 >= nv[:, None],
                      idx[None, :] + 1 - nv[:, None], idx[None, :] + 1)
    vj = torch.gather(verts, 1, nxt[..., None].expand(-1, -1, 3))
    e = vj - verts
    elen = _sqrt(e[..., 0] ** 2 + e[..., 1] ** 2)
    inv = 1.0 / torch.clamp(elen, min=1e-30)
    nx = e[..., 1] * inv
    ny = -e[..., 0] * inv
    d = nx * verts[..., 0] + ny * verts[..., 1]
    ok = (idx[None, :] < nv[:, None]) & (elen > 1e-9)
    d = torch.where(ok, d, torch.full_like(d, _BIG))
    return torch.stack([nx, ny, torch.zeros_like(nx)], -1), d, nxt


def epa2_penetration(tag_a, par_a, tag_b, par_b, r_ab, t_ab, vertices=None):
    """Penetration normal, depth and point for overlapping 2D pairs
    embedded in 3D (z = 0), as :func:`epa_penetration` returns them (the
    JAX package's ``epa2_penetration``): a counter-clockwise ring of at
    most ``V2_CAP`` CSO vertices seeded by eight supports around the
    circle, expanded ``ITERS2`` times at the edge nearest the origin (the
    new vertex inserted after it), the witness lerped along the best
    edge."""
    m = t_ab.shape[0]
    dev, dt = t_ab.device, t_ab.dtype
    cso = _Cso(tag_a, par_a, tag_b, par_b, r_ab, t_ab, vertices)
    dirs = _const(_SEED2_DIRS, t_ab)
    s = cso(dirs[None].expand(m, -1, -1))
    verts = torch.zeros((m, V2_CAP, 3), dtype=dt, device=dev)
    wit_a = torch.zeros((m, V2_CAP, 3), dtype=dt, device=dev)
    verts[:, :8] = s.w
    wit_a[:, :8] = s.p_a
    nv = torch.full((m,), 8, dtype=torch.int64, device=dev)
    done = torch.zeros((m,), dtype=torch.bool, device=dev)
    idx = torch.arange(V2_CAP, device=dev)
    prev_idx = torch.clamp(idx - 1, min=0)
    for _ in range(ITERS2):
        nrm, d, _ = _edge_planes(verts, nv)
        best = torch.argmin(d, dim=-1)
        bn = _take_rows(nrm, best)
        bd = _take_rows(d, best)
        s = cso(bn)
        gap = _dot3(s.w, bn) - bd
        grow = ~done & (gap >= 1e-4) & (nv < V2_CAP)
        done = done | (gap < 1e-4) | (nv >= V2_CAP)
        # insert the new vertex after ``best``: the support along the
        # edge's normal lies angularly inside the edge, so the ring's
        # order holds
        keep = (idx[None, :] <= best[:, None])[..., None]
        is_new = (idx[None, :] == best[:, None] + 1)[..., None]

        def shift(arr, new):
            out = torch.where(keep, arr, torch.where(
                is_new, new[:, None, :], arr[:, prev_idx]))
            return torch.where(grow[:, None, None], out, arr)

        verts = shift(verts, s.w)
        wit_a = shift(wit_a, s.p_a)
        nv = torch.where(grow, nv + 1, nv)

    nrm, d, nxt = _edge_planes(verts, nv)
    best = torch.argmin(d, dim=-1)
    n = _take_rows(nrm, best)
    depth = _take_rows(d, best)
    depth = torch.where(depth >= _BIG * 0.5, torch.zeros_like(depth), depth)
    # the witness: the origin's projection on the best edge, lerped in A
    bj = _take_rows(nxt, best)
    vi, vj = _take_rows(verts, best), _take_rows(verts, bj)
    ai, aj = _take_rows(wit_a, best), _take_rows(wit_a, bj)
    e = vj - vi
    t = (_dot3(n * depth[:, None] - vi, e)
         / torch.clamp(_dot3(e, e), min=1e-30))
    t = torch.clamp(t, 0.0, 1.0)
    return n, depth, ai * (1.0 - t)[:, None] + aj * t[:, None]
