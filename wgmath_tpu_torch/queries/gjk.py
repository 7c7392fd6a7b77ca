"""GJK distance between convex cores, and the one-point contact of
support-mapped pairs (counterpart of ``wgmath_tpu/queries/gjk.py``).

Shapes are support-mapped: a ball or capsule is a core (a point or a
segment) dilated by a radius, so shallow contacts of rounded shapes come
from the core distance; pairs whose cores overlap get their depth from EPA
(``queries/epa.py``). Every pair of the batch runs the same masked
arithmetic, as in the JAX package, which runs this as plain ``jnp``: the
Voronoi simplex is evaluated for all its sub-features and selected by
mask. Plain tensor code on the caller's device, no kernel.

Every 3-term sum is written out left to right (``sat._dot3``), the order of
the JAX package's contractions on the CPU, every ``argmax`` / ``argmin``
takes the first index, as ``jnp``'s do, and every ``>=`` of the JAX code
stays ``>=``: the cone's and cylinder's supports tie at d = 0 on aligned
poses.

The mesh narrow phase passes a triangle per pair (``tri_verts_a``,
dilated by ``tri_margin``) and takes the deep-core fallback without EPA
(``use_epa=False``: a push along the centre axis). Not ported here: the 2D
EPA (``use_epa="2d"``; ROADMAP item 4), which raises
``NotImplementedError``. ``support_core`` itself takes every tag; its
``window`` gathers each row's vertex range instead of dotting the
direction with the whole shared vertex buffer (the same arg-max).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from wgmath_tpu_torch.geometry import quat
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries.sat import _dot3
from wgmath_tpu_torch.shapes import shape as shp

MAX_ITERS = 32
EPS = 1e-6


_CONSTS: dict = {}


def _const(values: tuple, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A small constant tensor on ``like``'s device, made once: the PFM
    path is captured into a CUDA graph (``narrow_phase._pfm_call``), and a
    capture may not copy from the host."""
    dtype = dtype or like.dtype
    key = (values, like.device, dtype)
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.tensor(values, dtype=dtype,
                                        device=like.device)
    return t


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as XLA's and the card's are.
    PyTorch's vectorized CPU ``sqrt`` is off by an ulp for ~0.5 % of f32
    inputs, and GJK's iterations carry such an ulp into another simplex;
    a square root in f64 rounded to f32 is exact (53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)


def _norm3(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """|v| over the last axis of 3, the squares summed left to right."""
    n = _sqrt(_dot3(v, v))
    return n[..., None] if keepdim else n


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a·b + c in one rounding (through float64: the product is exact
    there), as the JAX package's CPU code computes a product feeding a sum
    in one fused kernel (XLA lets LLVM contract them, ROADMAP C4)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def dot_fma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over the last axis as XLA's CPU reduction computes it: the
    first product, then each next one contracted into the sum."""
    acc = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        acc = fma(a[..., i], b[..., i], acc)
    return acc


def norm_fma(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis: :func:`dot_fma`'s square and a correctly
    rounded root, the bits of ``jnp.linalg.norm`` on the CPU."""
    return _sqrt(dot_fma(v, v))


def _unit(axis: int, like: torch.Tensor) -> torch.Tensor:
    """The unit vector e_axis, broadcast to ``like``'s shape."""
    e = torch.zeros_like(like)
    e[..., axis] = 1.0
    return e


def _with_y(v: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``v.at[:, 1].set(y)``."""
    return torch.stack([v[..., 0], y, v[..., 2]], dim=-1)


def support_core(tag, params, d, vertices=None, tri_verts=None,
                 tri_margin=0.0, window: int | None = None):
    """The farthest point of each shape's core along d [N, 3] (local frame)
    and the dilation radius: core ⊕ ball(radius) is the shape.

    ``vertices``: the shared vertex buffer, for CONVEX shapes (params
    [first_vtx, num_vtx, ...], a masked arg-max over the range) and for
    standalone TRIANGLE colliders when no ``tri_verts`` are given.
    ``tri_verts`` [N, 3, 3]: an explicit vertex triple per row for
    TRIANGLE, with radius ``tri_margin``. ``window`` (the shape set's
    ``shape.vertex_window``): the arg-max runs over that many vertices
    from each row's first one, the same first largest dot as over the
    whole buffer; 0 skips it (no vertex-range shape in the set)."""
    p = params
    zero = torch.zeros_like(d[:, 0])
    sup = torch.zeros_like(d)
    radius = torch.where(tag == shp.BALL, p[:, 0], zero)

    # cuboid: sign(d) * he
    he = p[:, :3]
    sup = torch.where((tag == shp.CUBOID)[:, None],
                      torch.where(d >= 0.0, he, -he), sup)

    # capsule: the segment's end (0, ±hh, 0)
    y_end = torch.where(d[:, 1] >= 0, p[:, 0], -p[:, 0])
    seg = torch.stack([zero, y_end, zero], dim=-1)
    sup = torch.where((tag == shp.CAPSULE)[:, None], seg, sup)
    radius = torch.where(tag == shp.CAPSULE, p[:, 1], radius)

    # cylinder: a rim point
    dxz = torch.stack([d[:, 0], zero, d[:, 2]], dim=-1)
    nxz = _norm3(dxz, keepdim=True)
    rim = torch.where(nxz > 1e-9, dxz / torch.clamp(nxz, min=1e-30),
                      torch.zeros_like(dxz)) * p[:, 1:2]
    sup = torch.where((tag == shp.CYLINDER)[:, None], _with_y(rim, y_end),
                      sup)

    # cone: the apex (0, hh, 0) or a point of the base rim
    apex = torch.stack([zero, p[:, 0], zero], dim=-1)
    base = _with_y(rim, -p[:, 0])
    pick_apex = _dot3(apex, d) >= _dot3(base, d)
    cone = torch.where(pick_apex[:, None], apex, base)
    sup = torch.where((tag == shp.CONE)[:, None], cone, sup)

    # segment: the better end of params' [a | b]
    seg_a, seg_b = p[:, :3], p[:, 3:6]
    pick_a = _dot3(seg_a, d) >= _dot3(seg_b, d)
    sup = torch.where((tag == shp.SEGMENT)[:, None],
                      torch.where(pick_a[:, None], seg_a, seg_b), sup)

    # triangle: arg-max over an explicit vertex triple per row
    if tri_verts is not None:
        best = torch.argmax(dot_fma(d[:, None, :], tri_verts), dim=-1)
        tri = torch.gather(tri_verts, 1,
                           best[:, None, None].expand(-1, 1, 3))[:, 0]
        sup = torch.where((tag == shp.TRIANGLE)[:, None], tri, sup)
        radius = torch.where(tag == shp.TRIANGLE,
                             torch.full_like(radius, tri_margin), radius)

    # convex polyhedron (and a standalone triangle without a triple): the
    # arg-max vertex over [first_vtx, first_vtx + num_vtx)
    if vertices is not None and vertices.shape[0] > 0:
        vtx_range = tag == shp.CONVEX
        if tri_verts is None:
            vtx_range = vtx_range | (tag == shp.TRIANGLE)
            radius = torch.where(tag == shp.TRIANGLE,
                                 torch.full_like(radius, tri_margin), radius)
        first = p[:, 0].to(torch.int64)
        num = p[:, 1].to(torch.int64)
        if window is None:
            v_idx = torch.arange(vertices.shape[0], device=d.device)
            dots = _dot3(d[:, None, :], vertices[None, :, :])
            in_range = ((v_idx[None, :] >= first[:, None])
                        & (v_idx[None, :] < (first + num)[:, None]))
            dots = torch.where(in_range, dots, -torch.inf)
            cvx = vertices[torch.argmax(dots, dim=-1)]
            sup = torch.where(vtx_range[:, None], cvx, sup)
        elif window > 0:
            j = torch.arange(window, device=d.device)
            idx = torch.clamp(first[:, None] + j, 0, vertices.shape[0] - 1)
            dots = torch.where(j < num[:, None],
                               _dot3(d[:, None, :], vertices[idx]),
                               -torch.inf)
            best = torch.gather(idx, 1, torch.argmax(dots, dim=-1,
                                                     keepdim=True))[:, 0]
            sup = torch.where(vtx_range[:, None], vertices[best], sup)
    return sup, radius


class CsoSupport(NamedTuple):
    """One support sample of the configuration-space obstacle A ⊖ B:
    w = p_a − p_b in A's frame, with the two witnesses."""

    w: torch.Tensor
    p_a: torch.Tensor
    p_b: torch.Tensor


class _Cso:
    """Support samples of A ⊖ B for a batch of pairs [M]: ``r_ab`` /
    ``t_ab`` are B's rotation matrix and translation in A's frame. A call
    takes directions [M, 3] or [M, K, 3] (K directions a pair) and runs
    both shapes' supports as one batch (each row's arithmetic is its own,
    so the bits are those of two calls)."""

    def __init__(self, tag_a, par_a, tag_b, par_b, r_ab, t_ab,
                 vertices=None, tri_verts_a=None, window=None):
        self.tag = torch.cat([tag_a, tag_b])
        self.par = torch.cat([par_a, par_b])
        self.r, self.t, self.vertices = r_ab, t_ab, vertices
        self.tri_verts_a, self.window = tri_verts_a, window

    def __call__(self, d: torch.Tensor) -> CsoSupport:
        d3 = d[:, None, :] if d.dim() == 2 else d
        m, k = d3.shape[:2]
        # d in B's frame: Rᵀ d, each row summed left to right
        d_b = _dot3(self.r.transpose(1, 2)[:, None], d3[:, :, None, :])
        tag, par = self.tag, self.par
        if k > 1:
            tag = tag[:, None].expand(-1, k).reshape(-1)
            par = par[:, None].expand(-1, k, -1).reshape(-1, par.shape[-1])
        dirs = torch.cat([d3, -d_b]).reshape(-1, 3)
        if self.tri_verts_a is None:
            sup, _ = support_core(tag, par, dirs, self.vertices,
                                  window=self.window)
        else:
            # A's rows take their triangle, B's the buffer (a TRIANGLE
            # there reads its vertex range), as two calls
            sup = torch.cat([
                support_core(tag[:m * k], par[:m * k], dirs[:m * k],
                             self.vertices, self.tri_verts_a,
                             window=self.window)[0],
                support_core(tag[m * k:], par[m * k:], dirs[m * k:],
                             self.vertices, window=self.window)[0]])
        sup = sup.reshape(2 * m, k, 3)
        sup_a, sup_b_local = sup[:m], sup[m:]
        sup_b = self.t[:, None, :] + _dot3(self.r[:, None],
                                           sup_b_local[:, :, None, :])
        out = CsoSupport(sup_a - sup_b, sup_a, sup_b)
        return CsoSupport(*(x[:, 0] for x in out)) if d.dim() == 2 else out


def relative_pose(pose_a: Sim, pose_b: Sim):
    """B's rotation matrix and translation in A's frame (the translation
    divided by A's scale)."""
    q_ab = quat.mul(quat.inv(pose_a.rotation), pose_b.rotation)
    t_ab = quat.inv_mul_vec(pose_a.rotation,
                            pose_b.translation - pose_a.translation)
    return quat.to_matrix(q_ab), t_ab / pose_a.scale[..., None]


def cso_support(tag_a, par_a, tag_b, par_b, r_ab, t_ab, d,
                vertices=None, tri_verts_a=None,
                tri_margin: float = 0.0) -> CsoSupport:
    """Support of A ⊖ B along d (A's frame); ``r_ab`` / ``t_ab``: B's
    rotation matrix and translation in A's frame; ``tri_verts_a``: each
    pair's triangle where A is a TRIANGLE. ``tri_margin`` is that
    triangle's dilation radius: the samples are of the shapes' cores, so
    it moves none of them (as in the JAX package, which passes it to
    ``support_core`` and drops the radius)."""
    del tri_margin  # a radius, which the core samples do not carry
    return _Cso(tag_a, par_a, tag_b, par_b, r_ab, t_ab, vertices,
                tri_verts_a)(d)


# ---------------------------------------------------------------------------
# the Voronoi simplex: the closest point to the origin, branch-free
# ---------------------------------------------------------------------------


def _closest_segment(a, b):
    """Barycentric weight of b at the closest point of [a, b] to the
    origin."""
    ab = b - a
    t = -_dot3(a, ab) / torch.clamp(_dot3(ab, ab), min=1e-30)
    return torch.clamp(t, 0.0, 1.0)


def _tri_bary(a, b, c):
    """Barycentric (u, v, w) [..., 3] of the origin's closest point on the
    triangle abc [..., 3] (Ericson's region method)."""
    ab = b - a
    ac = c - a
    ap = -a
    d1 = _dot3(ab, ap)
    d2 = _dot3(ac, ap)
    bp = -b
    d3 = _dot3(ab, bp)
    d4 = _dot3(ac, bp)
    cp = -c
    d5 = _dot3(ab, cp)
    d6 = _dot3(ac, cp)
    va = d3 * d6 - d5 * d4
    vb = d5 * d2 - d1 * d6
    vc = d1 * d4 - d3 * d2
    denom = torch.clamp(va + vb + vc, min=1e-30)
    v = vb / denom
    w = vc / denom
    u = 1.0 - v - w

    t_ab = torch.clamp(d1 / torch.clamp(d1 - d3, min=1e-30), 0.0, 1.0)
    t_ac = torch.clamp(d2 / torch.clamp(d2 - d6, min=1e-30), 0.0, 1.0)
    t_bc = torch.clamp((d4 - d3) / torch.clamp((d4 - d3) + (d5 - d6),
                                               min=1e-30), 0.0, 1.0)
    zero, one = torch.zeros_like(u), torch.ones_like(u)

    def pick(mask, x, y, z, bary):
        return torch.where(mask[..., None], torch.stack([x, y, z], -1), bary)

    bary = torch.stack([u, v, w], -1)
    bary = pick((va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0), zero,
                1 - t_bc, t_bc, bary)
    bary = pick((vb <= 0) & (d2 >= 0) & (d6 <= 0), 1 - t_ac, zero, t_ac,
                bary)
    bary = pick((vc <= 0) & (d1 >= 0) & (d3 <= 0), 1 - t_ab, t_ab, zero,
                bary)
    bary = pick((d6 >= 0) & (d5 <= d6), zero, zero, one, bary)
    bary = pick((d3 >= 0) & (d4 <= d3), zero, one, zero, bary)
    bary = pick((d1 <= 0) & (d2 <= 0), one, zero, zero, bary)
    return bary


# the tetrahedron's faces (abc, abd, acd, bcd) and the vertex opposite each
_FACES = ((0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3))
_OPPOSITE = (3, 2, 1, 0)


def _weighted(bary: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``einsum("nk,nkd->nd", bary, pts)``, summed over k left to right."""
    out = bary[:, 0:1] * pts[:, 0]
    for k in range(1, bary.shape[1]):
        out = out + bary[:, k:k + 1] * pts[:, k]
    return out


def _simplex_closest(pts, size):
    """The closest point of each simplex to the origin.

    pts [N, 4, 3], size [N] in {1, 2, 3, 4}. Returns (v [N, 3], bary
    [N, 4], contains_origin [N]); the caller drops the slots whose weight
    is ~0. The tetrahedron's four faces run as one batch."""
    n = pts.shape[0]
    dev = pts.device
    a, b = pts[:, 0], pts[:, 1]
    zero = torch.zeros((n, 1), dtype=pts.dtype, device=dev)

    bary1 = torch.cat([torch.ones_like(zero), zero, zero, zero], dim=1)
    t = _closest_segment(a, b)[:, None]
    bary2 = torch.cat([1 - t, t, zero, zero], dim=1)

    fi = _const(_FACES, pts, torch.int64)  # [4, 3]
    fp = pts[:, fi]  # [N, 4 faces, 3 corners, 3]
    p0, p1, p2 = fp[:, :, 0], fp[:, :, 1], fp[:, :, 2]
    fb = _tri_bary(p0, p1, p2)  # [N, 4, 3]
    bary3 = torch.cat([fb[:, 0], zero], dim=1)
    face_bary = torch.zeros((n, 4, 4), dtype=pts.dtype, device=dev)
    face_bary.scatter_(2, fi[None].expand(n, -1, -1), fb)
    vf = (fb[..., 0:1] * p0 + fb[..., 1:2] * p1) + fb[..., 2:3] * p2
    d_face = _dot3(vf, vf)

    # the origin is inside iff STRICTLY on the opposite vertex's side of
    # every face (normalized: a degenerate face must not certify it)
    opp = pts[:, _const(_OPPOSITE, pts, torch.int64)]
    nrm = quat.cross(p1 - p0, p2 - p0)
    nn = _norm3(nrm) + 1e-30
    d_origin = _dot3(nrm, -p0) / nn
    d_opp = _dot3(nrm, opp - p0) / nn
    inside = torch.all(d_origin * torch.sign(d_opp) > 1e-7, dim=1)
    face_idx = torch.argmin(d_face, dim=-1)
    bary4 = torch.gather(face_bary, 1,
                         face_idx[:, None, None].expand(-1, 1, 4))[:, 0]
    bary4 = torch.where(inside[:, None], torch.full_like(bary4, 0.25), bary4)

    s = size[:, None]
    bary = torch.where(s == 1, bary1, torch.where(
        s == 2, bary2, torch.where(s == 3, bary3, bary4)))
    v = _weighted(bary, pts)
    return v, bary, (size == 4) & inside


def _compact_simplex(simplex, bary):
    """Drop the slots of ~zero weight: the kept slots first in their order
    (``simplex`` [N, 4, C], the points and their witnesses side by side),
    and the new size (at least 1)."""
    keep = bary > 1e-7
    order = torch.argsort(torch.where(keep, 0, 1), dim=-1, stable=True)
    simplex = torch.gather(simplex, 1, order[:, :, None].expand(
        -1, -1, simplex.shape[-1]))
    return simplex, torch.clamp(keep.sum(-1), min=1)


@dataclasses.dataclass
class GjkResult:
    distance: torch.Tensor  # [N] core distance (0 where the cores overlap)
    point_a: torch.Tensor  # [N, 3] closest point on core A (A's frame)
    point_b: torch.Tensor  # [N, 3] closest point on core B (A's frame)
    normal: torch.Tensor  # [N, 3] unit A→B direction (A's frame)
    intersecting: torch.Tensor  # [N] bool: the cores overlap (EPA's case)


def gjk_distance(tag_a, par_a, pose_a: Sim, tag_b, par_b, pose_b: Sim,
                 *, max_iters: int = MAX_ITERS, vertices=None,
                 tri_verts_a=None, window: int | None = None,
                 sync_free: bool | None = None) -> GjkResult:
    """Batched GJK distance between the shapes' cores, in A's frame.

    The JAX package loops ``while i < max_iters and any(active)``. The
    sync-free form (``sync_free``; the default on a CUDA tensor) always
    runs ``max_iters`` iterations, with no host read: a lane that has
    retired (converged or found the origin) changes nothing after that
    (``inter`` only gains ``active`` lanes, and the simplex and its size
    only take ``new_active`` lanes, a subset of ``active``), so the extra
    iterations leave every lane's bits as the early exit would. On a CPU
    tensor, where the read is free, the loop leaves once every lane has
    retired, as JAX's does; ``sync_free=True`` runs the card's form there
    (``tests/test_torch_gjk.py`` holds the two equal, bit for bit).
    ``tri_verts_a`` [N, 3, 3]: A's triangle where A is a TRIANGLE (the
    mesh narrow phase); ``window``: :func:`support_core`'s."""
    r_ab, t_ab = relative_pose(pose_a, pose_b)
    cso = _Cso(tag_a, par_a, tag_b, par_b, r_ab, t_ab, vertices,
               tri_verts_a, window)
    n = t_ab.shape[0]

    # first direction: the centre offset (+x for concentric pairs)
    d0 = torch.where(_norm3(t_ab, keepdim=True) > 1e-9, -t_ab,
                     _unit(0, t_ab))
    d0 = d0 / _norm3(d0, keepdim=True)
    s0 = cso(d0)
    # the simplex's points and their two witnesses, 9 floats a slot
    simplex = torch.zeros((n, 4, 9), dtype=t_ab.dtype, device=t_ab.device)
    simplex[:, 0] = torch.cat([s0.w, s0.p_a, s0.p_b], dim=-1)
    size = torch.ones((n,), dtype=torch.int64, device=t_ab.device)
    active = torch.ones((n,), dtype=torch.bool, device=t_ab.device)
    inter = torch.zeros_like(active)
    if sync_free is None:
        sync_free = t_ab.device.type != "cpu"

    for _ in range(max_iters):
        if not sync_free and not bool(active.any()):
            break
        v, bary, contains = _simplex_closest(simplex[..., :3], size)
        vnorm = _norm3(v)
        hit = contains | (vnorm < EPS)
        inter = inter | (active & hit)
        active = active & ~hit

        simplex_c, size_c = _compact_simplex(simplex, bary)
        d = -v / torch.clamp(vnorm, min=1e-30)[:, None]
        s = cso(d)
        # van den Bergen's test: |v| (upper bound) against -(w·d)
        gap = vnorm + _dot3(s.w, d)
        new_active = active & ~(gap <= 1e-6 * vnorm + 1e-9)

        ins = torch.clamp(size_c, max=3)
        simplex_n = simplex_c.scatter(
            1, ins[:, None, None].expand(-1, 1, 9),
            torch.cat([s.w, s.p_a, s.p_b], dim=-1)[:, None, :])
        simplex = torch.where(new_active[:, None, None], simplex_n, simplex)
        size = torch.where(new_active, torch.clamp(size_c + 1, max=4), size)
        active = new_active

    v, bary, contains = _simplex_closest(simplex[..., :3], size)
    inter = inter | contains
    point_a = _weighted(bary, simplex[..., 3:6])
    point_b = _weighted(bary, simplex[..., 6:9])
    dist = _norm3(v)
    normal = torch.where((dist > 1e-9)[:, None],
                         -v / torch.clamp(dist, min=1e-30)[:, None],
                         _unit(1, v))
    dist = torch.where(inter, torch.zeros_like(dist), dist)
    return GjkResult(dist, point_a, point_b, normal, inter)


def _set_rows(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
              drop: int) -> torch.Tensor:
    """``dst.at[idx].set(src, mode="drop")`` with ``drop`` = out of range;
    the kept rows are unique."""
    pad = torch.zeros((1,) + dst.shape[1:], dtype=dst.dtype,
                      device=dst.device)
    out = torch.cat([dst, pad])
    out[idx] = src.to(dst.dtype)
    return out[:drop]


def pfm_contact(tag_a, par_a, pose_a: Sim, tag_b, par_b, pose_b: Sim,
                mask=None, *, epa_cap: int = 256, vertices=None,
                tri_verts_a=None, tri_margin: float = 0.0, use_epa=True,
                window: int | None = None, sync_free: bool | None = None):
    """One contact point for support-mapped pairs: GJK on the cores minus
    both dilation radii, and EPA for the pairs whose cores overlap (and
    ``mask`` allows), compacted into a batch of ``epa_cap``. As in the JAX
    package: the batch's empty slots run EPA on pair 0 and their results
    are dropped, and pairs past the cap keep GJK's answer.

    ``tri_verts_a`` [N, 3, 3]: A's triangle where A is a TRIANGLE, dilated
    by ``tri_margin``. ``use_epa="2d"``: 2D pairs embedded in the z = 0
    plane, their EPA the polygon's (``epa.epa2_penetration``).
    ``use_epa=False`` (the mesh narrow phase, whose
    triangles rely on their margin shell): a pair whose cores overlap
    keeps GJK's point and distance and is pushed along the centre axis
    instead. ``window``: :func:`support_core`'s. ``sync_free``:
    :func:`gjk_distance`'s; outside that form (the default on a CPU
    tensor) the EPA batch is also cut to the demand, read for free: each
    slot's EPA is its own arithmetic, so the active slots keep their bits.

    Returns (normal [N, 3] A→B, point on A [N, 3], dist [N]), all in A's
    frame, and the unclamped count of core-overlapping pairs that ``mask``
    allows (a device scalar, no sync: the EPA demand against ``epa_cap``,
    or the pushes along the centre axis)."""
    from wgmath_tpu_torch.queries.epa import (
        epa2_penetration,
        epa_penetration,
    )

    if use_epa not in (True, False, "2d"):
        raise ValueError(f"use_epa={use_epa!r}: True, False or '2d'")
    n = pose_a.translation.shape[0]
    dev = pose_a.translation.device
    if sync_free is None:
        sync_free = dev.type != "cpu"
    res = gjk_distance(tag_a, par_a, pose_a, tag_b, par_b, pose_b,
                       vertices=vertices, tri_verts_a=tri_verts_a,
                       window=window, sync_free=sync_free)
    d0 = _unit(1, res.normal)
    if tri_verts_a is None and tri_margin == 0.0:
        _, rad = support_core(torch.cat([tag_a, tag_b]),
                              torch.cat([par_a, par_b]),
                              torch.cat([d0, d0]))
        rad_a, rad_b = rad[:n], rad[n:]
    else:
        rad_a = support_core(tag_a, par_a, d0, tri_verts=tri_verts_a,
                             tri_margin=tri_margin)[1]
        rad_b = support_core(tag_b, par_b, d0)[1]
    dist = res.distance - rad_a - rad_b
    normal = res.normal
    pt_a = res.point_a + normal * rad_a[:, None]

    flags = res.intersecting if mask is None else res.intersecting & mask
    if use_epa is False:
        # deep cores without EPA: push along the centre axis (A's frame)
        t_c = quat.inv_mul_vec(pose_a.rotation,
                               pose_b.translation - pose_a.translation)
        t_n = _norm3(t_c, keepdim=True)
        axis = torch.where(t_n > 1e-9, t_c / torch.clamp(t_n, min=1e-30),
                           _unit(1, t_c))
        return (torch.where(flags[:, None], axis, normal), pt_a, dist,
                flags.sum())
    demand = flags.sum()
    if not sync_free:
        epa_cap = min(epa_cap, int(demand))
        if epa_cap == 0:
            return normal, pt_a, dist, demand
    pos = torch.cumsum(flags.to(torch.int64), 0) - 1
    slot = torch.where(flags & (pos < epa_cap), pos,
                       torch.full_like(pos, epa_cap))
    sel = torch.zeros(epa_cap + 1, dtype=torch.int64, device=dev)
    sel.scatter_(0, slot, torch.arange(n, device=dev))
    sel = sel[:epa_cap]
    active = torch.arange(epa_cap, device=dev) < torch.clamp(demand,
                                                              max=epa_cap)

    r_ab, t_ab = relative_pose(pose_a.take(sel), pose_b.take(sel))
    epa = epa2_penetration if use_epa == "2d" else epa_penetration
    e_n, e_depth, e_pa = epa(tag_a[sel], par_a[sel], tag_b[sel], par_b[sel],
                             r_ab, t_ab, vertices=vertices)
    sel_drop = torch.where(active, sel, torch.full_like(sel, n))
    normal = _set_rows(normal, sel_drop, e_n, n)
    dist = _set_rows(dist, sel_drop, -(e_depth + rad_a[sel] + rad_b[sel]), n)
    pt_a = _set_rows(pt_a, sel_drop, e_pa + e_n * rad_a[sel][:, None], n)
    return normal, pt_a, dist, demand
