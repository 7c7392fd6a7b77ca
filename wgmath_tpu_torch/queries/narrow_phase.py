"""Narrow phase: collision pairs → contact manifolds (counterpart of
``wgmath_tpu/queries/narrow_phase.py``: the ball-ball, ball-cuboid,
cuboid-cuboid and support-mapped kernels, gated on ``ShapeSet.kinds``, in
3D and 2D).

Contacts reuse the pair slots 1:1. Each type-pair kernel is a masked
vectorized pass over the pair list; ball-cuboid pairs are optionally
compacted into a ``bc_capacity`` batch first, cuboid-cuboid pairs into a
``sat_capacity`` batch and the other support-mapped pairs (capsules,
cylinders, cones, standalone segments and triangles and convex polyhedra,
against anything but a mesh) into a ``pfm_capacity`` batch (their
unclamped counts are returned so the host can regrow those capacities).
Pairs with a trimesh or a polyline get no row here:
``queries/mesh_contact.py`` appends theirs after these.

In 2D the cuboid pairs take the 2D SAT (``sat.cuboid_cuboid_manifold_2d``)
and the support-mapped pairs (capsules with anything but a cuboid pair or
a ball pair) run densely, embedded in 3D: a rotation about z, cuboids
given a tall z-extent so no z-face can win, and the polygon EPA
(``pfm_contact(..., use_epa="2d")``), one point a pair, as in the JAX
package.
"""

from __future__ import annotations

import torch

from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.broad_phase.grid import top_k_desc
from wgmath_tpu_torch.dynamics.constraint import Contacts, max_points
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.quat import norm
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries.gjk import _set_rows, _sqrt, pfm_contact
from wgmath_tpu_torch.queries.pfm_manifold import pfm_manifold
from wgmath_tpu_torch.queries.sat import (
    cuboid_cuboid_manifold,
    cuboid_cuboid_manifold_2d,
)
from wgmath_tpu_torch.shapes import shape as shp


def ball_ball(pose_a: Sim, pose_b: Sim, ra, rb):
    """Single-point ball-ball manifold: (normal, point) in A's local frame
    and the signed distance."""
    ra_eff = ra * pose_a.scale
    rb_eff = rb * pose_b.scale
    d = pose_b.translation - pose_a.translation
    center_dist = norm(d)
    dist = center_dist - (ra_eff + rb_eff)
    safe = center_dist > 1e-9
    x_axis = torch.zeros_like(d)
    x_axis[..., 0] = 1.0
    n_world = torch.where(
        safe[..., None], d / torch.clamp(center_dist, min=1e-30)[..., None],
        x_axis)
    pt_world = pose_a.translation + n_world * ra_eff[..., None]
    n_local = sim_ops.inv_mul_unit_vec(pose_a, n_world)
    pt_local = sim_ops.inv_mul_pt(pose_a, pt_world)
    return n_local, pt_local, dist


def ball_cuboid(pose_ball: Sim, pose_box: Sim, radius, half_extents):
    """Single-point ball-cuboid manifold by point-box projection in the
    box frame. Returns (point on box, normal box→ball, dist), world frame."""
    c_local = sim_ops.inv_mul_pt(pose_box, pose_ball.translation)
    he = half_extents
    clamped = torch.maximum(torch.minimum(c_local, he), -he)
    delta = c_local - clamped
    d_out = norm(delta)
    outside = d_out > 1e-9
    gap = he - torch.abs(c_local)
    axis = torch.argmin(gap, dim=-1, keepdim=True)
    sign = torch.where(torch.gather(c_local, -1, axis) >= 0, 1.0, -1.0).to(
        c_local.dtype)
    n_in = torch.zeros_like(c_local).scatter(-1, axis, sign)
    depth_in = -torch.gather(gap, -1, axis)[..., 0]
    n_local_box = torch.where(
        outside[..., None], delta / torch.clamp(d_out, min=1e-30)[..., None],
        n_in)
    dist_surface = torch.where(outside, d_out, depth_in)
    dist = dist_surface - radius * pose_ball.scale
    pt_box_local = torch.where(outside[..., None], clamped,
                               c_local - n_in * depth_in[..., None])
    pt_world = sim_ops.mul_pt(pose_box, pt_box_local)
    n_world = sim_ops.mul_unit_vec(pose_box, n_local_box)
    return pt_world, n_world, dist


def _compact_mask(mask: torch.Tensor, capacity: int):
    """Indices of up to ``capacity`` set entries of ``mask``, their active
    flags, and the unclamped match count."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int64), 0) - 1
    slot = torch.where(mask & (pos < capacity), pos,
                       torch.full_like(pos, capacity))
    sel = torch.zeros(capacity + 1, dtype=torch.int64, device=mask.device)
    sel.scatter_(0, slot, torch.arange(n, device=mask.device))
    sel = sel[:capacity]
    total = mask.sum()
    active = torch.arange(capacity, device=mask.device) < torch.clamp(
        total, max=capacity)
    return sel, active, total


def _sat(pose_a: Sim, pose_b: Sim, he_a, he_b, prediction: float,
         p_max: int):
    """``cuboid_cuboid_manifold`` (``_2d`` for 2D poses) cut to the
    ``p_max`` deepest points (``lax.top_k`` of ``-dist``: equal depths keep
    the lower slot first)."""
    dim = pose_a.translation.shape[-1]
    manifold = (cuboid_cuboid_manifold if dim == 3
                else cuboid_cuboid_manifold_2d)
    n_l, pts, dist, num = manifold(pose_a, pose_b, he_a, he_b, prediction)
    if p_max < dist.shape[1]:
        neg_d, kidx = top_k_desc(-dist, p_max)
        pts = torch.gather(pts, 1, kidx[..., None].expand(-1, -1, dim))
        dist, num = -neg_d, torch.clamp(num, max=p_max)
    return n_l, pts, dist, num


def _pfm(pose_a: Sim, pose_b: Sim, tag_a, par_a, tag_b, par_b, mask,
         prediction: float, p_max: int, vertices, indices=None,
         window: int | None = None):
    """The support-mapped kernel: ``pfm_contact``'s point, normal and
    distance, then (``p_max > 1``) ``pfm_manifold``'s points cut to the
    ``min(4, p_max)`` deepest. Returns ``(normal, points [N, k, 3], dist
    [N, k], num_points, epa_demand)``, the last ``pfm_contact``'s unclamped
    count of core-overlapping pairs. ``indices`` (the shared index
    buffer) gives convex polyhedra their hull faces in the clip;
    ``window``: ``gjk.support_core``'s."""
    n_p, p_p, d_p, demand = pfm_contact(tag_a, par_a, pose_a, tag_b, par_b,
                                        pose_b, mask=mask, vertices=vertices,
                                        window=window)
    if p_max == 1:
        return (n_p, p_p[:, None], d_p[:, None], torch.ones_like(tag_a),
                demand)
    pts, dist, num = pfm_manifold(tag_a, par_a, pose_a, tag_b, par_b, pose_b,
                                  n_p, p_p, d_p, prediction,
                                  vertices=vertices, indices=indices)
    k = min(4, p_max)
    if k < 4:  # the k deepest points (lax.top_k of -dist)
        neg_d, kidx = top_k_desc(-dist, k)
        pts = torch.gather(pts, 1, kidx[..., None].expand(-1, -1, 3))
        dist = -neg_d
    return n_p, pts[:, :k], dist[:, :k], torch.clamp(num, max=k), demand


# On the card the support-mapped kernel runs as a CUDA graph: GJK's 32
# iterations, EPA's 14 and the clip are thousands of small launches, which
# the host would otherwise enqueue one by one; so does the mesh contacts'
# per-triangle GJK (``mesh_contact.mesh_convex_contacts``). One graph is
# kept per key (the device and the call's static arguments) and replayed
# while the batch's shapes and dtypes stay; a batch of another shape (a
# regrown capacity) replaces it and frees the old graph's memory pool. A
# replay runs the same kernels on the same shapes, so it gives the eager
# run's bits (tests/test_torch_cuda.py).
_GRAPHS: dict = {}


class _Graph:
    """``fn(*args)`` captured with copies of its tensor arguments as the
    static inputs, and its outputs."""

    def __init__(self, fn, args):
        self.inputs = [a.clone() for a in args]
        self.shapes = _batch_shapes(args)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn(*self.inputs)  # the warm-up makes the cached constants
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.outputs = fn(*self.inputs)

    def __call__(self, args):
        for dst, src in zip(self.inputs, args):
            dst.copy_(src)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


def _batch_shapes(args) -> tuple:
    return tuple((a.shape, a.dtype) for a in args)


def graph_call(key, fn, args: tuple) -> tuple:
    """``fn(*args)`` (tensors in, a tuple of tensors out, no host read) as
    the CUDA graph kept under ``key``, captured anew when the arguments'
    shapes change."""
    graph = _GRAPHS.get(key)
    if graph is None or graph.shapes != _batch_shapes(args):
        if graph is not None:
            graph.graph.reset()
        graph = _GRAPHS[key] = _Graph(fn, args)
    return graph(args)


def _pfm_call(pose_a: Sim, pose_b: Sim, tag_a, par_a, tag_b, par_b, mask,
              prediction: float, p_max: int, vertices, indices=None,
              window: int | None = None):
    """:func:`_pfm`, on the card through its CUDA graph (a shape set
    without vertices; with them, eagerly)."""
    dev = pose_a.translation.device
    if dev.type != "cuda" or vertices.shape[0]:
        return _pfm(pose_a, pose_b, tag_a, par_a, tag_b, par_b, mask,
                    prediction, p_max, vertices, indices, window)

    def run(ra, ta, sa, rb, tb, sb, tag_a, par_a, tag_b, par_b, mask):
        return _pfm(Sim(ra, ta, sa), Sim(rb, tb, sb), tag_a, par_a, tag_b,
                    par_b, mask, prediction, p_max, vertices)

    return graph_call(
        ("pfm", dev, float(prediction), p_max), run,
        (pose_a.rotation, pose_a.translation, pose_a.scale, pose_b.rotation,
         pose_b.translation, pose_b.scale, tag_a, par_a, tag_b, par_b,
         mask))


def _embed(pose: Sim, tag, par):
    """A 2D pose and shape row in 3D: the rotation about z, the
    translation at z = 0, a cuboid 1e3 deep in z."""
    cth, sth = pose.rotation[..., 0], pose.rotation[..., 1]
    half = _sqrt(torch.clamp((1.0 + cth) * 0.5, min=0.0))
    sh = torch.where(half > 1e-6, sth / torch.clamp(2.0 * half, min=1e-30),
                     torch.ones_like(half))
    zero = torch.zeros_like(cth)
    q = torch.stack([zero, zero, sh, half], -1)
    t3 = torch.cat([pose.translation, zero[:, None]], dim=-1)
    par3 = par.clone()
    par3[:, 2] = 1e3
    par3 = torch.where((tag == shp.CUBOID)[:, None], par3, par)
    return Sim(q, t3, pose.scale), par3


def _f64(pose: Sim, par):
    return (Sim(pose.rotation.double(), pose.translation.double(),
                pose.scale.double()), par.double())


def _pfm2(pose_a: Sim, pose_b: Sim, tag_a, par_a, tag_b, par_b, mask):
    """The 2D support-mapped kernel: the pairs embedded in 3D
    (:func:`_embed`), ``pfm_contact`` with the polygon EPA in float64, the
    normal brought back to the plane and renormalized. Returns (normal
    [N, 2], point on A [N, 2], dist [N]), float32.

    The JAX package runs this in float32, where a cuboid 1e3 deep in z
    leaves GJK's simplex coordinates a thousand times the contact's scale:
    on a few pairs a frame, which an ulp of rounding picks, the contact
    leaves the exact one, by up to a quarter metre (ROADMAP C14). The same
    arithmetic in float32 here picks other pairs, so it cannot give JAX's
    rows either; in float64 every row is the exact contact within 1e-6
    (``scripts/check_planar_c14.py``)."""
    pose_a3, par_a3 = _f64(*_embed(pose_a, tag_a, par_a))
    pose_b3, par_b3 = _f64(*_embed(pose_b, tag_b, par_b))
    n_p3, p_p3, d_p, _ = pfm_contact(tag_a, par_a3, pose_a3, tag_b, par_b3,
                                     pose_b3, mask=mask, vertices=None,
                                     use_epa="2d")
    n_p3, p_p3, d_p = (x.float() for x in (n_p3, p_p3, d_p))
    n2 = n_p3[:, :2]
    nn = _sqrt(n2[:, 0] * n2[:, 0] + n2[:, 1] * n2[:, 1])[:, None]
    up = torch.zeros_like(n2)
    up[:, 1] = 1.0
    n2 = torch.where(nn > 1e-6, n2 / torch.clamp(nn, min=1e-30), up)
    return n2, p_p3[:, :2], d_p


def _pfm2_call(pose_a: Sim, pose_b: Sim, tag_a, par_a, tag_b, par_b,
               mask):
    """:func:`_pfm2`, on the card through its CUDA graph over every pair
    slot; on the CPU over the ``mask``'s slots only (each slot's
    arithmetic is its own, so they keep their bits; the others, which the
    narrow phase discards, are zeros). The CPU compaction keeps the CPU
    tests' time down: ``capsules2`` has 16,384 pair slots, ~100 of them
    live, and its frames take about three times as long without it. On
    the card a compaction would read the count back and break the
    graph."""
    dev = pose_a.translation.device
    if dev.type != "cuda":
        idx = torch.nonzero(mask).flatten()
        sub = _pfm2(pose_a.take(idx), pose_b.take(idx), tag_a[idx],
                    par_a[idx], tag_b[idx], par_b[idx], mask[idx])
        out = tuple(torch.zeros((mask.shape[0],) + x.shape[1:],
                                dtype=x.dtype) for x in sub)
        for o, x in zip(out, sub):
            o[idx] = x
        return out

    def run(ra, ta, sa, rb, tb, sb, tag_a, par_a, tag_b, par_b, mask):
        return _pfm2(Sim(ra, ta, sa), Sim(rb, tb, sb), tag_a, par_a, tag_b,
                     par_b, mask)

    return graph_call(
        ("pfm2", dev), run,
        (pose_a.rotation, pose_a.translation, pose_a.scale, pose_b.rotation,
         pose_b.translation, pose_b.scale, tag_a, par_a, tag_b, par_b,
         mask))


def narrow_phase(poses: Sim, shapes: shp.ShapeSet, pairs: PairList,
                 prediction_distance: float, *, p_max: int = 0,
                 bc_capacity: int = 0, sat_capacity: int = 0,
                 pfm_capacity: int = 0, with_overflow: bool = False):
    """One manifold per pair slot. Returns the contacts, and with
    ``with_overflow=True`` ``(contacts, np_needed)`` with ``np_needed`` =
    [bc, sat, pfm] unclamped compaction demands (0 for a kernel run
    dense), as in the JAX package. ``p_max`` is the manifold width (0:
    ``max_points(dim)``, 4 in 3D and 2 in 2D); ``p_max == 1`` asserts
    that no cuboid-cuboid pair can act and skips the SAT kernel, and
    gives the support-mapped pairs their one GJK / EPA point; a narrower
    ``p_max`` than 4 keeps each manifold's deepest points. 2D takes
    balls, cuboids, capsules and polylines (whose contacts
    ``mesh_contact`` appends); 3D takes ``shp.SUPPORTED_KINDS``."""
    kinds = shapes.kinds
    dim = poses.translation.shape[-1]
    p_max = p_max or max_points(dim)
    ok = (shp.SUPPORTED_KINDS if dim == 3 else shp.PLANAR_KINDS)
    if not kinds <= ok:
        raise NotImplementedError(
            f"narrow phase: shape kinds {sorted(kinds)} in {dim}D")
    dev = poses.translation.device
    a, b = pairs.body_a, pairs.body_b
    pose_a, pose_b = poses.take(a), poses.take(b)
    par_a, par_b = shapes.params[a], shapes.params[b]
    tag_a, tag_b = shapes.tag[a], shapes.tag[b]
    c = pairs.capacity
    normal_a = torch.zeros((c, dim), device=dev)
    points_a = torch.zeros((c, p_max, dim), device=dev)
    dist = torch.full((c, p_max), 1e9, device=dev)
    num_points = torch.zeros((c,), dtype=torch.int64, device=dev)
    bc_needed = torch.zeros((), dtype=torch.int64, device=dev)
    sat_needed = torch.zeros((), dtype=torch.int64, device=dev)
    pfm_needed = torch.zeros((), dtype=torch.int64, device=dev)
    has_ball = shp.BALL in kinds
    has_cuboid = shp.CUBOID in kinds

    if has_ball:
        bb = (tag_a == shp.BALL) & (tag_b == shp.BALL)
        n_l, p_l, d_bb = ball_ball(pose_a, pose_b, par_a[:, 0], par_b[:, 0])
        normal_a = torch.where(bb[:, None], n_l, normal_a)
        points_a[:, 0] = torch.where(bb[:, None], p_l, points_a[:, 0])
        dist[:, 0] = torch.where(bb, d_bb, dist[:, 0])
        num_points = torch.where(bb, 1, num_points)

    if has_ball and has_cuboid and bc_capacity:
        m = (((tag_a == shp.BALL) & (tag_b == shp.CUBOID))
             | ((tag_a == shp.CUBOID) & (tag_b == shp.BALL))) & pairs.valid
        sel, act, bc_needed = _compact_mask(m, bc_capacity)
        swap = tag_a[sel] == shp.CUBOID
        pa_s, pb_s = poses.take(a[sel]), poses.take(b[sel])
        pball = Sim(torch.where(swap[:, None], pb_s.rotation, pa_s.rotation),
                    torch.where(swap[:, None], pb_s.translation,
                                pa_s.translation),
                    torch.where(swap, pb_s.scale, pa_s.scale))
        pbox = Sim(torch.where(swap[:, None], pa_s.rotation, pb_s.rotation),
                   torch.where(swap[:, None], pa_s.translation,
                               pb_s.translation),
                   torch.where(swap, pa_s.scale, pb_s.scale))
        r = torch.where(swap, par_b[sel, 0], par_a[sel, 0])
        he = torch.where(swap[:, None], par_a[sel, :dim], par_b[sel, :dim])
        pt_w, n_w, d_bc = ball_cuboid(pball, pbox, r, he)
        n_ab = torch.where(swap[:, None], n_w, -n_w)
        n_loc = sim_ops.inv_mul_unit_vec(pa_s, n_ab)
        pt_ball_w = pball.translation - n_w * (r * pball.scale)[:, None]
        pt_a_w = torch.where(swap[:, None], pt_w, pt_ball_w)
        p_loc = sim_ops.inv_mul_pt(pa_s, pt_a_w)
        sel_drop = torch.where(act, sel, torch.full_like(sel, c))
        normal_a = _set_rows(normal_a, sel_drop, n_loc, c)
        pts0 = _set_rows(points_a[:, 0].clone(), sel_drop, p_loc, c)
        points_a[:, 0] = pts0
        d0 = _set_rows(dist[:, 0].clone(), sel_drop, d_bc, c)
        dist[:, 0] = d0
        num_points = _set_rows(num_points, sel_drop,
                               torch.ones_like(sel_drop), c)
    elif has_ball and has_cuboid:
        for swap in (False, True):
            if swap:
                m = (tag_a == shp.CUBOID) & (tag_b == shp.BALL)
                pb, pc = pose_b, pose_a
                r, he = par_b[:, 0], par_a[:, :dim]
            else:
                m = (tag_a == shp.BALL) & (tag_b == shp.CUBOID)
                pb, pc = pose_a, pose_b
                r, he = par_a[:, 0], par_b[:, :dim]
            pt_w, n_w, d_bc = ball_cuboid(pb, pc, r, he)
            n_ab = n_w if swap else -n_w
            n_loc = sim_ops.inv_mul_unit_vec(pose_a, n_ab)
            pt_ball_w = pb.translation - n_w * (r * pb.scale)[:, None]
            pt_a_w = pt_w if swap else pt_ball_w
            p_loc = sim_ops.inv_mul_pt(pose_a, pt_a_w)
            normal_a = torch.where(m[:, None], n_loc, normal_a)
            points_a[:, 0] = torch.where(m[:, None], p_loc, points_a[:, 0])
            dist[:, 0] = torch.where(m, d_bc, dist[:, 0])
            num_points = torch.where(m, 1, num_points)

    if has_cuboid and p_max > 1:
        cc = (tag_a == shp.CUBOID) & (tag_b == shp.CUBOID) & pairs.valid
        if sat_capacity:
            sel, act, sat_needed = _compact_mask(cc, sat_capacity)
            n_l, pts_l, d_cc, np_cc = _sat(
                poses.take(a[sel]), poses.take(b[sel]), par_a[sel, :dim],
                par_b[sel, :dim], prediction_distance, p_max)
            sel_drop = torch.where(act, sel, torch.full_like(sel, c))
            normal_a = _set_rows(normal_a, sel_drop, n_l, c)
            points_a = _set_rows(points_a, sel_drop, pts_l, c)
            dist = _set_rows(dist, sel_drop, d_cc, c)
            num_points = _set_rows(num_points, sel_drop, np_cc, c)
        else:
            n_l, pts_l, d_cc, np_cc = _sat(pose_a, pose_b, par_a[:, :dim],
                                           par_b[:, :dim],
                                           prediction_distance, p_max)
            normal_a = torch.where(cc[:, None], n_l, normal_a)
            points_a = torch.where(cc[:, None, None], pts_l, points_a)
            dist = torch.where(cc[:, None], d_cc, dist)
            num_points = torch.where(cc, np_cc, num_points)

    # every pair no analytic kernel above takes, between support-mapped
    # shapes: GJK / EPA and the support-face clip (3D), GJK and the polygon
    # EPA, one point, in every pair slot (2D)
    pfm_kinds = kinds - {shp.BALL, shp.CUBOID, shp.TRIMESH, shp.POLYLINE}
    if pfm_kinds and dim == 2:
        handled = (((tag_a == shp.BALL) | (tag_a == shp.CUBOID))
                   & ((tag_b == shp.BALL) | (tag_b == shp.CUBOID)))
        supported = (tag_a <= shp.CAPSULE) & (tag_b <= shp.CAPSULE)
        pfm = ~handled & supported & pairs.valid
        n2, p2, d2 = _pfm2_call(pose_a, pose_b, tag_a, par_a, tag_b, par_b,
                                pfm)
        normal_a = torch.where(pfm[:, None], n2, normal_a)
        points_a[:, 0] = torch.where(pfm[:, None], p2, points_a[:, 0])
        dist[:, 0] = torch.where(pfm, d2, dist[:, 0])
        num_points = torch.where(pfm, 1, num_points)
    elif pfm_kinds:
        handled = (((tag_a == shp.BALL) | (tag_a == shp.CUBOID))
                   & ((tag_b == shp.BALL) | (tag_b == shp.CUBOID)))
        supported = (((tag_a <= shp.TRIANGLE) | (tag_a == shp.CONVEX))
                     & ((tag_b <= shp.TRIANGLE) | (tag_b == shp.CONVEX)))
        pfm = ~handled & supported & pairs.valid
        window = shp.vertex_window(shapes)
        if pfm_capacity:
            sel, act, pfm_needed = _compact_mask(pfm, pfm_capacity)
            n_p, pts_m, d_m, np_m, _ = _pfm_call(
                poses.take(a[sel]), poses.take(b[sel]), tag_a[sel],
                par_a[sel], tag_b[sel], par_b[sel], act,
                prediction_distance, p_max, shapes.vertices, shapes.indices,
                window)
            k = d_m.shape[1]
            sel_drop = torch.where(act, sel, torch.full_like(sel, c))
            normal_a = _set_rows(normal_a, sel_drop, n_p, c)
            points_a[:, :k] = _set_rows(points_a[:, :k].clone(), sel_drop,
                                        pts_m, c)
            dist[:, :k] = _set_rows(dist[:, :k].clone(), sel_drop, d_m, c)
            num_points = _set_rows(num_points, sel_drop, np_m, c)
        else:
            n_p, pts_m, d_m, np_m, _ = _pfm_call(
                pose_a, pose_b, tag_a, par_a, tag_b, par_b, pfm,
                prediction_distance, p_max, shapes.vertices, shapes.indices,
                window)
            k = d_m.shape[1]
            normal_a = torch.where(pfm[:, None], n_p, normal_a)
            points_a[:, :k] = torch.where(pfm[:, None, None], pts_m,
                                          points_a[:, :k])
            dist[:, :k] = torch.where(pfm[:, None], d_m, dist[:, :k])
            num_points = torch.where(pfm, np_m, num_points)

    valid = pairs.valid & (num_points > 0) & (dist[:, 0] < prediction_distance)
    contacts = Contacts(a, b, normal_a, points_a, dist, num_points, valid)
    if not with_overflow:
        return contacts
    return contacts, torch.stack([bc_needed.to(torch.int64),
                                  sat_needed.to(torch.int64),
                                  pfm_needed.to(torch.int64)])
