"""Contact constraints: data layout and builder (counterpart of
``wgmath_tpu/dynamics/constraint.py``).

One structure of arrays over a fixed-capacity constraint buffer; a
``valid`` mask replaces a live count. Per-manifold points are a static
trailing axis P, friction directions a trailing axis S (2 in 3D, 1 in 2D).
Angular quantities are 3-vectors in 3D and scalars in 2D (``gcross``,
``gdot``, ``ii_mul``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.dynamics.body import Velocity, WorldMassProperties
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.quat import cross, norm
from wgmath_tpu_torch.geometry.sim import Sim

S_LEN = 2  # friction directions per contact point (3D)


def max_points(dim: int) -> int:
    """Contact points a manifold holds at most: 4 in 3D, 2 in 2D."""
    return 4 if dim == 3 else 2


def sub_len(dim: int) -> int:
    """Friction directions per contact point."""
    return 2 if dim == 3 else 1


def gcross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """vector x vector: the angular quantity (a scalar in 2D)."""
    if a.shape[-1] == 2:
        return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]
    return cross(a, b)


def gcross_av(ang: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """angular x vector: a vector."""
    if v.shape[-1] == 2:
        return ang[..., None] * torch.stack([-v[..., 1], v[..., 0]], dim=-1)
    return cross(ang, v)


def gdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """angular · angular: a scalar."""
    if a.ndim == b.ndim and a.shape == b.shape and a.shape[-1:] == (3,):
        return torch.sum(a * b, dim=-1)
    return a * b


def ii_mul(inv_inertia: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """The world inverse inertia applied to an angular quantity."""
    if inv_inertia.ndim == 1:
        return inv_inertia * ang
    return torch.einsum("nij,nj->ni", inv_inertia, ang)


def orthonormal_vector(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit v (branch-free Duff et al. in 3D,
    the left normal in 2D)."""
    if v.shape[-1] == 2:
        return torch.stack([-v[..., 1], v[..., 0]], dim=-1)
    sign = torch.where(v[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v[..., 2])
    b = v[..., 0] * v[..., 1] * a
    return torch.stack([b, sign + v[..., 1] ** 2 * a, -v[..., 1]], dim=-1)


def tangent_directions(force_dir, linvel1, linvel2) -> torch.Tensor:
    """[..., S, dim] friction basis: in 3D the relative-velocity direction
    when it is large enough, else an arbitrary orthonormal vector; in 2D
    the contact normal's left normal."""
    if force_dir.shape[-1] == 2:
        return orthonormal_vector(force_dir)[..., None, :]
    rel = linvel1 - linvel2
    t = rel - force_dir * torch.sum(force_dir * rel, dim=-1, keepdim=True)
    n = norm(t, keepdim=True)
    fallback = orthonormal_vector(force_dir)
    t1 = torch.where(n < 1.0e-4, fallback, t / torch.clamp(n, min=1e-30))
    t2 = cross(force_dir, t1)
    return torch.stack([t1, t2], dim=-2)


def safe_inv(x: torch.Tensor) -> torch.Tensor:
    zero = x == 0.0
    return torch.where(zero, torch.zeros_like(x),
                       1.0 / torch.where(zero, torch.ones_like(x), x))


def maybe_inv(x: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """1/x where |x| > eps, else 0."""
    ok = torch.abs(x) > eps
    return torch.where(ok, 1.0 / torch.where(ok, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def cap_magnitude(v: torch.Tensor, limit: torch.Tensor) -> torch.Tensor:
    """``v`` [..., d] scaled down to a norm of at most ``limit`` [...]."""
    n = norm(v)
    scale = torch.where(n > limit, limit / torch.clamp(n, min=1e-30),
                        torch.ones_like(n))
    return v * scale[..., None]


@dataclasses.dataclass
class Contacts:
    """Fixed-capacity contact manifolds; ``normal_a``/``points_a`` in body
    A's local frame, ``dist < 0`` = penetration (invalid slots hold 1e9)."""

    body_a: torch.Tensor  # i64 [C]
    body_b: torch.Tensor  # i64 [C]
    normal_a: torch.Tensor  # [C, dim]
    points_a: torch.Tensor  # [C, P, dim]
    dist: torch.Tensor  # [C, P]
    num_points: torch.Tensor  # i64 [C]
    valid: torch.Tensor  # bool [C]

    @property
    def capacity(self) -> int:
        return self.body_a.shape[0]

    @property
    def dim(self) -> int:
        return self.normal_a.shape[-1]

    @staticmethod
    def empty(capacity: int, dim: int, device=None) -> "Contacts":
        """``capacity`` invalid zero slots of ``max_points(dim)`` points,
        on ``device`` (default the card)."""
        dev = resolve_device(device)
        p = max_points(dim)

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return Contacts(zeros(capacity, dtype=torch.int64),
                        zeros(capacity, dtype=torch.int64),
                        zeros(capacity, dim), zeros(capacity, p, dim),
                        zeros(capacity, p),
                        zeros(capacity, dtype=torch.int64),
                        zeros(capacity, dtype=torch.bool))


@dataclasses.dataclass
class ContactConstraints:
    """Two-body contact constraints; trailing axes P points, S directions.
    The shapes below are 3D; in 2D every 3 is the dimension 2 where it
    is a vector's, and angular terms are scalars (``n_torque_a`` [C, P],
    ``t_torque_a`` [C, P, S]), ``t_r`` [C, P, 1] holds 1/r."""

    body_a: torch.Tensor  # i64 [C]
    body_b: torch.Tensor  # i64 [C]
    valid: torch.Tensor  # bool [C]
    num_points: torch.Tensor  # i64 [C]
    dir_a: torch.Tensor  # [C, 3]
    tangent_a: torch.Tensor  # [C, S, 3]
    im_a: torch.Tensor  # [C, 3]
    im_b: torch.Tensor  # [C, 3]
    cfm_factor: torch.Tensor  # [C]
    limit: torch.Tensor  # [C]
    n_torque_a: torch.Tensor  # [C, P, 3]
    n_ii_torque_a: torch.Tensor
    n_torque_b: torch.Tensor
    n_ii_torque_b: torch.Tensor
    n_rhs: torch.Tensor  # [C, P]
    n_rhs_wo_bias: torch.Tensor  # [C, P]
    n_impulse: torch.Tensor  # [C, P]
    n_impulse_jacobi: torch.Tensor  # [C, P]
    n_r: torch.Tensor  # [C, P]
    t_torque_a: torch.Tensor  # [C, P, S, 3]
    t_ii_torque_a: torch.Tensor
    t_torque_b: torch.Tensor
    t_ii_torque_b: torch.Tensor
    t_rhs: torch.Tensor  # [C, P, S]
    t_rhs_wo_bias: torch.Tensor  # [C, P, S]
    t_impulse: torch.Tensor  # [C, P, S]
    t_impulse_jacobi: torch.Tensor  # [C, P, S]
    t_r: torch.Tensor  # [C, P, 3] (r0, r1, cross)
    local_pt_a: torch.Tensor  # [C, P, 3]
    local_pt_b: torch.Tensor  # [C, P, 3]
    info_dist: torch.Tensor  # [C, P]
    info_normal_vel: torch.Tensor  # [C, P]

    @property
    def dim(self) -> int:
        return self.dir_a.shape[-1]


def build_constraints(poses: Sim, vels: Velocity,
                      mprops: WorldMassProperties, contacts: Contacts,
                      params: SimParams) -> ContactConstraints:
    """Vectorized contact → constraint conversion; invalid slots produce
    zero-impact constraints (masked by ``valid``)."""
    p_max = contacts.points_a.shape[1]
    dim = contacts.normal_a.shape[-1]
    s_len = sub_len(dim)
    id1, id2 = contacts.body_a, contacts.body_b
    pose1, pose2 = poses.take(id1), poses.take(id2)
    lin1, lin2 = vels.linear[id1], vels.linear[id2]
    ang1, ang2 = vels.angular[id1], vels.angular[id2]
    im1, im2 = mprops.inv_mass[id1], mprops.inv_mass[id2]
    ii1, ii2 = mprops.inv_inertia[id1], mprops.inv_inertia[id2]
    com1, com2 = mprops.com[id1], mprops.com[id2]

    force_dir1 = -sim_ops.mul_unit_vec(pose1, contacts.normal_a)
    tangents1 = tangent_directions(force_dir1, lin1, lin2)
    inv_dt = params.inv_dt
    imsum = im1 + im2

    n_tq_a, n_iitq_a, n_tq_b, n_iitq_b, n_rhs, n_r = [], [], [], [], [], []
    t_tq_a, t_iitq_a, t_tq_b, t_iitq_b, t_r = [], [], [], [], []
    lpa, lpb, i_dist = [], [], []
    for k in range(p_max):
        pt_local = (contacts.points_a[:, k]
                    + contacts.normal_a * contacts.dist[:, k:k + 1] / 2.0)
        pt = sim_ops.mul_pt(pose1, pt_local)
        dp1 = pt - com1
        dp2 = pt - com2
        cvel1 = lin1 + gcross_av(ang1, dp1)
        cvel2 = lin2 + gcross_av(ang2, dp2)
        td1 = gcross(dp1, force_dir1)
        td2 = gcross(dp2, -force_dir1)
        iitd1 = ii_mul(ii1, td1)
        iitd2 = ii_mul(ii2, td2)
        proj_mass = safe_inv(
            torch.sum(force_dir1 * (imsum * force_dir1), dim=-1)
            + gdot(iitd1, td1) + gdot(iitd2, td2))
        dist = contacts.dist[:, k]
        rhs_wo_bias = (params.restitution
                       * torch.sum((cvel1 - cvel2) * force_dir1, dim=-1)
                       + torch.clamp(dist, min=0.0) * inv_dt)
        n_tq_a.append(td1)
        n_iitq_a.append(iitd1)
        n_tq_b.append(td2)
        n_iitq_b.append(iitd2)
        n_rhs.append(rhs_wo_bias)
        n_r.append(proj_mass)

        tq_a_j, iitq_a_j, tq_b_j, iitq_b_j, r_j = [], [], [], [], []
        for j in range(s_len):
            tj = tangents1[:, j]
            ttd1 = gcross(dp1, tj)
            ttd2 = gcross(dp2, -tj)
            tiitd1 = ii_mul(ii1, ttd1)
            tiitd2 = ii_mul(ii2, ttd2)
            r = (torch.sum(tj * (imsum * tj), dim=-1)
                 + gdot(tiitd1, ttd1) + gdot(tiitd2, ttd2))
            r_j.append(safe_inv(r) if dim == 2 else r)
            tq_a_j.append(ttd1)
            iitq_a_j.append(tiitd1)
            tq_b_j.append(ttd2)
            iitq_b_j.append(tiitd2)
        if dim == 3:
            r_cross = 2.0 * (torch.sum(tq_a_j[0] * iitq_a_j[1], dim=-1)
                             + torch.sum(tq_b_j[0] * iitq_b_j[1], dim=-1))
            t_r.append(torch.stack(r_j + [r_cross], dim=-1))
        else:
            t_r.append(torch.stack(r_j, dim=-1))
        t_tq_a.append(torch.stack(tq_a_j, dim=1))
        t_iitq_a.append(torch.stack(iitq_a_j, dim=1))
        t_tq_b.append(torch.stack(tq_b_j, dim=1))
        t_iitq_b.append(torch.stack(iitq_b_j, dim=1))
        lpa.append(sim_ops.inv_mul_pt(pose1, pt))
        lpb.append(sim_ops.inv_mul_pt(pose2, pt))
        i_dist.append(dist)

    def stk(xs):
        return torch.stack(xs, dim=1)

    c = contacts.capacity
    dev = id1.device
    zeros_ps = torch.zeros((c, p_max, s_len), device=dev)
    zeros_p = torch.zeros((c, p_max), device=dev)
    n_rhs_t = stk(n_rhs)
    return ContactConstraints(
        body_a=id1, body_b=id2, valid=contacts.valid,
        num_points=contacts.num_points, dir_a=force_dir1,
        tangent_a=tangents1, im_a=im1, im_b=im2,
        cfm_factor=torch.full((c,), params.contact_cfm_factor, device=dev),
        limit=torch.full((c,), params.friction, device=dev),
        n_torque_a=stk(n_tq_a), n_ii_torque_a=stk(n_iitq_a),
        n_torque_b=stk(n_tq_b), n_ii_torque_b=stk(n_iitq_b),
        n_rhs=n_rhs_t, n_rhs_wo_bias=n_rhs_t,
        n_impulse=zeros_p, n_impulse_jacobi=zeros_p.clone(),
        n_r=stk(n_r),
        t_torque_a=stk(t_tq_a), t_ii_torque_a=stk(t_iitq_a),
        t_torque_b=stk(t_tq_b), t_ii_torque_b=stk(t_iitq_b),
        t_rhs=zeros_ps, t_rhs_wo_bias=zeros_ps.clone(),
        t_impulse=zeros_ps.clone(), t_impulse_jacobi=zeros_ps.clone(),
        t_r=stk(t_r), local_pt_a=stk(lpa), local_pt_b=stk(lpb),
        info_dist=stk(i_dist), info_normal_vel=n_rhs_t.clone())


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product over a last axis of 3 (or 2), summed left to right. A
    ``torch.sum`` reduction may add in another order on the card; this one
    is the order of the impulse kernels' ``dot3``, so the rhs built here
    and the rhs rebuilt in kernel agree bit for bit. The products are one
    operation, then two adds: three kernels."""
    p = a * b
    if p.shape[-1] == 2:
        return p[..., 0] + p[..., 1]
    return p[..., 0] + p[..., 1] + p[..., 2]


def update_rhs_sorted(ss, poses: Sim, params: SimParams):
    """Substep rhs relinearization over colour-sorted field views (a
    namespace with body_a/b, dir_a, tangent_a, local_pt_a/b, info_dist,
    info_normal_vel, t_rhs_wo_bias): both anchors carried to the world by
    the substep's poses, their drift projected on the normal and the
    friction basis. Every operation is in the order of the in-kernel
    rebuild (``csrc/gs_math.cu``), so the ladder and the rhs-in-rung sweep
    see the same bits. Returns ``(n_rhs, n_rhs_wo_bias, t_rhs)``."""
    c = ss.body_a.shape[0]
    rw, dim = poses.rotation.shape[-1], poses.translation.shape[-1]
    # one gather of [rot | trans | scale] rows for both sides
    packed = torch.cat([poses.rotation, poses.translation,
                        poses.scale[:, None]], dim=-1)
    pp = packed[torch.cat([ss.body_a, ss.body_b])]
    pose1 = Sim(pp[:c, None, :rw], pp[:c, None, rw:rw + dim],
                pp[:c, None, rw + dim])
    pose2 = Sim(pp[c:, None, :rw], pp[c:, None, rw:rw + dim],
                pp[c:, None, rw + dim])
    inv_dt = params.inv_dt
    p1 = sim_ops.mul_pt(pose1, ss.local_pt_a)
    p2 = sim_ops.mul_pt(pose2, ss.local_pt_b)
    drift = p1 - p2  # [C, P, dim]
    dist = ss.info_dist + _dot3(drift, ss.dir_a[:, None, :])
    rhs_wo_bias = ss.info_normal_vel + torch.clamp(dist, min=0.0) * inv_dt
    rhs_bias = torch.clamp((dist + params.allowed_linear_error)
                           * params.contact_erp_inv_dt,
                           -params.max_corrective_velocity, 0.0)
    t_bias = _dot3(drift[:, :, None, :], ss.tangent_a[:, None, :, :]) * inv_dt
    return rhs_wo_bias + rhs_bias, rhs_wo_bias, ss.t_rhs_wo_bias + t_bias


def update_constraints(cons: ContactConstraints, poses: Sim,
                       params: SimParams) -> ContactConstraints:
    """Substep relinearization of the unsorted constraints (the Jacobi
    solve): the rhs of :func:`update_rhs_sorted`, the impulses scaled by
    the warmstart coefficient, the substep's cfm."""
    n_rhs, n_rhs_wo_bias, t_rhs = update_rhs_sorted(cons, poses, params)
    ws = params.warmstart_coefficient
    return dataclasses.replace(
        cons, n_rhs=n_rhs, n_rhs_wo_bias=n_rhs_wo_bias, t_rhs=t_rhs,
        n_impulse=cons.n_impulse * ws,
        n_impulse_jacobi=cons.n_impulse_jacobi * ws,
        t_impulse=cons.t_impulse * ws,
        t_impulse_jacobi=cons.t_impulse_jacobi * ws,
        cfm_factor=torch.full_like(cons.cfm_factor,
                                   params.contact_cfm_factor))


def remove_cfm_and_bias(cons: ContactConstraints) -> ContactConstraints:
    """The constraints of the unbiased sweep: rhs without bias, cfm 1."""
    return dataclasses.replace(
        cons, n_rhs=cons.n_rhs_wo_bias, t_rhs=cons.t_rhs_wo_bias,
        cfm_factor=torch.ones_like(cons.cfm_factor))


@functools.lru_cache(maxsize=8)
def _static_slots(windows: tuple, device: torch.device):
    """(colour, rank) of every slot of the rung-padded layout: slot s of
    colour k lies at ``sum(windows[:k]) + rank``."""
    col = np.repeat(np.arange(len(windows)), windows)
    rank = np.concatenate([np.arange(w) for w in windows] or [[]])
    return (torch.as_tensor(col, dtype=torch.int64, device=device),
            torch.as_tensor(rank, dtype=torch.int64, device=device))


def compact_contacts(contacts: Contacts, capacity: int, extra=None,
                     sort_by_extra: bool = False, static_windows=None):
    """Compact valid manifolds into a ``capacity``-sized buffer; every
    solver pass then costs the live contact count, not the pair count.
    Returns ``(contacts, true_count)``; a count above ``capacity`` is the
    overflow signal.

    ``extra``: per-slot integers compacted alongside (the cached pair
    colours); returned third. ``sort_by_extra`` orders the buffer by
    ascending ``extra``, slot order within equal values: with colours the
    buffer comes out colour-major and the solver needs no sort of its own.

    ``static_windows`` (requires ``sort_by_extra``): the fused solver's
    rung-padded layout. Colour k lands at the static offset
    ``sum(static_windows[:k])``, padded to ``static_windows[k]`` rows;
    ``capacity`` is ignored, entries past a colour's rung are dropped, and
    the TRUE per-class counts come back as a fourth value (the host regrows
    the rung from them)."""
    c = contacts.capacity
    dev = contacts.body_a.device
    flags = contacts.valid
    count = flags.sum()
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    if sort_by_extra:
        assert extra is not None and c < (1 << 24)
        # one sort compacts and orders: key = (colour << 24) | slot for
        # valid entries (unique), one shared maximum for the rest; stable,
        # so invalid slots follow in slot order as in the JAX sort
        idx = torch.arange(c, device=dev)
        key = torch.where(flags, (torch.clamp(extra, 0, 127) << 24) | idx,
                          torch.full_like(idx, 0x7FFFFFFF))
        skey, take = torch.sort(key, stable=True)
        if static_windows is not None:
            windows = tuple(int(w) for w in static_windows)
            n_classes = len(windows)
            capacity = sum(windows)
            cls = torch.where(flags, torch.clamp(extra, 0, n_classes - 1),
                              torch.full_like(extra, n_classes))
            class_counts = torch.bincount(
                cls, minlength=n_classes + 1)[:n_classes]
            cum = torch.cat([zero[None], torch.cumsum(class_counts, 0)])
            col_of_slot, j_of_slot = _static_slots(windows, dev)
            # slot j of colour k takes sorted position cum[k] + j (clamped
            # into the buffer as the JAX package clamps it)
            valid_out = j_of_slot < (cum[col_of_slot + 1] - cum[col_of_slot])
            take = take[torch.clamp(cum[col_of_slot] + j_of_slot, max=c - 1)]
        else:
            skey, take = skey[:capacity], take[:capacity]
            valid_out = torch.arange(capacity, device=dev) < torch.clamp(
                count, max=capacity)
        # one wide row gather for every float field
        p_shape = contacts.points_a.shape[1:]
        big = torch.cat([contacts.normal_a, contacts.points_a.reshape(c, -1),
                         contacts.dist], dim=1)[take]
        w0 = contacts.normal_a.shape[1]
        w1 = w0 + contacts.points_a[0].numel()
        out = Contacts(
            body_a=torch.where(valid_out, contacts.body_a[take], zero),
            body_b=torch.where(valid_out, contacts.body_b[take], zero),
            normal_a=big[:, :w0],
            points_a=big[:, w0:w1].reshape((capacity,) + tuple(p_shape)),
            dist=torch.where(valid_out[:, None], big[:, w1:],
                             torch.full((), 1e9, device=dev)),
            num_points=torch.where(valid_out, contacts.num_points[take],
                                   zero),
            valid=valid_out)
        if static_windows is not None:
            colors_out = torch.where(valid_out, col_of_slot, zero)
            return out, count, colors_out, class_counts
        colors_out = torch.where(valid_out, (skey >> 24) & 0x7F, zero)
        return out, count, colors_out

    valid_out = torch.arange(capacity, device=dev) < torch.clamp(
        count, max=capacity)
    pos = torch.cumsum(flags.to(torch.int64), 0) - 1
    slot = torch.where(flags & (pos < capacity), pos,
                       torch.full_like(pos, capacity))

    def scatter(x, fill=0):
        # row `capacity` takes every dropped entry and is cut off; the
        # kept rows are written once each
        base = torch.full((capacity + 1,) + tuple(x.shape[1:]), fill,
                          dtype=x.dtype, device=dev)
        base[slot] = x
        return base[:capacity]

    out = Contacts(
        body_a=scatter(contacts.body_a), body_b=scatter(contacts.body_b),
        normal_a=scatter(contacts.normal_a),
        points_a=scatter(contacts.points_a),
        dist=scatter(contacts.dist, fill=1e9),
        num_points=scatter(contacts.num_points), valid=valid_out)
    if extra is not None:
        return out, count, scatter(extra)
    return out, count
