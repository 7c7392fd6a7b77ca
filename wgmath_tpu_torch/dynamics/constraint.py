"""Contact constraints: data layout and builder (counterpart of
``wgmath_tpu/dynamics/constraint.py``, 3D).

One structure of arrays over a fixed-capacity constraint buffer; a
``valid`` mask replaces a live count. Per-manifold points are a static
trailing axis P, friction directions a trailing axis S = 2.
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.dynamics.body import Velocity, WorldMassProperties
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.quat import cross, norm
from wgmath_tpu_torch.geometry.sim import Sim

S_LEN = 2  # friction directions per contact point (3D)


def ii_mul(inv_inertia: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    return torch.einsum("nij,nj->ni", inv_inertia, ang)


def orthonormal_vector(v: torch.Tensor) -> torch.Tensor:
    """A unit vector orthogonal to unit v (branch-free Duff et al.)."""
    sign = torch.where(v[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v[..., 2])
    b = v[..., 0] * v[..., 1] * a
    return torch.stack([b, sign + v[..., 1] ** 2 * a, -v[..., 1]], dim=-1)


def tangent_directions(force_dir, linvel1, linvel2) -> torch.Tensor:
    """[..., 2, 3] friction basis: the relative-velocity direction when it
    is large enough, else an arbitrary orthonormal vector."""
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


@dataclasses.dataclass
class Contacts:
    """Fixed-capacity contact manifolds; ``normal_a``/``points_a`` in body
    A's local frame, ``dist < 0`` = penetration (invalid slots hold 1e9)."""

    body_a: torch.Tensor  # i64 [C]
    body_b: torch.Tensor  # i64 [C]
    normal_a: torch.Tensor  # [C, 3]
    points_a: torch.Tensor  # [C, P, 3]
    dist: torch.Tensor  # [C, P]
    num_points: torch.Tensor  # i64 [C]
    valid: torch.Tensor  # bool [C]

    @property
    def capacity(self) -> int:
        return self.body_a.shape[0]


@dataclasses.dataclass
class ContactConstraints:
    """Two-body contact constraints; trailing axes P points, S directions."""

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


def build_constraints(poses: Sim, vels: Velocity,
                      mprops: WorldMassProperties, contacts: Contacts,
                      params: SimParams) -> ContactConstraints:
    """Vectorized contact → constraint conversion; invalid slots produce
    zero-impact constraints (masked by ``valid``)."""
    p_max = contacts.points_a.shape[1]
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
        cvel1 = lin1 + cross(ang1, dp1)
        cvel2 = lin2 + cross(ang2, dp2)
        td1 = cross(dp1, force_dir1)
        td2 = cross(dp2, -force_dir1)
        iitd1 = ii_mul(ii1, td1)
        iitd2 = ii_mul(ii2, td2)
        proj_mass = safe_inv(
            torch.sum(force_dir1 * (imsum * force_dir1), dim=-1)
            + torch.sum(iitd1 * td1, dim=-1)
            + torch.sum(iitd2 * td2, dim=-1))
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
        for j in range(S_LEN):
            tj = tangents1[:, j]
            ttd1 = cross(dp1, tj)
            ttd2 = cross(dp2, -tj)
            tiitd1 = ii_mul(ii1, ttd1)
            tiitd2 = ii_mul(ii2, ttd2)
            r_j.append(torch.sum(tj * (imsum * tj), dim=-1)
                       + torch.sum(tiitd1 * ttd1, dim=-1)
                       + torch.sum(tiitd2 * ttd2, dim=-1))
            tq_a_j.append(ttd1)
            iitq_a_j.append(tiitd1)
            tq_b_j.append(ttd2)
            iitq_b_j.append(tiitd2)
        r_cross = 2.0 * (torch.sum(tq_a_j[0] * iitq_a_j[1], dim=-1)
                         + torch.sum(tq_b_j[0] * iitq_b_j[1], dim=-1))
        t_r.append(torch.stack(r_j + [r_cross], dim=-1))
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
    zeros_ps = torch.zeros((c, p_max, S_LEN), device=dev)
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
