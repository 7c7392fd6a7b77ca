"""Impulse joints: generic 6-DoF (3-DoF in 2D) joints with locked,
limited, motorized and coupled axes (counterpart of
``wgmath_tpu/dynamics/joint.py``).

Every possible constraint element of a joint has a fixed slot, E = 18:
[angular motors | linear motors] (group 1, orthogonalized together) and
[angular locks | linear locks | angular limits | linear limits] (group 2),
with an ``active`` mask, in ``[J, 18, ...]`` tensors laid out as the JAX
package's. The joint graph is coloured greedily on the host when the set
is built (``native.greedy_color``); the solve walks the colours, and
within one colour no two joints share a dynamic body.

Axis bit order: bits 0..2 linear x/y/z, bits 3..5 angular x/y/z; in 2D
bits 0..1 linear, bit 2 angular, and E = 9 slots: [angular motor | linear
motors] (group 1) and [angular lock | linear locks | angular limit |
linear limits] (group 2), with scalar angular terms and no coupled axes
(the JAX package's ``_build_joint_constraints_2d``).

The JAX package computes every slot of every joint in XLA. Here the work
is eager PyTorch, one kernel an operation, so a :class:`JointSet` keeps two
host values that it computes from its own masks and colours when it is
made: ``max_color``, the highest colour of a valid joint, and ``slots``,
the slots any of its joints can activate (a spherical joint: the three
linear locks, 9-11). A set is a value: its tensors are not changed in
place, and a changed set is a new one (``dataclasses.replace``), which
computes them anew.
The build, the Gram-Schmidt and the pass touch only those slots: a slot
no joint activates keeps zeros and ±``MAX``, as the JAX package leaves it,
and every add it would make there is a zero. The Gram-Schmidt's inner loop
runs over all later slots of the group at once. So the same numbers come
out with no host sync. Every 3-term sum is taken left to right.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.dynamics.body import Velocity, WorldMassProperties
from wgmath_tpu_torch.dynamics.constraint import _dot3
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import quat, rot2
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.quat import cross
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.native import greedy_color

MAX = 1.0e20
ACCELERATION_BASED = 0
FORCE_BASED = 1

NUM_SLOTS_3D = 18
GROUP1_END = 6
NUM_SLOTS_2D = 9
GROUP1_END_2D = 3


def spatial_dim(dim: int) -> int:
    return 6 if dim == 3 else 3


def slot_groups(dim: int) -> tuple:
    """The two orthogonalization groups' slot ranges."""
    if dim == 3:
        return ((0, GROUP1_END), (GROUP1_END, NUM_SLOTS_3D))
    return ((0, GROUP1_END_2D), (GROUP1_END_2D, NUM_SLOTS_2D))


@dataclasses.dataclass
class JointSet:
    """Structure-of-arrays impulse joints. Integers are int64, masks bool;
    ``[J, S]`` tables have S = 6 axes. ``max_color`` and ``slots`` are the
    host values the solve reads (see the module's docstring), computed
    from the tensors when the set is made (one copy to the host). Every
    valid joint must have a colour of 1 or more: :func:`make_joint_set`
    colours them."""

    body_a: torch.Tensor  # [J]
    body_b: torch.Tensor  # [J]
    local_frame_a: Sim  # [J]
    local_frame_b: Sim  # [J]
    locked_axes: torch.Tensor  # [J] bitmask
    limit_axes: torch.Tensor
    motor_axes: torch.Tensor
    coupled_axes: torch.Tensor
    limit_min: torch.Tensor  # [J, S]
    limit_max: torch.Tensor
    motor_target_vel: torch.Tensor
    motor_target_pos: torch.Tensor
    motor_stiffness: torch.Tensor
    motor_damping: torch.Tensor
    motor_max_force: torch.Tensor
    motor_model: torch.Tensor  # [J, S] int
    valid: torch.Tensor  # [J] bool
    colors: torch.Tensor  # [J], 1-based, 0 for invalid joints
    max_color: int = dataclasses.field(init=False)
    slots: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        host = [x.cpu().numpy() for x in (
            self.locked_axes, self.limit_axes, self.motor_axes,
            self.coupled_axes, self.valid, self.colors)]
        valid, colors = host[4].astype(bool), host[5]
        if (colors[valid] < 1).any():
            raise ValueError("a valid joint has no colour (colour < 1): "
                             "colour the set, as make_joint_set does")
        self.max_color = int(colors[valid].max()) if valid.any() else 0
        slots_of = active_slots if self.dim == 3 else active_slots_2d
        self.slots = tuple(int(s) for s in np.flatnonzero(
            slots_of(*host[:4], valid).any(0)))

    @property
    def num_joints(self) -> int:
        return self.body_a.shape[0]

    @property
    def dim(self) -> int:
        return self.local_frame_a.translation.shape[-1]


# the JAX package's JointSet fields, in order (without the host values)
JOINT_FIELDS = tuple(f.name for f in dataclasses.fields(JointSet) if f.init)


def active_slots(locked, limit, motor, coupled, valid) -> np.ndarray:
    """``[J, 18]`` bool: which slots each joint's masks activate, from host
    arrays (the build's ``active``, which depends on the masks only)."""
    locked, limit, motor, coupled = (np.asarray(x, np.int64) for x in
                                     (locked, limit, motor, coupled))
    motor_mask = motor & ~locked
    limit_mask = limit & ~locked
    lin_c = coupled & 0b111
    ang_c = coupled & 0b111000
    fcl = np.where(lin_c & 1, 0, np.where(lin_c & 2, 1, 2))
    fca = np.where(ang_c & 0b001000, 0, np.where(ang_c & 0b010000, 1, 2))
    cols = []
    for i in range(3):  # angular motors
        cols.append((motor_mask & ~coupled & (1 << (3 + i))) != 0)
    for i in range(3):  # linear motors
        cols.append(((motor_mask & ~coupled & (1 << i)) != 0)
                    | ((lin_c != 0) & (fcl == i)
                       & ((motor_mask & coupled & 0b111) != 0)))
    for i in range(3):  # angular locks
        cols.append((locked & (1 << (3 + i))) != 0)
    for i in range(3):  # linear locks
        cols.append((locked & (1 << i)) != 0)
    for i in range(3):  # angular limits
        cols.append(((limit_mask & ~coupled & (1 << (3 + i))) != 0)
                    | ((ang_c != 0) & (fca == i)
                       & ((limit_mask & ang_c) != 0)))
    for i in range(3):  # linear limits
        cols.append(((limit_mask & ~coupled & (1 << i)) != 0)
                    | ((lin_c != 0) & (fcl == i)
                       & ((limit_mask & coupled & 0b111) != 0)))
    return np.stack(cols, -1) & np.asarray(valid, bool)[:, None]


def active_slots_2d(locked, limit, motor, coupled, valid) -> np.ndarray:
    """``[J, 9]`` bool: :func:`active_slots` for 2D joints (coupled axes
    play no part there)."""
    locked, limit, motor = (np.asarray(x, np.int64) for x in
                            (locked, limit, motor))
    motor_mask = motor & ~locked
    limit_mask = limit & ~locked
    cols = [(motor_mask & 4) != 0, (motor_mask & 1) != 0,
            (motor_mask & 2) != 0, (locked & 4) != 0, (locked & 1) != 0,
            (locked & 2) != 0, (limit_mask & 4) != 0, (limit_mask & 1) != 0,
            (limit_mask & 2) != 0]
    return np.stack(cols, -1) & np.asarray(valid, bool)[:, None]


def make_joint_set(body_a, body_b, local_frame_a: Sim, local_frame_b: Sim,
                   *, locked_axes, limit_axes=None, motor_axes=None,
                   coupled_axes=None, limit_min=None, limit_max=None,
                   motor_target_vel=None, motor_target_pos=None,
                   motor_stiffness=None, motor_damping=None,
                   motor_max_force=None, motor_model=None,
                   dynamic_mask=None) -> JointSet:
    """A joint set on the device of ``local_frame_a``, its colours from
    ``native.greedy_color`` (``dynamic_mask``: the bodies' dynamic flags;
    default every body up to the largest index dynamic)."""
    dim = local_frame_a.translation.shape[-1]
    dev = local_frame_a.translation.device
    body_a = np.asarray(body_a, np.int64)
    body_b = np.asarray(body_b, np.int64)
    j = len(body_a)
    s = spatial_dim(dim)

    def host(x, default, shape, dtype):
        if x is None:
            return np.full(shape, default, dtype)
        if isinstance(x, torch.Tensor):
            x = x.cpu().numpy()
        return np.asarray(x).astype(dtype)

    masks = [host(x, 0, (j,), np.int64) for x in
             (locked_axes, limit_axes, motor_axes, coupled_axes)]
    valid = np.ones(j, bool)
    dyn = (np.ones(int(max(body_a.max(), body_b.max())) + 1, bool)
           if dynamic_mask is None else
           np.asarray(dynamic_mask.cpu() if isinstance(
               dynamic_mask, torch.Tensor) else dynamic_mask))
    colors = greedy_color(body_a, body_b, dyn, valid).astype(np.int64)
    tables = [host(x, d, (j, s), np.float32) for x, d in (
        (limit_min, -MAX), (limit_max, MAX), (motor_target_vel, 0.0),
        (motor_target_pos, 0.0), (motor_stiffness, 0.0),
        (motor_damping, 0.0), (motor_max_force, MAX))]
    model = host(motor_model, ACCELERATION_BASED, (j, s), np.int64)

    def t(x):
        return torch.from_numpy(x).to(dev)

    return JointSet(t(body_a), t(body_b), local_frame_a, local_frame_b,
                    *(t(m) for m in masks), *(t(x) for x in tables),
                    t(model), t(valid), t(colors))


# -- joint type constructors (the reference's typed joint builders) ---------


def _frames_at_anchor(n: int, anchors_a, anchors_b, axes=None, dim=3,
                      device=None):
    """The ``n`` joints' frames at their anchors: identity rotations, or
    the rotation taking +x onto each of ``axes`` (in 2D the normalized
    axis is that rotation's (cos, sin))."""
    dev = resolve_device(device)
    if dim == 2:
        if axes is None:
            rot = torch.tensor([1.0, 0.0], device=dev).repeat(n, 1)
        else:
            ax = torch.as_tensor(np.asarray(axes, np.float32), device=dev)
            rot = ax / torch.linalg.norm(ax, dim=-1, keepdim=True)
    elif axes is None:
        rot = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(n, 1)
    else:
        rot = _quat_from_x_axis(torch.as_tensor(
            np.asarray(axes, np.float32), device=dev))

    def frame(anchors):
        return Sim(rot, torch.as_tensor(np.asarray(anchors, np.float32),
                                        device=dev),
                   torch.ones(n, device=dev))

    return frame(anchors_a), frame(anchors_b)


def _quat_from_x_axis(axis: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating +x onto ``axis`` (unit)."""
    x = torch.zeros_like(axis)
    x[..., 0] = 1.0
    d = quat.dot(x, axis)
    c = cross(x, axis)
    w = 1.0 + d
    q = torch.cat([c, w[..., None]], dim=-1)
    # antiparallel: 180 degrees about y
    flip = torch.tensor([0.0, 1.0, 0.0, 0.0], device=axis.device)
    q = torch.where((w < 1e-6)[..., None], flip, q)
    return quat.normalize(q)


def _limits(n: int, s: int, axis: int, lo: float, hi: float) -> dict:
    lmin = np.full((n, s), -MAX, np.float32)
    lmax = np.full((n, s), MAX, np.float32)
    lmin[:, axis] = lo
    lmax[:, axis] = hi
    return {"limit_axes": np.full(n, 1 << axis, np.int64),
            "limit_min": lmin, "limit_max": lmax}


def fixed_joints(body_a, body_b, anchors_a, anchors_b, *, dim=3,
                 dynamic_mask=None, device=None) -> JointSet:
    """Every axis locked (a fixed joint). ``device`` None means the
    card."""
    n = len(body_a)
    fa, fb = _frames_at_anchor(n, anchors_a, anchors_b,
                               dim=dim, device=device)
    mask = (1 << spatial_dim(dim)) - 1
    return make_joint_set(body_a, body_b, fa, fb,
                          locked_axes=np.full(n, mask, np.int64),
                          dynamic_mask=dynamic_mask)


def spherical_joints(body_a, body_b, anchors_a, anchors_b, *,
                     swing_limit=None, dynamic_mask=None,
                     device=None) -> JointSet:
    """Ball and socket: the linear axes locked, rotation free.
    ``swing_limit``: an optional cone half-angle (radians) about the joint
    frame's +x, a coupled angular limit over the y / z angular axes."""
    n = len(body_a)
    fa, fb = _frames_at_anchor(n, anchors_a, anchors_b,
                               device=device)
    kw = {}
    if swing_limit is not None:
        kw = _limits(n, 6, 4, -swing_limit, swing_limit)
        kw["coupled_axes"] = np.full(n, 0b110000, np.int64)
    return make_joint_set(body_a, body_b, fa, fb,
                          locked_axes=np.full(n, 0b000111, np.int64),
                          dynamic_mask=dynamic_mask, **kw)


def revolute_joints(body_a, body_b, anchors_a, anchors_b, axes=None, *,
                    limits=None, motor_vel=None, motor_damping: float = 1.0,
                    dim=3, dynamic_mask=None, device=None) -> JointSet:
    """A hinge about ``axes`` (the joint frame's +x): every axis locked but
    angular x. Optional rotation ``limits`` (min, max) and a velocity motor
    (``motor_vel``, acceleration-based with ``motor_damping``). In 2D the
    hinge is out of the plane (no ``axes``): the linear axes locked, the
    one angular axis free."""
    n = len(body_a)
    s = spatial_dim(dim)
    free = 3 if dim == 3 else 2  # the free angular axis
    if dim == 3 and axes is None:
        raise ValueError("3D revolute joints need hinge axes")
    fa, fb = _frames_at_anchor(n, anchors_a, anchors_b,
                               axes=axes if dim == 3 else None, dim=dim,
                               device=device)
    kw = {} if limits is None else _limits(n, s, free, *limits)
    if motor_vel is not None:
        tv = np.zeros((n, s), np.float32)
        tv[:, free] = motor_vel
        damp = np.zeros((n, s), np.float32)
        damp[:, free] = motor_damping
        kw.update(motor_axes=np.full(n, 1 << free, np.int64),
                  motor_target_vel=tv, motor_damping=damp)
    locked = 0b110111 if dim == 3 else 0b011
    return make_joint_set(body_a, body_b, fa, fb,
                          locked_axes=np.full(n, locked, np.int64),
                          dynamic_mask=dynamic_mask, **kw)


def prismatic_joints(body_a, body_b, anchors_a, anchors_b, axes, *,
                     limits=None, dim=3, dynamic_mask=None,
                     device=None) -> JointSet:
    """A slider along ``axes``: every axis locked but linear x."""
    n = len(body_a)
    s = spatial_dim(dim)
    fa, fb = _frames_at_anchor(n, anchors_a, anchors_b,
                               axes=axes, dim=dim, device=device)
    kw = {} if limits is None else _limits(n, s, 0, *limits)
    return make_joint_set(body_a, body_b, fa, fb,
                          locked_axes=np.full(n, ((1 << s) - 1) & ~1,
                                              np.int64),
                          dynamic_mask=dynamic_mask, **kw)


# ---------------------------------------------------------------------------
# Constraint building. Fixed slot layout (E = 18):
#   group 1: slots 0..2 angular motors (axes 3..5), 3..5 linear motors
#            (axes 0..2; a coupled linear motor takes the slot of the first
#            coupled axis)
#   group 2: slots 6..8 angular locks, 9..11 linear locks, 12..14 angular
#            limits, 15..17 linear limits (a coupled limit takes the slot
#            of its first coupled axis)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class JointConstraints:
    """Each joint's constraint elements in their fixed slots. ``slots`` and
    ``max_color`` are the host values of the set they were built from."""

    body_a: torch.Tensor  # [J]
    body_b: torch.Tensor
    im_a: torch.Tensor  # [J, dim]
    im_b: torch.Tensor
    active: torch.Tensor  # [J, E] bool
    lin_jac: torch.Tensor  # [J, E, dim]
    ang_jac_a: torch.Tensor  # [J, E, 3] (3D) or [J, E] (2D)
    ang_jac_b: torch.Tensor
    ii_ang_jac_a: torch.Tensor
    ii_ang_jac_b: torch.Tensor
    inv_lhs: torch.Tensor  # [J, E]
    rhs: torch.Tensor
    rhs_wo_bias: torch.Tensor
    cfm_gain: torch.Tensor
    cfm_coeff: torch.Tensor
    bounds_min: torch.Tensor
    bounds_max: torch.Tensor
    impulse: torch.Tensor
    valid: torch.Tensor  # [J] bool
    slots: tuple
    max_color: int


def _motor_params(jset: JointSet, axis: int, dt: float) -> dict:
    stiff = jset.motor_stiffness[:, axis]
    damp = jset.motor_damping[:, axis]
    denom_e = dt * stiff + damp
    erp_inv_dt = stiff * _pseudo_inv(denom_e)
    denom_c = dt * dt * stiff + dt * damp
    inv_c = _pseudo_inv(denom_c)
    accel = jset.motor_model[:, axis] == ACCELERATION_BASED
    zero = torch.zeros_like(inv_c)
    return {"erp_inv_dt": erp_inv_dt,
            "cfm_coeff": torch.where(accel, inv_c, zero),
            "cfm_gain": torch.where(accel, zero, inv_c),
            "target_pos": jset.motor_target_pos[:, axis],
            "target_vel": jset.motor_target_vel[:, axis],
            "max_impulse": jset.motor_max_force[:, axis] * dt}


def _smallest_angle_diff(a, b):
    s_err = a - b
    comp = s_err - torch.sign(s_err) * 2.0 * math.pi
    return torch.where(torch.abs(s_err) < torch.abs(comp), s_err, comp)


def _pseudo_inv(x):
    zero = x == 0.0
    return torch.where(zero, torch.zeros_like(x),
                       1.0 / torch.where(zero, torch.ones_like(x), x))


def _cross_mat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _matmul3(a, b):
    """``[..., 3, 3]`` product with each entry summed left to right."""
    return (a[..., :, 0:1] * b[..., 0:1, :] + a[..., :, 1:2] * b[..., 1:2, :]
            + a[..., :, 2:3] * b[..., 2:3, :])


def _diff_conj1_2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """0.5·(v1 v2ᵀ + w1 w2 I − [v1 w2 + v2 w1]× + [v1]× [v2]×)."""
    v1, w1 = a[..., :3], a[..., 3]
    v2, w2 = b[..., :3], b[..., 3]
    outer = v1[..., :, None] * v2[..., None, :]
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    return 0.5 * (outer + (w1 * w2)[..., None, None] * eye
                  - _cross_mat(v1 * w2[..., None] + v2 * w1[..., None])
                  + _matmul3(_cross_mat(v1), _cross_mat(v2)))


def _ii_mul(ii: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """``ii @ ang`` per slot: [J, 3, 3] x [J, E, 3] -> [J, E, 3], each
    entry summed left to right."""
    return (ii[:, None, :, 0] * ang[..., 0:1] + ii[:, None, :, 1]
            * ang[..., 1:2] + ii[:, None, :, 2] * ang[..., 2:3])


def build_joint_constraints(jset: JointSet, poses: Sim,
                            mprops: WorldMassProperties,
                            params: SimParams) -> JointConstraints:
    """The joints' constraint elements for this substep: ``poses`` are the
    substep's, ``mprops`` the frame's world mass properties, ``params`` the
    substep's parameters. Then :func:`_orthogonalize`."""
    if jset.dim == 2:
        return _build_joint_constraints_2d(jset, poses, mprops, params)
    j, e = jset.num_joints, NUM_SLOTS_3D
    dev = poses.translation.device
    slots = set(jset.slots)
    ba, bb = jset.body_a, jset.body_b
    frame1 = sim_ops.mul(poses.take(ba), jset.local_frame_a)
    frame2 = sim_ops.mul(poses.take(bb), jset.local_frame_b)
    com1, com2 = mprops.com[ba], mprops.com[bb]
    im1, im2 = mprops.inv_mass[ba], mprops.inv_mass[bb]
    ii1, ii2 = mprops.inv_inertia[ba], mprops.inv_inertia[bb]

    q1, q2 = frame1.rotation, frame2.rotation
    basis = quat.to_matrix(q1)  # columns: the joint axes in the world
    lin_err = frame2.translation - frame1.translation

    # snap the anchor along the locked linear axes
    locked = jset.locked_axes
    zero = torch.zeros((), device=dev)
    t1 = frame2.translation
    for i in range(3):
        axis = basis[..., :, i]
        has = (locked & (1 << i)) != 0
        t1 = t1 - torch.where(has[:, None],
                              axis * _dot3(axis, lin_err)[:, None], zero)
    r1 = t1 - com1
    r2 = frame2.translation - com2

    def cr(r, m):  # r x (each column of m)
        return torch.stack([cross(r, m[..., :, i]) for i in range(3)], -1)

    cmat1_basis = cr(r1, basis)
    cmat2_basis = cr(r2, basis)
    sgn = torch.where(quat.dot(q1, q2) > 0.0, 1.0, -1.0)
    ang_basis = (_diff_conj1_2(q1, q2).transpose(-1, -2)
                 * sgn[:, None, None])
    ang_err = quat.mul(quat.inv(q1), q2) * sgn[:, None]

    erp_inv_dt = params.joint_erp_inv_dt
    cfm_coeff_j = torch.full((j,), params.joint_cfm_coeff, device=dev)
    inv_dt = params.inv_dt
    zeros = torch.zeros(j, device=dev)
    zeros3 = torch.zeros((j, 3), device=dev)
    neg_max = torch.full((j,), -MAX, device=dev)
    pos_max = torch.full((j,), MAX, device=dev)
    no = torch.zeros(j, dtype=torch.bool, device=dev)
    cols = {k: [default] * e for k, default in (
        ("active", no), ("lin", zeros3), ("aa", zeros3), ("ab", zeros3),
        ("rhs", zeros), ("rhs_wo", zeros), ("cfm_c", zeros),
        ("cfm_g", zeros), ("bmin", neg_max), ("bmax", pos_max))}

    def put(slot, act, lj, aa, ab, r, rw, cc, cg, lo, hi):
        for k, v, off in (("lin", lj, zero), ("aa", aa, zero),
                          ("ab", ab, zero)):
            cols[k][slot] = torch.where(act[:, None], v, off)
        for k, v, off in (("rhs", r, zero), ("rhs_wo", rw, zero),
                          ("cfm_c", cc, zero), ("cfm_g", cg, zero),
                          ("bmin", lo, -MAX), ("bmax", hi, MAX)):
            cols[k][slot] = torch.where(act, v, off)
        cols["active"][slot] = act

    motor_mask = jset.motor_axes & ~locked
    limit_mask = jset.limit_axes & ~locked
    coupled = jset.coupled_axes
    lin_coupled_mask = coupled & 0b111
    has_lin_coupling = lin_coupled_mask != 0
    # the first coupled linear axis
    fcl = torch.where((lin_coupled_mask & 1) != 0, 0,
                      torch.where((lin_coupled_mask & 2) != 0, 1, 2))

    def coupled_linear():
        """The unit direction of the linear error within the coupled
        linear axes, its jacobians and its length."""
        lj_c = aa_c = ab_c = zeros3
        for k in range(3):
            sel = ((coupled & (1 << k)) != 0)[:, None]
            coeff = _dot3(basis[..., :, k], lin_err)[:, None]
            lj_c = lj_c + torch.where(sel, basis[..., :, k] * coeff, zero)
            aa_c = aa_c + torch.where(sel, cmat1_basis[..., :, k] * coeff,
                                      zero)
            ab_c = ab_c + torch.where(sel, cmat2_basis[..., :, k] * coeff,
                                      zero)
        dist_c = torch.sqrt(_dot3(lj_c, lj_c))
        inv_d = _pseudo_inv(dist_c)[:, None]
        return lj_c * inv_d, aa_c * inv_d, ab_c * inv_d, dist_c

    # ---- group 1: motors ----------------------------------------------------
    for i in range(3):  # angular motors (axes 3+i) -> slots 0..2
        if i not in slots:
            continue
        act = ((motor_mask & ~coupled) & (1 << (3 + i))) != 0
        mp = _motor_params(jset, 3 + i, params.dt)
        aj = basis[..., :, i]
        ang_dist = torch.arcsin(torch.clamp(ang_err[:, i], -1.0, 1.0)) * 2.0
        r_wo = (_smallest_angle_diff(ang_dist, mp["target_pos"])
                * mp["erp_inv_dt"]) - mp["target_vel"]
        put(i, act, zeros3, aj, aj, r_wo, r_wo, mp["cfm_coeff"],
            mp["cfm_gain"], -mp["max_impulse"], mp["max_impulse"])

    for i in range(3):  # linear motors (axes i) -> slots 3..5
        if 3 + i not in slots:
            continue
        bit = 1 << i
        per_axis = ((motor_mask & ~coupled) & bit) != 0
        use_c = has_lin_coupling & (fcl == i) & (
            ((motor_mask & coupled) & 0b111) != 0)
        mp = _motor_params(jset, i, params.dt)
        lj_axis = basis[..., :, i]
        lj_c, aa_c, ab_c, dist_c = coupled_linear()
        u = use_c[:, None]
        lj = torch.where(u, lj_c, lj_axis)
        aa = torch.where(u, aa_c, cmat1_basis[..., :, i])
        ab = torch.where(u, ab_c, cmat2_basis[..., :, i])
        dist = torch.where(use_c, dist_c, _dot3(lin_err, lj_axis))
        has_lim = (limit_mask & bit) != 0
        lo_l = torch.where(has_lim, jset.limit_min[:, i], neg_max)
        hi_l = torch.where(has_lim, jset.limit_max[:, i], pos_max)
        target_vel = torch.where(
            has_lim,
            torch.clamp(mp["target_vel"], (lo_l - dist) * inv_dt,
                        (hi_l - dist) * inv_dt),
            mp["target_vel"])
        r_wo = (dist - mp["target_pos"]) * mp["erp_inv_dt"] - target_vel
        put(3 + i, per_axis | use_c, lj, aa, ab, r_wo, r_wo,
            mp["cfm_coeff"], mp["cfm_gain"], -mp["max_impulse"],
            mp["max_impulse"])

    # ---- group 2: locks -----------------------------------------------------
    for i in range(3):  # angular locks -> slots 6..8
        if 6 + i not in slots:
            continue
        act = (locked & (1 << (3 + i))) != 0
        aj = ang_basis[..., :, i]
        put(6 + i, act, zeros3, aj, aj, ang_err[:, i] * erp_inv_dt, zeros,
            cfm_coeff_j, zeros, neg_max, pos_max)

    for i in range(3):  # linear locks -> slots 9..11
        if 9 + i not in slots:
            continue
        act = (locked & (1 << i)) != 0
        lj = basis[..., :, i]
        put(9 + i, act, lj, cmat1_basis[..., :, i], cmat2_basis[..., :, i],
            _dot3(lj, lin_err) * erp_inv_dt, zeros, cfm_coeff_j, zeros,
            neg_max, pos_max)

    ang_coupled_mask = coupled & 0b111000
    has_ang_coupling = ang_coupled_mask != 0
    fca = torch.where((ang_coupled_mask & 0b001000) != 0, 0,
                      torch.where((ang_coupled_mask & 0b010000) != 0, 1, 2))

    for i in range(3):  # angular limits -> slots 12..14
        if 12 + i not in slots:
            continue
        per_axis = ((limit_mask & ~coupled) & (1 << (3 + i))) != 0
        use_c = has_ang_coupling & (fca == i) & (
            (limit_mask & ang_coupled_mask) != 0)
        s_min = torch.sin(jset.limit_min[:, 3 + i] * 0.5)
        s_max = torch.sin(jset.limit_max[:, 3 + i] * 0.5)
        s_ang = ang_err[:, i]
        min_en = s_ang <= s_min
        max_en = s_max <= s_ang
        r_bias_axis = (torch.clamp(s_ang - s_max, min=0.0)
                       - torch.clamp(s_min - s_ang, min=0.0)) * erp_inv_dt
        # the coupled (swing cone) limit, max side only: the joint-space
        # error within the coupled angular axes, the jacobian along it
        aj_c = zeros3
        s2_c = zeros
        for k in range(3):
            sel = (coupled & (1 << (3 + k))) != 0
            comp = torch.where(sel, ang_err[:, k], zero)
            aj_c = aj_c + ang_basis[..., :, k] * comp[:, None]
            s2_c = s2_c + comp * comp
        s_c = torch.sqrt(s2_c)
        aj_c = aj_c * _pseudo_inv(s_c)[:, None]
        r_wo_c = torch.clamp(s_c - s_max, max=0.0) * inv_dt
        r_bias_c = r_wo_c + torch.clamp(s_c - s_max, min=0.0) * erp_inv_dt
        aj = torch.where(use_c[:, None], aj_c, ang_basis[..., :, i])
        lo_b = torch.where(use_c, zero, torch.where(min_en, neg_max, zero))
        hi_b = torch.where(use_c, pos_max,
                           torch.where(max_en, pos_max, zero))
        put(12 + i, per_axis | use_c, zeros3, aj, aj,
            torch.where(use_c, r_bias_c, r_bias_axis),
            torch.where(use_c, r_wo_c, zeros), cfm_coeff_j, zeros, lo_b,
            hi_b)

    for i in range(3):  # linear limits -> slots 15..17
        if 15 + i not in slots:
            continue
        bit = 1 << i
        per_axis = ((limit_mask & ~coupled) & bit) != 0
        use_c = has_lin_coupling & (fcl == i) & (
            ((limit_mask & coupled) & 0b111) != 0)
        lj_axis = basis[..., :, i]
        dist_axis = _dot3(lin_err, lj_axis)
        lo_l = jset.limit_min[:, i]
        hi_l = jset.limit_max[:, i]
        min_en = dist_axis <= lo_l
        max_en = hi_l <= dist_axis
        r_bias_axis = (torch.clamp(dist_axis - hi_l, min=0.0)
                       - torch.clamp(lo_l - dist_axis, min=0.0)) * erp_inv_dt
        # the coupled limit, max side only
        lj_c, aa_c, ab_c, dist_c = coupled_linear()
        r_wo_c = torch.clamp(dist_c - hi_l, max=0.0) * inv_dt
        r_bias_c = r_wo_c + torch.clamp(dist_c - hi_l, min=0.0) * erp_inv_dt
        u = use_c[:, None]
        lo_b = torch.where(use_c, zero, torch.where(min_en, neg_max, zero))
        hi_b = torch.where(use_c, pos_max,
                           torch.where(max_en, pos_max, zero))
        put(15 + i, per_axis | use_c, torch.where(u, lj_c, lj_axis),
            torch.where(u, aa_c, cmat1_basis[..., :, i]),
            torch.where(u, ab_c, cmat2_basis[..., :, i]),
            torch.where(use_c, r_bias_c, r_bias_axis),
            torch.where(use_c, r_wo_c, zeros), cfm_coeff_j, zeros, lo_b,
            hi_b)

    st = {k: torch.stack(v, 1) for k, v in cols.items()}
    cons = JointConstraints(
        body_a=ba, body_b=bb, im_a=im1, im_b=im2,
        active=st["active"] & jset.valid[:, None],
        lin_jac=st["lin"], ang_jac_a=st["aa"], ang_jac_b=st["ab"],
        ii_ang_jac_a=_ii_mul(ii1, st["aa"]),
        ii_ang_jac_b=_ii_mul(ii2, st["ab"]),
        inv_lhs=torch.zeros((j, e), device=dev),
        rhs=st["rhs"], rhs_wo_bias=st["rhs_wo"], cfm_gain=st["cfm_g"],
        cfm_coeff=st["cfm_c"], bounds_min=st["bmin"], bounds_max=st["bmax"],
        impulse=torch.zeros((j, e), device=dev), valid=jset.valid,
        slots=jset.slots, max_color=jset.max_color)
    return _orthogonalize(cons)


def _adot(a: torch.Tensor, b: torch.Tensor, ang3: bool) -> torch.Tensor:
    """angular · angular: over the last axis in 3D, a product in 2D."""
    return _dot3(a, b) if ang3 else a * b


def _orthogonalize(cons: JointConstraints) -> JointConstraints:
    """Masked modified Gram-Schmidt within the two slot groups, over the
    slots the set activates; each slot's eliminations from the later slots
    of its group run at once (the JAX package's ``_orthogonalize`` and
    ``_orthogonalize_2d``)."""
    ang3 = cons.ang_jac_a.ndim == 3
    imsum = cons.im_a + cons.im_b
    lin, aa, ab = (x.clone() for x in (cons.lin_jac, cons.ang_jac_a,
                                       cons.ang_jac_b))
    iia, iib = cons.ii_ang_jac_a.clone(), cons.ii_ang_jac_b.clone()
    rhs, rhs_wo = cons.rhs.clone(), cons.rhs_wo_bias.clone()
    cfm_gain, inv_lhs = cons.cfm_gain.clone(), cons.inv_lhs.clone()
    zero = torch.zeros((), device=lin.device)
    for g0, g1 in slot_groups(3 if ang3 else 2):
        group = [s for s in cons.slots if g0 <= s < g1]
        for k, jj in enumerate(group):
            act_j = cons.active[:, jj]
            dot_jj = (_dot3(lin[:, jj], imsum * lin[:, jj])
                      + _adot(iia[:, jj], aa[:, jj], ang3)
                      + _adot(iib[:, jj], ab[:, jj], ang3))
            new_gain = dot_jj * cons.cfm_coeff[:, jj] + cfm_gain[:, jj]
            inv_dot_jj = _pseudo_inv(dot_jj)
            inv_lhs[:, jj] = torch.where(act_j,
                                         _pseudo_inv(dot_jj + new_gain), zero)
            cfm_gain[:, jj] = torch.where(act_j, new_gain, zero)
            later = group[k + 1:]
            if not later:
                continue
            # a run of slots is a view (no index copied to the device)
            ls = (slice(later[0], later[-1] + 1)
                  if later == list(range(later[0], later[-1] + 1))
                  else torch.tensor(later, device=lin.device))
            elim = act_j & (cons.bounds_min[:, jj] <= -MAX) & (
                cons.bounds_max[:, jj] >= MAX)
            dot_ij = (_dot3(lin[:, ls], (imsum * lin[:, jj])[:, None])
                      + _adot(iia[:, ls], aa[:, jj][:, None], ang3)
                      + _adot(iib[:, ls], ab[:, jj][:, None], ang3))
            coeff = torch.where(elim[:, None] & cons.active[:, ls],
                                dot_ij * inv_dot_jj[:, None], zero)
            c3 = coeff[..., None]
            for x in (lin, aa, ab, iia, iib):
                x[:, ls] = x[:, ls] + (-x[:, jj])[:, None] * (
                    c3 if x.ndim == 3 else coeff)
            for x in (rhs, rhs_wo):
                x[:, ls] = x[:, ls] + (-x[:, jj])[:, None] * coeff
    return dataclasses.replace(cons, lin_jac=lin, ang_jac_a=aa, ang_jac_b=ab,
                               ii_ang_jac_a=iia, ii_ang_jac_b=iib, rhs=rhs,
                               rhs_wo_bias=rhs_wo, cfm_gain=cfm_gain,
                               inv_lhs=inv_lhs)


def remove_joint_bias(cons: JointConstraints) -> JointConstraints:
    return dataclasses.replace(cons, rhs=cons.rhs_wo_bias)


def joint_gs_pass(cons: JointConstraints, vels: Velocity,
                  colors: torch.Tensor, *, max_colors: int = 32
                  ) -> tuple[Velocity, JointConstraints]:
    """One Gauss-Seidel pass over the joints, colour by colour: colours 1
    to min(``cons.max_color``, ``max_colors``); joints of a higher colour
    are not solved, as in the JAX package. ``colors`` are the colours of
    the set ``cons`` was built from (the bound is its host value). Within
    a colour no two joints share a dynamic body, so each body takes at
    most one non-zero delta and the scatter-add's order cannot matter."""
    lin_v, ang_v = vels.linear, vels.angular
    ang3 = cons.ang_jac_a.ndim == 3
    imp = cons.impulse.clone()
    both = torch.cat([cons.body_a, cons.body_b])
    for color in range(1, min(cons.max_color, max_colors) + 1):
        act_c = cons.valid & (colors == color)
        v1l, v1a = lin_v[cons.body_a], ang_v[cons.body_a]
        v2l, v2a = lin_v[cons.body_b], ang_v[cons.body_b]
        i1l, i1a, i2l, i2a = v1l, v1a, v2l, v2a
        for s in cons.slots:
            act = act_c & cons.active[:, s]
            dlin = _dot3(cons.lin_jac[:, s], v2l - v1l)
            dang = (_adot(cons.ang_jac_b[:, s], v2a, ang3)
                    - _adot(cons.ang_jac_a[:, s], v1a, ang3))
            old = imp[:, s]
            cand = torch.clamp(
                old + cons.inv_lhs[:, s]
                * (dlin + dang + cons.rhs[:, s] - cons.cfm_gain[:, s] * old),
                cons.bounds_min[:, s], cons.bounds_max[:, s])
            new = torch.where(act, cand, old)
            d = (new - old)[:, None]
            imp[:, s] = new
            lin_imp = cons.lin_jac[:, s] * d
            da = d if ang3 else d[:, 0]
            v1l = v1l + lin_imp * cons.im_a
            v1a = v1a + cons.ii_ang_jac_a[:, s] * da
            v2l = v2l - lin_imp * cons.im_b
            v2a = v2a - cons.ii_ang_jac_b[:, s] * da
        lin_v = lin_v.index_add(0, both, torch.cat([v1l - i1l, v2l - i2l]))
        ang_v = ang_v.index_add(0, both, torch.cat([v1a - i1a, v2a - i2a]))
    return Velocity(lin_v, ang_v), dataclasses.replace(cons, impulse=imp)


def _build_joint_constraints_2d(jset: JointSet, poses: Sim,
                                mprops: WorldMassProperties,
                                params: SimParams) -> JointConstraints:
    """The 2D build (the JAX package's ``_build_joint_constraints_2d``):
    rotations as (cos, sin), scalar angular jacobians (1 for the angular
    slots, perp(r)·axis for the linear ones), the nine slots of the
    module's docstring, over the slots the set activates. Then
    :func:`_orthogonalize`."""
    j, e = jset.num_joints, NUM_SLOTS_2D
    dev = poses.translation.device
    slots = set(jset.slots)
    ba, bb = jset.body_a, jset.body_b
    frame1 = sim_ops.mul(poses.take(ba), jset.local_frame_a)
    frame2 = sim_ops.mul(poses.take(bb), jset.local_frame_b)
    com1, com2 = mprops.com[ba], mprops.com[bb]
    im1, im2 = mprops.inv_mass[ba], mprops.inv_mass[bb]
    ii1, ii2 = mprops.inv_inertia[ba], mprops.inv_inertia[bb]

    r1q, r2q = frame1.rotation, frame2.rotation
    basis = rot2.to_matrix(r1q)  # columns: the joint axes in the world
    lin_err = frame2.translation - frame1.translation
    locked = jset.locked_axes
    zero = torch.zeros((), device=dev)
    t1 = frame2.translation
    for i in range(2):
        axis = basis[..., :, i]
        has = (locked & (1 << i)) != 0
        t1 = t1 - torch.where(has[:, None],
                              axis * _dot3(axis, lin_err)[:, None], zero)
    r1 = t1 - com1
    r2 = frame2.translation - com2

    def perp_dot(r, m):  # perp(r) · each column of m
        perp = torch.stack([-r[..., 1], r[..., 0]], -1)
        return torch.stack([_dot3(perp, m[..., :, i]) for i in range(2)],
                           -1)

    cmat1_basis = perp_dot(r1, basis)
    cmat2_basis = perp_dot(r2, basis)
    ang_err = rot2.mul(rot2.inv(r1q), r2q)
    ang_err_angle = rot2.angle(ang_err)
    ang_err_sin = ang_err[..., 1]

    erp_inv_dt = params.joint_erp_inv_dt
    cfm_coeff_j = torch.full((j,), params.joint_cfm_coeff, device=dev)
    inv_dt = params.inv_dt
    zeros = torch.zeros(j, device=dev)
    ones = torch.ones(j, device=dev)
    zeros2 = torch.zeros((j, 2), device=dev)
    neg_max = torch.full((j,), -MAX, device=dev)
    pos_max = torch.full((j,), MAX, device=dev)
    no = torch.zeros(j, dtype=torch.bool, device=dev)
    cols = {k: [default] * e for k, default in (
        ("active", no), ("lin", zeros2), ("aa", zeros), ("ab", zeros),
        ("rhs", zeros), ("rhs_wo", zeros), ("cfm_c", zeros),
        ("cfm_g", zeros), ("bmin", neg_max), ("bmax", pos_max))}

    def put(slot, act, lj, aa, ab, r, rw, cc, cg, lo, hi):
        cols["lin"][slot] = torch.where(act[:, None], lj, zero)
        for k, v, off in (("aa", aa, zero), ("ab", ab, zero),
                          ("rhs", r, zero), ("rhs_wo", rw, zero),
                          ("cfm_c", cc, zero), ("cfm_g", cg, zero),
                          ("bmin", lo, -MAX), ("bmax", hi, MAX)):
            cols[k][slot] = torch.where(act, v, off)
        cols["active"][slot] = act

    motor_mask = jset.motor_axes & ~locked
    limit_mask = jset.limit_axes & ~locked
    if 0 in slots:  # the angular motor (axis bit 2)
        mp = _motor_params(jset, 2, params.dt)
        r_wo = (_smallest_angle_diff(ang_err_angle, mp["target_pos"])
                * mp["erp_inv_dt"]) - mp["target_vel"]
        put(0, (motor_mask & 4) != 0, zeros2, ones, ones, r_wo, r_wo,
            mp["cfm_coeff"], mp["cfm_gain"], -mp["max_impulse"],
            mp["max_impulse"])
    for i in range(2):  # the linear motors (axes 0, 1) -> slots 1, 2
        if 1 + i not in slots:
            continue
        bit = 1 << i
        mp = _motor_params(jset, i, params.dt)
        lj = basis[..., :, i]
        dist = _dot3(lin_err, lj)
        has_lim = (limit_mask & bit) != 0
        lo_l = torch.where(has_lim, jset.limit_min[:, i], neg_max)
        hi_l = torch.where(has_lim, jset.limit_max[:, i], pos_max)
        target_vel = torch.where(
            has_lim,
            torch.clamp(mp["target_vel"], (lo_l - dist) * inv_dt,
                        (hi_l - dist) * inv_dt),
            mp["target_vel"])
        r_wo = (dist - mp["target_pos"]) * mp["erp_inv_dt"] - target_vel
        put(1 + i, (motor_mask & bit) != 0, lj, cmat1_basis[:, i],
            cmat2_basis[:, i], r_wo, r_wo, mp["cfm_coeff"], mp["cfm_gain"],
            -mp["max_impulse"], mp["max_impulse"])
    if 3 in slots:  # the angular lock
        put(3, (locked & 4) != 0, zeros2, ones, ones,
            ang_err_sin * erp_inv_dt, zeros, cfm_coeff_j, zeros, neg_max,
            pos_max)
    for i in range(2):  # the linear locks -> slots 4, 5
        if 4 + i not in slots:
            continue
        lj = basis[..., :, i]
        put(4 + i, (locked & (1 << i)) != 0, lj, cmat1_basis[:, i],
            cmat2_basis[:, i], _dot3(lj, lin_err) * erp_inv_dt, zeros,
            cfm_coeff_j, zeros, neg_max, pos_max)
    if 6 in slots:  # the angular limit
        s_min = torch.sin(jset.limit_min[:, 2] * 0.5)
        s_max = torch.sin(jset.limit_max[:, 2] * 0.5)
        s_ang = torch.sin(ang_err_angle * 0.5)
        r_bias = (torch.clamp(s_ang - s_max, min=0.0)
                  - torch.clamp(s_min - s_ang, min=0.0)) * erp_inv_dt
        put(6, (limit_mask & 4) != 0, zeros2, ones, ones, r_bias, zeros,
            cfm_coeff_j, zeros, torch.where(s_ang <= s_min, neg_max, zeros),
            torch.where(s_max <= s_ang, pos_max, zeros))
    for i in range(2):  # the linear limits -> slots 7, 8
        if 7 + i not in slots:
            continue
        lj = basis[..., :, i]
        dist = _dot3(lin_err, lj)
        lo_l, hi_l = jset.limit_min[:, i], jset.limit_max[:, i]
        r_bias = (torch.clamp(dist - hi_l, min=0.0)
                  - torch.clamp(lo_l - dist, min=0.0)) * erp_inv_dt
        put(7 + i, (limit_mask & (1 << i)) != 0, lj, cmat1_basis[:, i],
            cmat2_basis[:, i], r_bias, zeros, cfm_coeff_j, zeros,
            torch.where(dist <= lo_l, neg_max, zeros),
            torch.where(hi_l <= dist, pos_max, zeros))

    st = {k: torch.stack(v, 1) for k, v in cols.items()}
    cons = JointConstraints(
        body_a=ba, body_b=bb, im_a=im1, im_b=im2,
        active=st["active"] & jset.valid[:, None],
        lin_jac=st["lin"], ang_jac_a=st["aa"], ang_jac_b=st["ab"],
        ii_ang_jac_a=ii1[:, None] * st["aa"],
        ii_ang_jac_b=ii2[:, None] * st["ab"],
        inv_lhs=torch.zeros((j, e), device=dev),
        rhs=st["rhs"], rhs_wo_bias=st["rhs_wo"], cfm_gain=st["cfm_g"],
        cfm_coeff=st["cfm_c"], bounds_min=st["bmin"], bounds_max=st["bmax"],
        impulse=torch.zeros((j, e), device=dev), valid=jset.valid,
        slots=jset.slots, max_color=jset.max_color)
    return _orthogonalize(cons)
