"""Fused contact → constraint build, 3D (counterpart of
``wgmath_tpu/dynamics/build_pallas.py``).

:func:`build_constraints_fused` does the work of
``constraint.build_constraints`` and also returns the constraint fields as
one transposed matrix ``bigT`` [K, C] (one row per field component, one
column per constraint) in ``F32_SORT_FIELDS`` order, so the fused solve
takes its window fields as a row slice with no repacking.

- On a CUDA tensor it launches ``csrc/build_fused.cu`` (kernel B9, which
  replaces ``_build_pallas_call``): one thread per constraint, the gather
  of both bodies' 128-byte rows from the packed body table done in the
  kernel, the contact fields read in place by their row strides, ``bigT``
  written column by column. It launches or raises.
- On a CPU tensor it runs :func:`_cm_build`, the plain PyTorch
  transcription of the JAX package's ``_cm_build`` on component-major
  ``[rows, C]`` slabs.

``LAUNCHES`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes

import torch

from wgmath_tpu_torch.dynamics.constraint import ContactConstraints, Contacts
from wgmath_tpu_torch.dynamics.gs_math import PACK_FIELDS, _size

LAUNCHES = 0

# every float field of the solve, in the row order of the packed matrices
F32_SORT_FIELDS = PACK_FIELDS + ("cfm_factor", "n_rhs", "t_rhs",
                                 "n_rhs_wo_bias")
# rows of one body in the packed body table: rotation 4, translation 3,
# scale 1, linear 3, angular 3, inv_mass 3, inv_inertia 9, com 3
SIDE_OFFS = (0, 4, 7, 8, 11, 14, 17, 26, 29)
# floats a row of the table: the 29 fields and 3 zeros, so that a row is
# one aligned 128-byte line, which the kernel reads as 8 16-byte loads
W_SIDE = 32


def field_meta(p_max: int, s_len: int):
    """(name → (first row, trailing shape)) in ``F32_SORT_FIELDS`` order,
    and the total row count (71 at P = 1, S = 2)."""
    tails = {
        "dir_a": (3,), "tangent_a": (s_len, 3), "im_a": (3,), "im_b": (3,),
        "limit": (), "n_torque_a": (p_max, 3), "n_torque_b": (p_max, 3),
        "n_ii_torque_a": (p_max, 3), "n_ii_torque_b": (p_max, 3),
        "n_r": (p_max,), "t_torque_a": (p_max, s_len, 3),
        "t_torque_b": (p_max, s_len, 3), "t_ii_torque_a": (p_max, s_len, 3),
        "t_ii_torque_b": (p_max, s_len, 3), "t_r": (p_max, 3),
        "cfm_factor": (), "n_rhs": (p_max,), "t_rhs": (p_max, s_len),
        "n_rhs_wo_bias": (p_max,), "t_rhs_wo_bias": (p_max, s_len),
        "local_pt_a": (p_max, 3), "local_pt_b": (p_max, 3),
        "info_dist": (p_max,), "info_normal_vel": (p_max,),
    }
    meta, at = {}, 0
    for f in F32_SORT_FIELDS:
        meta[f] = (at, tails[f])
        at += _size(tails[f])
    return meta, at


# --------------------------- component-major math -------------------------


def _dot(a, b):
    """[3, L] . [3, L] -> [1, L], added left to right (the kernel's
    order)."""
    return a[0:1] * b[0:1] + a[1:2] * b[1:2] + a[2:3] * b[2:3]


def _cross(a, b):
    return torch.cat([a[1:2] * b[2:3] - a[2:3] * b[1:2],
                      a[2:3] * b[0:1] - a[0:1] * b[2:3],
                      a[0:1] * b[1:2] - a[1:2] * b[0:1]], dim=0)


def _quat_rot(q, v):
    """Rotate [3, L] v by the [4, L] xyzw quaternion q."""
    u, w = q[0:3], q[3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def _quat_rot_inv(q, v):
    return _quat_rot(torch.cat([-q[0:3], q[3:4]], dim=0), v)


def _ii_mul(ii, v):
    """[9, L] row-major 3x3 inverse inertia times a [3, L] vector."""
    return torch.cat([ii[3 * i:3 * i + 1] * v[0:1]
                      + ii[3 * i + 1:3 * i + 2] * v[1:2]
                      + ii[3 * i + 2:3 * i + 3] * v[2:3] for i in range(3)],
                     dim=0)


def _orthonormal(v):
    sign = torch.where(v[2:3] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v[2:3])
    b = v[0:1] * v[1:2] * a
    return torch.cat([b, sign + v[1:2] * v[1:2] * a, -v[1:2]], dim=0)


def _safe_inv(x):
    zero = x == 0.0
    return torch.where(zero, torch.zeros_like(x),
                       1.0 / torch.where(zero, torch.ones_like(x), x))


def _cm_build(aT, bT, nT, ptsT, distT, *, p_max: int, s_len: int,
              restitution: float, inv_dt: float, friction: float,
              cfm_factor: float, meta: dict, k_all: int):
    """Plain version of kernel B9 on component-major slabs: ``aT``/``bT``
    [29 or more, L] both sides' packed body rows (``SIDE_OFFS`` order; the
    rows past them are not read), ``nT``
    [3, L], ``ptsT`` [3P, L], ``distT`` [P, L]. Returns bigT [k_all, L]."""
    assert s_len == 2

    def side(t, i):
        return t[SIDE_OFFS[i]:SIDE_OFFS[i + 1]]

    q1, q2 = side(aT, 0), side(bT, 0)
    tr1, tr2 = side(aT, 1), side(bT, 1)
    sc1, sc2 = side(aT, 2), side(bT, 2)
    lin1, lin2 = side(aT, 3), side(bT, 3)
    ang1, ang2 = side(aT, 4), side(bT, 4)
    im1, im2 = side(aT, 5), side(bT, 5)
    ii1, ii2 = side(aT, 6), side(bT, 6)
    com1, com2 = side(aT, 7), side(bT, 7)

    dir1 = -_quat_rot(q1, nT)  # force direction (unit: scale-free)
    # friction basis: the relative velocity's tangential part when large
    # enough, else an arbitrary orthonormal vector
    rel = lin1 - lin2
    t = rel - dir1 * _dot(dir1, rel)
    tn = torch.sqrt(_dot(t, t))
    t1 = torch.where(tn < 1.0e-4, _orthonormal(dir1),
                     t / torch.clamp(tn, min=1e-30))
    t2 = _cross(dir1, t1)

    imsum = im1 + im2
    L = nT.shape[1]
    dev = nT.device
    out = {"dir_a": dir1, "tangent_a": torch.cat([t1, t2], dim=0),
           "im_a": im1, "im_b": im2,
           "limit": torch.full((1, L), friction, device=dev),
           "cfm_factor": torch.full((1, L), cfm_factor, device=dev),
           "t_rhs": torch.zeros((p_max * s_len, L), device=dev),
           "t_rhs_wo_bias": torch.zeros((p_max * s_len, L), device=dev)}
    acc = {f: [] for f in ("n_torque_a", "n_torque_b", "n_ii_torque_a",
                           "n_ii_torque_b", "n_r", "n_rhs", "t_torque_a",
                           "t_torque_b", "t_ii_torque_a", "t_ii_torque_b",
                           "t_r", "local_pt_a", "local_pt_b", "info_dist",
                           "info_normal_vel")}
    for k in range(p_max):
        dist = distT[k:k + 1]
        pt_local = ptsT[3 * k:3 * k + 3] + nT * (dist / 2.0)
        pt = sc1 * _quat_rot(q1, pt_local) + tr1
        dp1 = pt - com1
        dp2 = pt - com2
        cvel1 = lin1 + _cross(ang1, dp1)
        cvel2 = lin2 + _cross(ang2, dp2)
        td1 = _cross(dp1, dir1)
        td2 = _cross(dp2, -dir1)
        iitd1 = _ii_mul(ii1, td1)
        iitd2 = _ii_mul(ii2, td2)
        proj_mass = _safe_inv(_dot(dir1, imsum * dir1) + _dot(iitd1, td1)
                              + _dot(iitd2, td2))
        rhs_wo_bias = (restitution * _dot(cvel1 - cvel2, dir1)
                       + torch.clamp(dist, min=0.0) * inv_dt)
        acc["n_torque_a"].append(td1)
        acc["n_ii_torque_a"].append(iitd1)
        acc["n_torque_b"].append(td2)
        acc["n_ii_torque_b"].append(iitd2)
        acc["n_rhs"].append(rhs_wo_bias)
        acc["n_r"].append(proj_mass)
        tq_a, tq_b, ti_a, ti_b, r_parts = [], [], [], [], []
        for tj in (t1, t2):
            ttd1 = _cross(dp1, tj)
            ttd2 = _cross(dp2, -tj)
            tii1 = _ii_mul(ii1, ttd1)
            tii2 = _ii_mul(ii2, ttd2)
            r_parts.append(_dot(tj, imsum * tj) + _dot(tii1, ttd1)
                           + _dot(tii2, ttd2))
            tq_a.append(ttd1)
            tq_b.append(ttd2)
            ti_a.append(tii1)
            ti_b.append(tii2)
        r_cross = 2.0 * (_dot(tq_a[0], ti_a[1]) + _dot(tq_b[0], ti_b[1]))
        acc["t_r"].append(torch.cat(r_parts + [r_cross], dim=0))
        acc["t_torque_a"].append(torch.cat(tq_a, dim=0))
        acc["t_torque_b"].append(torch.cat(tq_b, dim=0))
        acc["t_ii_torque_a"].append(torch.cat(ti_a, dim=0))
        acc["t_ii_torque_b"].append(torch.cat(ti_b, dim=0))
        acc["local_pt_a"].append(_quat_rot_inv(q1, pt - tr1) / sc1)
        acc["local_pt_b"].append(_quat_rot_inv(q2, pt - tr2) / sc2)
        acc["info_dist"].append(dist)
        acc["info_normal_vel"].append(rhs_wo_bias)
    for f, parts in acc.items():
        out[f] = torch.cat(parts, dim=0)
    out["n_rhs_wo_bias"] = out["n_rhs"]
    # rows are placed by their offset in `meta`, whatever the dict order
    rows = []
    for f, (_, tail) in sorted(meta.items(), key=lambda kv: kv[1][0]):
        assert out[f].shape[0] == _size(tail), (f, out[f].shape, tail)
        rows.append(out[f])
    bigT = torch.cat(rows, dim=0)
    assert bigT.shape[0] == k_all
    return bigT


# ------------------------------- wrappers ---------------------------------


def _packed_bodies(poses, vels, mprops) -> torch.Tensor:
    """[N, 32] body table in ``SIDE_OFFS`` order, 3 zeros a row after the
    29 fields."""
    n_b = poses.rotation.shape[0]
    pad = mprops.com.new_zeros((1, 1)).expand(n_b, W_SIDE - SIDE_OFFS[-1])
    cols = [poses.rotation, poses.translation, poses.scale, vels.linear,
            vels.angular, mprops.inv_mass, mprops.inv_inertia.reshape(n_b, -1),
            mprops.com, pad]
    packed = torch.cat([x[:, None] if x.ndim == 1 else x for x in cols],
                       dim=1).to(torch.float32)
    assert packed.shape[1] == W_SIDE
    return packed


def _build_torch(packed, contacts: Contacts, consts, meta, k_all: int,
                 p_max: int):
    """Plain version of kernel B9 (the kernel's arguments): both sides'
    rows of the packed body table gathered, then :func:`_cm_build`."""
    c = contacts.capacity
    pp_t = packed[torch.cat([contacts.body_a, contacts.body_b])].T
    return _cm_build(
        pp_t[:, :c], pp_t[:, c:], contacts.normal_a.T,
        contacts.points_a.reshape(c, -1).T, contacts.dist.T, p_max=p_max,
        s_len=2, restitution=consts[0], inv_dt=consts[1], friction=consts[2],
        cfm_factor=consts[3], meta=meta, k_all=k_all)


_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# csrc/build_fused.cu build_fused_launch: p_max, C, table, ids, the contact
# fields with their row strides, the constants, field rows, bigT, stream
_ARGTYPES = ([_I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _I] + [_F] * 4
             + [_P, _P, _P])


def _row_stride(t, name: str, inner: tuple) -> int:
    """Row stride in floats of contact field ``t`` [C, *inner] read in
    place: its innermost stride must be 1, a point's stride 3 (``inner`` =
    (P, 3)), its pointer 4-byte aligned; raises otherwise (no copy)."""
    want = (3, 1) if len(inner) == 2 else (1,)
    for d, (size, stride) in enumerate(zip(inner, want), start=1):
        if size > 1 and t.stride(d) != stride:
            raise ValueError(f"build_fused kernel: {name} has stride "
                             f"{t.stride(d)} on dim {d}; the kernel reads "
                             f"it in place and needs {stride}")
    if t.data_ptr() % 4:
        raise ValueError(f"build_fused kernel: {name} is not 4-byte "
                         "aligned")
    return t.stride(0)


def plan(p_max: int, c: int) -> tuple[int, int, int]:
    """(block size, registers a thread, warps an SM holds of that block)
    that kernel B9 takes for ``c`` constraints on the current device."""
    from wgmath_tpu_torch.core import cuda_build

    fn = cuda_build.load("build_fused").build_fused_plan
    fn.argtypes = [_I, _I, _P]
    fn.restype = _I
    out = (ctypes.c_int * 3)()
    err = fn(p_max, c, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"build_fused plan failed: error {err}")
    return tuple(out)


def _launch(packed, contacts: Contacts, consts, meta, k_all: int, p_max: int):
    global LAUNCHES
    from wgmath_tpu_torch.core import cuda_build

    c = contacts.capacity
    dev = packed.device
    if p_max not in (1, 4):
        raise ValueError(f"build_fused kernel: p_max={p_max} not "
                         "instantiated (1 or 4)")
    if (packed.dtype != torch.float32 or packed.shape[1:] != (W_SIDE,)
            or not packed.is_contiguous()
            or packed.data_ptr() % 16):
        raise ValueError(f"build_fused kernel: the body table must be a "
                         f"contiguous 16-byte aligned f32 [N, {W_SIDE}]")
    for nm, t, dtype, shape in (
            ("body_a", contacts.body_a, torch.int64, (c,)),
            ("body_b", contacts.body_b, torch.int64, (c,)),
            ("normal_a", contacts.normal_a, torch.float32, (c, 3)),
            ("points_a", contacts.points_a, torch.float32, (c, p_max, 3)),
            ("dist", contacts.dist, torch.float32, (c, p_max))):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"build_fused kernel: {nm} must be a "
                             f"{dtype} {shape} tensor on {dev}")
        if dtype == torch.int64 and not t.is_contiguous():
            raise ValueError(f"build_fused kernel: {nm} must be contiguous")
    # the compacted contacts' float fields are column views of one
    # gathered matrix: read in place, by row stride
    ld_n = _row_stride(contacts.normal_a, "normal_a", (3,))
    ld_p = _row_stride(contacts.points_a, "points_a", (p_max, 3))
    ld_d = _row_stride(contacts.dist, "dist", (p_max,))
    rows = (ctypes.c_int * len(F32_SORT_FIELDS))(
        *[int(meta[f][0]) for f in F32_SORT_FIELDS])
    big_t = torch.empty((k_all, c), device=dev)
    lib = cuda_build.load("build_fused")
    fn = lib.build_fused_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(p_max, c, packed.data_ptr(), contacts.body_a.data_ptr(),
             contacts.body_b.data_ptr(), contacts.normal_a.data_ptr(), ld_n,
             contacts.points_a.data_ptr(), ld_p, contacts.dist.data_ptr(),
             ld_d, *[float(x) for x in consts], rows, big_t.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"build_fused kernel launch failed: error {err}")
    LAUNCHES += 1
    return big_t


def build_constraints_fused(poses, vels, mprops, contacts: Contacts, params):
    """``constraint.build_constraints`` (3D) that also returns the packed
    transposed field matrix: ``(cons, bigT, meta)``. ``bigT`` [K, C] holds
    the fields in ``F32_SORT_FIELDS`` row order (``meta``: name → (first
    row, trailing shape)); the fields of ``cons`` are row-major views of
    its transpose. Kernel B9 on a CUDA tensor, :func:`_cm_build` on a CPU
    tensor."""
    p_max = contacts.points_a.shape[1]
    s_len = 2
    meta, k_all = field_meta(p_max, s_len)
    id1, id2 = contacts.body_a, contacts.body_b
    c = id1.shape[0]
    packed = _packed_bodies(poses, vels, mprops)
    consts = (float(params.restitution), float(params.inv_dt),
              float(params.friction), float(params.contact_cfm_factor))
    dev = packed.device
    if dev.type == "cuda":
        big_t = _launch(packed, contacts, consts, meta, k_all, p_max)
    elif dev.type == "cpu":
        big_t = _build_torch(packed, contacts, consts, meta, k_all, p_max)
    else:
        raise ValueError(f"build_constraints_fused: unsupported device {dev}")
    big = big_t.T  # [C, K] row-major views
    fields = {f: big[:, at:at + _size(tail)].reshape((c,) + tuple(tail))
              for f, (at, tail) in meta.items()}
    zeros_p = torch.zeros((c, p_max), device=dev)
    zeros_ps = torch.zeros((c, p_max, s_len), device=dev)
    cons = ContactConstraints(
        body_a=id1, body_b=id2, valid=contacts.valid,
        num_points=contacts.num_points, n_impulse=zeros_p,
        n_impulse_jacobi=zeros_p.clone(), t_impulse=zeros_ps,
        t_impulse_jacobi=zeros_ps.clone(), **fields)
    return cons, big_t, meta
