"""Gauss-Seidel impulse math (counterpart of
``wgmath_tpu/dynamics/gs_pallas.py``): one rung, or one whole sweep over
the window ladder in one launch.

- :func:`gs_math_block_rhs` rebuilds the substep rhs in kernel
  (``_gs_math_rhs_pallas_call``): on a CUDA tensor it launches one rung of
  ``csrc/gs_math.cu``, on a CPU tensor it runs :func:`_gs_math_rhs_torch`,
  the plain PyTorch transcription of ``_cm_rhs`` + ``_cm_point_updates``.
- :func:`gs_math_block` takes ``cfm_factor`` / ``n_rhs`` / ``t_rhs`` from
  the caller (``_gs_math_pallas_call``): one rung of
  ``csrc/gs_math_block.cu`` on a CUDA tensor, :func:`_gs_math_torch` on a
  CPU tensor.
- :func:`gs_sweep_rhs` / :func:`gs_sweep_block` run the same kernels over
  every rung of a :class:`SweepPlan` in one launch, in place on the
  solver's velocity buffer and merged impulse matrix (CUDA tensors only;
  the plain version is ``solver._sweep_torch``). Rungs are ordered by
  per-side readiness flags, not by launch boundaries (``csrc/gs_sweep.cuh``).

Both kernels run one thread per constraint row and share their point
update (``csrc/gs_point_updates.cuh``), as the plain versions share
:func:`_point_updates`. A CUDA tensor launches the kernel or raises; there
is no other path. ``LAUNCHES`` / ``LAUNCHES_BLOCK`` count the launches of
the two kernels, one-rung and sweep alike.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import torch

LAUNCHES = 0  # csrc/gs_math.cu (rhs rebuilt in kernel)
LAUNCHES_BLOCK = 0  # csrc/gs_math_block.cu (rhs passed in)

# substep-invariant solver fields packed into one [C, K] f32 matrix, in
# this column order (the JAX package's _PACK_FIELDS); the kernels' column
# table (csrc/gs_point_updates.cuh Field) follows it
PACK_FIELDS = ("dir_a", "tangent_a", "im_a", "im_b", "limit",
               "n_torque_a", "n_torque_b", "n_ii_torque_a", "n_ii_torque_b",
               "n_r", "t_torque_a", "t_torque_b", "t_ii_torque_a",
               "t_ii_torque_b", "t_r", "local_pt_a", "local_pt_b",
               "info_dist", "info_normal_vel", "t_rhs_wo_bias")
# the fields the point update reads; the rest serve the rhs rebuild only
UPDATE_FIELDS = PACK_FIELDS[:15]


def _size(tail) -> int:
    k = 1
    for t in tail:
        k *= t
    return k


def pack_meta(p_max: int, s_len: int = 2) -> dict:
    """name → (first column, trailing shape) of the packed matrix."""
    tails = {"dir_a": (3,), "tangent_a": (s_len, 3), "im_a": (3,),
             "im_b": (3,), "limit": (), "n_torque_a": (p_max, 3),
             "n_torque_b": (p_max, 3), "n_ii_torque_a": (p_max, 3),
             "n_ii_torque_b": (p_max, 3), "n_r": (p_max,),
             "t_torque_a": (p_max, s_len, 3),
             "t_torque_b": (p_max, s_len, 3),
             "t_ii_torque_a": (p_max, s_len, 3),
             "t_ii_torque_b": (p_max, s_len, 3), "t_r": (p_max, 3),
             "local_pt_a": (p_max, 3), "local_pt_b": (p_max, 3),
             "info_dist": (p_max,), "info_normal_vel": (p_max,),
             "t_rhs_wo_bias": (p_max, s_len)}
    meta, at = {}, 0
    for f in PACK_FIELDS:
        meta[f] = (at, tails[f])
        at += _size(tails[f])
    return meta


def _fields(win2d: torch.Tensor, meta: dict) -> dict:
    """Row-major views [L, *tail] of the packed fields (the JAX package's
    ``_unpack_window``)."""
    L = win2d.shape[0]
    return {name: win2d[:, at:at + _size(tail)].reshape((L,) + tuple(tail))
            for name, (at, tail) in meta.items()}


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _mul_pt(pose: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sim.mul_pt on [L, 8] poses (quat xyzw | translation | scale)."""
    ux, uy, uz, w = pose[:, 0], pose[:, 1], pose[:, 2], pose[:, 3]
    vx, vy, vz = v[:, 0], v[:, 1], v[:, 2]
    cx = uy * vz - uz * vy
    cy = uz * vx - ux * vz
    cz = ux * vy - uy * vx
    dx = uy * cz - uz * cy
    dy = uz * cx - ux * cz
    dz = ux * cy - uy * cx
    rot = torch.stack([vx + 2.0 * (w * cx + dx), vy + 2.0 * (w * cy + dy),
                       vz + 2.0 * (w * cz + dz)], dim=-1)
    return pose[:, 7:8] * rot + pose[:, 4:7]


def _gs_math_rhs_torch(win2d, meta, num_points, active, p1, p2, prev_n,
                       prev_t, *, mode, consts, pose1=None, pose2=None,
                       n_rhs_wo=None, p_max, s_len):
    """Plain PyTorch version of the kernel (row-major)."""
    f = _fields(win2d, meta)
    inv_dt, erp_inv_dt, allowed, max_corr, cfm_factor = consts
    dir_a, tang = f["dir_a"], f["tangent_a"]
    if mode == "biased":
        n_rhs, rhs_wo, t_rhs = [], [], []
        for k in range(p_max):
            drift = (_mul_pt(pose1, f["local_pt_a"][:, k])
                     - _mul_pt(pose2, f["local_pt_b"][:, k]))
            dist = f["info_dist"][:, k] + _dot(drift, dir_a)
            wo = f["info_normal_vel"][:, k] + torch.clamp(dist, min=0.0) \
                * inv_dt
            bias = torch.clamp((dist + allowed) * erp_inv_dt, -max_corr, 0.0)
            n_rhs.append(wo + bias)
            rhs_wo.append(wo)
            t_rhs.append(torch.stack(
                [f["t_rhs_wo_bias"][:, k, j]
                 + _dot(drift, tang[:, j]) * inv_dt for j in range(s_len)],
                dim=-1))
        n_rhs = torch.stack(n_rhs, dim=1)
        rhs_wo = torch.stack(rhs_wo, dim=1)
        t_rhs = torch.stack(t_rhs, dim=1)
        cfm = cfm_factor
    else:
        n_rhs = n_rhs_wo
        t_rhs = f["t_rhs_wo_bias"]
        cfm = 1.0
    res = _point_updates(f, cfm, n_rhs, t_rhs, num_points, active, p1, p2,
                         prev_n, prev_t, p_max)
    return res + (rhs_wo,) if mode == "biased" else res


def _point_updates(f, cfm, n_rhs, t_rhs, num_points, active, p1, p2, prev_n,
                   prev_t, p_max, deltas: bool = True):
    """``_cm_point_updates`` row-major: ``f`` the field views, ``cfm`` a
    float or [L], ``n_rhs`` [L, P], ``t_rhs`` [L, P, 2]. Returns (new_n,
    new_t, d1, d2), or the updated velocities in place of the deltas
    (``deltas=False``). 2D rows (``dir_a`` [L, 2]) take
    :func:`_point_updates_2d`."""
    if f["dir_a"].shape[-1] == 2:
        return _point_updates_2d(f, cfm, n_rhs, t_rhs, num_points, active,
                                 p1, p2, prev_n, prev_t, p_max, deltas)
    dir_a, tang = f["dir_a"], f["tangent_a"]
    v1l, v1a = p1[:, :3], p1[:, 3:6]
    v2l, v2a = p2[:, :3], p2[:, 3:6]
    w1l, w1a, w2l, w2a = v1l, v1a, v2l, v2a
    im_a, im_b, friction = f["im_a"], f["im_b"], f["limit"]
    nump = num_points.to(torch.float32)
    new_n, new_t = [], []
    for k in range(p_max):
        on = active & (nump > k)
        prev = prev_n[:, k]
        dvel = (_dot(dir_a, w1l) + _dot(f["n_torque_a"][:, k], w1a)
                - _dot(dir_a, w2l) + _dot(f["n_torque_b"][:, k], w2a)
                + n_rhs[:, k])
        cand = cfm * torch.clamp(prev - f["n_r"][:, k] * dvel, min=0.0)
        new_imp = torch.where(on, cand, prev)
        d_imp = (new_imp - prev)[:, None]
        w1l = w1l + dir_a * (im_a * d_imp)
        w1a = w1a + f["n_ii_torque_a"][:, k] * d_imp
        w2l = w2l - dir_a * (im_b * d_imp)
        w2a = w2a + f["n_ii_torque_b"][:, k] * d_imp
        limit = new_imp * friction
        new_n.append(new_imp)

        t_r = f["t_r"][:, k]
        ta, tb = f["t_torque_a"][:, k], f["t_torque_b"][:, k]
        ia, ib = f["t_ii_torque_a"][:, k], f["t_ii_torque_b"][:, k]
        tp = prev_t[:, k]
        dd = [(_dot(tang[:, j], w1l) + _dot(ta[:, j], w1a)
               - _dot(tang[:, j], w2l) + _dot(tb[:, j], w2a)
               + t_rhs[:, k, j]) for j in range(2)]
        d00, d11, d01 = dd[0] * dd[0], dd[1] * dd[1], dd[0] * dd[1]
        lhs = d00 * t_r[:, 0] + d11 * t_r[:, 1] + d01 * t_r[:, 2]
        ok = torch.abs(lhs) > 1e-20
        inv_lhs = (d00 + d11) * torch.where(
            ok, 1.0 / torch.where(ok, lhs, torch.ones_like(lhs)),
            torch.zeros_like(lhs))
        raw = tp - torch.stack([inv_lhs * dd[0], inv_lhs * dd[1]], dim=-1)
        nrm = torch.sqrt(torch.sum(raw * raw, dim=-1))
        scale = torch.where(nrm > limit,
                            limit / torch.clamp(nrm, min=1e-30),
                            torch.ones_like(nrm))
        t_new = torch.where(on[:, None], raw * scale[:, None], tp)
        dl = t_new - tp
        lin_dir = tang[:, 0] * dl[:, 0:1] + tang[:, 1] * dl[:, 1:2]
        w1l = w1l + lin_dir * im_a
        w1a = w1a + ia[:, 0] * dl[:, 0:1] + ia[:, 1] * dl[:, 1:2]
        w2l = w2l - lin_dir * im_b
        w2a = w2a + ib[:, 0] * dl[:, 0:1] + ib[:, 1] * dl[:, 1:2]
        new_t.append(t_new)
    new_n, new_t = torch.stack(new_n, dim=1), torch.stack(new_t, dim=1)
    if not deltas:
        return (new_n, new_t, torch.cat([w1l, w1a], dim=-1),
                torch.cat([w2l, w2a], dim=-1))
    return (new_n, new_t, torch.cat([w1l - v1l, w1a - v1a], dim=-1),
            torch.cat([w2l - v2l, w2a - v2a], dim=-1))


def _point_updates_2d(f, cfm, n_rhs, t_rhs, num_points, active, p1, p2,
                      prev_n, prev_t, p_max, deltas: bool = True):
    """The JAX package's 2D ``_point_updates`` (as its XLA runs it: no
    kernel): rows of [vx, vy, w] velocities, scalar angular terms, one
    friction direction clamped to the friction cone and scaled by the
    cfm. Returns as :func:`_point_updates`."""
    dir_a, tj = f["dir_a"], f["tangent_a"][:, 0]
    v1l, v1a = p1[:, :2], p1[:, 2:3]
    v2l, v2a = p2[:, :2], p2[:, 2:3]
    w1l, w1a, w2l, w2a = v1l, v1a, v2l, v2a
    im_a, im_b, friction = f["im_a"], f["im_b"], f["limit"]
    nump = num_points.to(torch.float32)
    new_n, new_t = [], []
    for k in range(p_max):
        on = active & (nump > k)
        prev = prev_n[:, k]
        dvel = (_dot(dir_a, w1l) + f["n_torque_a"][:, k] * w1a[:, 0]
                - _dot(dir_a, w2l) + f["n_torque_b"][:, k] * w2a[:, 0]
                + n_rhs[:, k])
        cand = cfm * torch.clamp(prev - f["n_r"][:, k] * dvel, min=0.0)
        new_imp = torch.where(on, cand, prev)
        d_imp = (new_imp - prev)[:, None]
        w1l = w1l + dir_a * (im_a * d_imp)
        w1a = w1a + f["n_ii_torque_a"][:, k, None] * d_imp
        w2l = w2l - dir_a * (im_b * d_imp)
        w2a = w2a + f["n_ii_torque_b"][:, k, None] * d_imp
        limit = new_imp * friction
        new_n.append(new_imp)

        tp = prev_t[:, k, 0]
        dvel = (_dot(tj, w1l) + f["t_torque_a"][:, k, 0] * w1a[:, 0]
                - _dot(tj, w2l) + f["t_torque_b"][:, k, 0] * w2a[:, 0]
                + t_rhs[:, k, 0])
        cand = cfm * torch.clamp(tp - f["t_r"][:, k, 0] * dvel, min=-limit,
                                 max=limit)
        t_new = torch.where(on, cand, tp)
        dl = (t_new - tp)[:, None]
        w1l = w1l + tj * (im_a * dl)
        w1a = w1a + f["t_ii_torque_a"][:, k, 0, None] * dl
        w2l = w2l - tj * (im_b * dl)
        w2a = w2a + f["t_ii_torque_b"][:, k, 0, None] * dl
        new_t.append(t_new[:, None])
    new_n, new_t = torch.stack(new_n, dim=1), torch.stack(new_t, dim=1)
    if not deltas:
        return (new_n, new_t, torch.cat([w1l, w1a], dim=-1),
                torch.cat([w2l, w2a], dim=-1))
    return (new_n, new_t, torch.cat([w1l - v1l, w1a - v1a], dim=-1),
            torch.cat([w2l - v2l, w2a - v2a], dim=-1))


def _gs_math_torch(win2d, meta, cfm_factor, n_rhs, t_rhs, num_points, active,
                   p1, p2, prev_n, prev_t, *, p_max, s_len):
    """Plain PyTorch version of the ``gs_math_block`` kernel (row-major)."""
    L = win2d.shape[0]
    f = _fields(win2d, {k: meta[k] for k in UPDATE_FIELDS})
    return _point_updates(f, cfm_factor.reshape(L), n_rhs.reshape(L, p_max),
                          t_rhs.reshape(L, p_max, s_len), num_points, active,
                          p1, p2, prev_n.reshape(L, p_max),
                          prev_t.reshape(L, p_max, s_len), p_max)


def _rows(x: torch.Tensor, L: int, width: int, what: str):
    """(tensor, leading dimension) of ``x`` viewed as [L, width] with a
    unit inner stride; raises on anything else."""
    if x.dtype != torch.float32:
        raise TypeError(f"{what}: float32 expected, got {x.dtype}")
    try:
        v = x.view(L, width)
    except RuntimeError as e:
        raise ValueError(f"{what}: not viewable as [{L}, {width}] "
                         f"rows") from e
    if width > 1 and v.stride(1) != 1:
        raise ValueError(f"{what}: inner dimension must be contiguous")
    return v, v.stride(0)


def _column_offsets(kernel: str, win2d, meta, names, p_max: int,
                    s_len: int):
    """The kernel's column table (one int per ``PACK_FIELDS`` entry, -1 for
    a field it does not read) and the number of leading columns it stages
    (the end of the last field it reads), after checking that the
    instantiation exists and that every field in ``names`` lies inside the
    window at its shape."""
    if s_len != 2 or p_max not in (1, 4):
        raise ValueError(f"{kernel} kernel: (p_max={p_max}, s_len={s_len}) "
                         "not instantiated (p_max 1 or 4, s_len 2)")
    K = win2d.shape[1]
    want = pack_meta(p_max, s_len)
    for name in names:
        tail = want[name][1]
        if name not in meta or tuple(meta[name][1]) != tail:
            raise ValueError(f"{kernel} kernel: packed field {name} missing "
                             "or of the wrong shape")
        if not 0 <= int(meta[name][0]) <= K - _size(tail):
            raise ValueError(f"{kernel} kernel: field {name} lies outside "
                             f"the {K}-column window")
    offs = (ctypes.c_int * len(PACK_FIELDS))(
        *[int(meta[nm][0]) if nm in names else -1 for nm in PACK_FIELDS])
    return offs, max(int(meta[nm][0]) + _size(want[nm][1]) for nm in names)


def _check_row_inputs(kernel: str, L: int, dev, num_points, active,
                      tensors) -> None:
    for nm, t in (("num_points", num_points), ("active", active)) + tensors:
        if t is None or t.device != dev:
            raise ValueError(f"{kernel} kernel: {nm} missing or not on "
                             f"the window's device {dev}")
    if num_points.dtype != torch.int64 or num_points.shape != (L,) \
            or not num_points.is_contiguous():
        raise ValueError("num_points: contiguous int64 [L] expected")
    if active.dtype != torch.bool or active.shape != (L,) \
            or not active.is_contiguous():
        raise ValueError("active: contiguous bool [L] expected")


_ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
             + [ctypes.c_void_p, ctypes.c_int] * 6
             + [ctypes.c_void_p] * 5 + [ctypes.c_float] * 5
             + [ctypes.c_void_p])
_ARGTYPES_BLOCK = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_void_p, ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2
                   + [ctypes.c_void_p, ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)


def _launch(win2d, meta, num_points, active, p1, p2, prev_n, prev_t, *,
            mode, consts, pose1=None, pose2=None, n_rhs_wo=None, p_max,
            s_len):
    global LAUNCHES
    from wgmath_tpu_torch.core import cuda_build

    L, K = win2d.shape
    dev = win2d.device
    offs, kstage = _column_offsets("gs_math", win2d, meta, PACK_FIELDS,
                                   p_max, s_len)
    biased = mode == "biased"
    aux = (("pose1", pose1), ("pose2", pose2)) if biased else (
        ("n_rhs_wo", n_rhs_wo),)
    win, ld_win = _rows(win2d, L, K, "win2d")
    _check_row_inputs("gs_math", L, dev, num_points, active,
                      (("p1", p1), ("p2", p2), ("prev_n", prev_n),
                       ("prev_t", prev_t)) + aux)
    p1v, ld_p1 = _rows(p1, L, 6, "p1")
    p2v, ld_p2 = _rows(p2, L, 6, "p2")
    pnv, ld_pn = _rows(prev_n, L, p_max, "prev_n")
    ptv, ld_pt = _rows(prev_t, L, p_max * s_len, "prev_t")
    if biased:
        auxv, ld_aux = _rows(pose1, L, 8, "pose1")
        p2pose, ld_pose2 = _rows(pose2, L, 8, "pose2")
        pose2_ptr = p2pose.data_ptr()
    else:
        auxv, ld_aux = _rows(n_rhs_wo, L, p_max, "n_rhs_wo")
        pose2_ptr, ld_pose2 = None, 0
    new_n = torch.empty((L, p_max), device=dev)
    new_t = torch.empty((L, p_max, s_len), device=dev)
    d1 = torch.empty((L, 6), device=dev)
    d2 = torch.empty((L, 6), device=dev)
    rhs_wo = torch.empty((L, p_max), device=dev) if biased else None
    lib = cuda_build.load("gs_math")
    fn = lib.gs_math_rhs_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(p_max, int(biased), L, win.data_ptr(), ld_win, kstage, offs,
             num_points.data_ptr(), active.data_ptr(),
             p1v.data_ptr(), ld_p1, p2v.data_ptr(), ld_p2,
             pnv.data_ptr(), ld_pn, ptv.data_ptr(), ld_pt,
             auxv.data_ptr(), ld_aux, pose2_ptr, ld_pose2,
             new_n.data_ptr(), new_t.data_ptr(), d1.data_ptr(),
             d2.data_ptr(), None if rhs_wo is None else rhs_wo.data_ptr(),
             *[float(c) for c in consts], stream)
    if err != 0:
        raise RuntimeError(f"gs_math kernel launch failed: error {err}")
    LAUNCHES += 1
    res = (new_n, new_t, d1, d2)
    return res + (rhs_wo,) if biased else res


def gs_math_block_rhs(win2d, meta, num_points, active, p1, p2, prev_n,
                      prev_t, *, mode: str, consts: tuple, pose1=None,
                      pose2=None, n_rhs_wo=None, p_max: int, s_len: int):
    """GS impulse update of one rung with in-kernel rhs relinearization.

    ``win2d`` [L, K] packed fields (``meta``: name → (column, tail)),
    ``num_points`` [L], ``active`` [L] bool, ``p1``/``p2`` [L, 6] the
    sides' velocities, ``prev_n`` [L, P], ``prev_t`` [L, P, S].
    ``mode`` "biased" rebuilds n_rhs/t_rhs from ``pose1``/``pose2`` [L, 8]
    and also returns ``rhs_wo`` [L, P]; "unbiased" consumes ``n_rhs_wo``
    [L, P] and the packed t_rhs_wo_bias with cfm = 1.
    ``consts`` = (inv_dt, erp_inv_dt, allowed_err, max_corr, cfm_factor).
    Returns row-major (new_n, new_t, d1 [L, 6], d2 [L, 6][, rhs_wo])."""
    if mode not in ("biased", "unbiased"):
        raise ValueError(f"gs_math_block_rhs: unknown mode {mode!r}")
    kw = dict(mode=mode, consts=consts, pose1=pose1, pose2=pose2,
              n_rhs_wo=n_rhs_wo, p_max=p_max, s_len=s_len)
    if win2d.device.type == "cuda":
        return _launch(win2d, meta, num_points, active, p1, p2, prev_n,
                       prev_t, **kw)
    if win2d.device.type == "cpu":
        return _gs_math_rhs_torch(win2d, meta, num_points, active, p1, p2,
                                  prev_n, prev_t, **kw)
    raise ValueError(f"gs_math_block_rhs: unsupported device {win2d.device}")


def _launch_block(win2d, meta, cfm_factor, n_rhs, t_rhs, num_points, active,
                  p1, p2, prev_n, prev_t, *, p_max, s_len):
    global LAUNCHES_BLOCK
    from wgmath_tpu_torch.core import cuda_build

    L, K = win2d.shape
    dev = win2d.device
    offs, kstage = _column_offsets("gs_math_block", win2d, meta,
                                   UPDATE_FIELDS, p_max, s_len)
    win, ld_win = _rows(win2d, L, K, "win2d")
    _check_row_inputs("gs_math_block", L, dev, num_points, active,
                      (("cfm_factor", cfm_factor), ("n_rhs", n_rhs),
                       ("t_rhs", t_rhs), ("p1", p1), ("p2", p2),
                       ("prev_n", prev_n), ("prev_t", prev_t)))
    cfv, ld_cf = _rows(cfm_factor, L, 1, "cfm_factor")
    nrv, ld_nr = _rows(n_rhs, L, p_max, "n_rhs")
    trv, ld_tr = _rows(t_rhs, L, p_max * s_len, "t_rhs")
    p1v, ld_p1 = _rows(p1, L, 6, "p1")
    p2v, ld_p2 = _rows(p2, L, 6, "p2")
    pnv, ld_pn = _rows(prev_n, L, p_max, "prev_n")
    ptv, ld_pt = _rows(prev_t, L, p_max * s_len, "prev_t")
    new_n = torch.empty((L, p_max), device=dev)
    new_t = torch.empty((L, p_max, s_len), device=dev)
    d1 = torch.empty((L, 6), device=dev)
    d2 = torch.empty((L, 6), device=dev)
    lib = cuda_build.load("gs_math_block")
    fn = lib.gs_math_block_launch
    fn.argtypes = _ARGTYPES_BLOCK
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(p_max, L, win.data_ptr(), ld_win, kstage, offs,
             cfv.data_ptr(), ld_cf, nrv.data_ptr(), ld_nr,
             trv.data_ptr(), ld_tr, num_points.data_ptr(),
             active.data_ptr(), p1v.data_ptr(), ld_p1, p2v.data_ptr(), ld_p2,
             pnv.data_ptr(), ld_pn, ptv.data_ptr(), ld_pt,
             new_n.data_ptr(), new_t.data_ptr(), d1.data_ptr(),
             d2.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gs_math_block kernel launch failed: error "
                           f"{err}")
    LAUNCHES_BLOCK += 1
    return new_n, new_t, d1, d2


def gs_math_block(win2d, meta, view, active, p1, p2, prev_n, prev_t, *,
                  p_max: int, s_len: int):
    """GS impulse update of one rung with the substep's rhs passed in.

    ``win2d`` [L, K] packed fields (``meta``: name → (column, tail); the
    rhs-relinearization columns need not be there), ``view`` carries the
    per-substep ``cfm_factor`` [L], ``n_rhs`` [L, P], ``t_rhs`` [L, P, S]
    and ``num_points`` [L]; ``active`` [L] bool, ``p1``/``p2`` [L, 6] the
    sides' velocities, ``prev_n`` [L, P], ``prev_t`` [L, P, S]. Returns
    row-major (new_n [L, P], new_t [L, P, S], d1 [L, 6], d2 [L, 6])."""
    args = (win2d, meta, view.cfm_factor, view.n_rhs, view.t_rhs,
            view.num_points, active, p1, p2, prev_n, prev_t)
    if win2d.device.type == "cuda":
        return _launch_block(*args, p_max=p_max, s_len=s_len)
    if win2d.device.type == "cpu":
        return _gs_math_torch(*args, p_max=p_max, s_len=s_len)
    raise ValueError(f"gs_math_block: unsupported device {win2d.device}")


# ---------------------------------------------------------------------------
# One launch per sweep
# ---------------------------------------------------------------------------


def rows_per_chunk(p_max: int) -> int:
    """Rows of one sweep chunk (``csrc/gs_sweep.cuh`` ``rows_per_chunk``)."""
    return 128 if p_max == 1 else 32


class Rung(NamedTuple):
    """One non-empty rung of a :class:`SweepPlan` (host ints)."""

    colour: int  # its colour (1-based)
    start: int  # first constraint row of its window
    window: int  # window width w
    w_off: int  # W_c, the windows before it: its sides sit at 2·W_c
    rows: int  # class slots it runs, min(count, w)
    chunk0: int  # its chunks: [chunk0, chunk1)
    chunk1: int


@dataclasses.dataclass
class SweepPlan:
    """One solve's sweep table, built once per solve by
    ``solver.build_sweep_plan`` (substep-invariant).

    ``chunks`` int32 [n, 4]: first constraint row, rows, first a-side,
    first b-side of each chunk, in ladder order; a chunk never crosses a
    rung and holds only the rung's class slots. ``sides`` int32
    [2·sum(windows), 4], one entry per side of every window slot (rung c's
    a-sides at ``2·W_c + slot``, its b-sides ``w`` further): the buffer row
    it reads, the buffer row it writes (-1: none), the side whose write it
    waits for (-1: none) and 2 x its body + the row's active flag.
    ``rungs`` (host): a :class:`Rung` per non-empty rung. ``ready`` int32
    [2·sum(windows) + 1]: each side's readiness flag, then the chunk
    ticket; the kernels keep the ticket at 0 between launches and never
    clear a flag, because each sweep waits for its own ``epoch``, which
    the wrappers raise by one a sweep."""

    chunks: torch.Tensor
    sides: torch.Tensor
    rungs: tuple[Rung, ...]
    p_max: int
    ready: torch.Tensor
    epoch: int = 0


def _next_epoch(plan: SweepPlan):
    """(flags, ticket) pointers and the epoch of the plan's next sweep."""
    plan.epoch += 1
    n = plan.sides.shape[0]
    return plan.ready.data_ptr(), plan.ready[n:].data_ptr(), plan.epoch


def _check_sweep(kernel: str, plan: SweepPlan, win2d, num_points, buf, imp,
                 width: int, imp_cols: int, p_max: int):
    dev = win2d.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} sweep: CUDA tensors only (the plain "
                         f"sweep is solver._sweep_torch), got {dev}")
    if plan.p_max != p_max:
        raise ValueError(f"{kernel} sweep: plan for p_max={plan.p_max}, "
                         f"impulses for p_max={p_max}")
    for nm, t, dt in (("plan.chunks", plan.chunks, torch.int32),
                      ("plan.sides", plan.sides, torch.int32),
                      ("plan.ready", plan.ready, torch.int32),
                      ("num_points", num_points, torch.int64)):
        if t.device != dev or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{kernel} sweep: {nm} must be a contiguous "
                             f"{dt} tensor on {dev}")
    total = win2d.shape[0]
    if num_points.shape != (total,):
        raise ValueError(f"{kernel} sweep: num_points must be [{total}]")
    if plan.ready.shape != (plan.sides.shape[0] + 1,):
        raise ValueError(f"{kernel} sweep: plan.ready must hold one flag "
                         "a side and the ticket")
    for nm, t, rows, cols in (("buf", buf, None, width),
                              ("imp", imp, total, imp_cols)):
        if t.device != dev or t.dtype != torch.float32 or t.dim() != 2 \
                or t.shape[1] != cols or t.stride(1) != 1 \
                or (rows is not None and t.shape[0] != rows):
            raise ValueError(f"{kernel} sweep: {nm} must be a float32 "
                             f"[{rows or 'rows'}, {cols}] matrix with "
                             f"contiguous rows on {dev}")


def _launch_ranges(plan: SweepPlan, rung_by_rung: bool):
    """(first chunk, chunks) of each launch; none for a sweep with no class
    row."""
    if rung_by_rung:
        return [(r.chunk0, r.chunk1 - r.chunk0) for r in plan.rungs
                if r.chunk1 > r.chunk0]
    return [(0, plan.chunks.shape[0])] if plan.chunks.shape[0] else []


_SWEEP_HEAD = [ctypes.c_void_p] * 4 + [ctypes.c_uint, ctypes.c_int,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]
_ARGTYPES_SWEEP = ([ctypes.c_int] * 2 + _SWEEP_HEAD
                   + [ctypes.c_void_p] + [ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_float] * 5 + [ctypes.c_void_p])
_ARGTYPES_SWEEP_BLOCK = ([ctypes.c_int] + _SWEEP_HEAD
                         + [ctypes.c_void_p, ctypes.c_int] * 3
                         + [ctypes.c_void_p]
                         + [ctypes.c_void_p, ctypes.c_int] * 2
                         + [ctypes.c_void_p])


def gs_sweep_rhs(plan: SweepPlan, win2d, meta, num_points, buf, imp, *,
                 mode: str, consts: tuple, p_max: int, s_len: int,
                 pose=None, rung_by_rung: bool = False) -> None:
    """One chained GS sweep with the rhs rebuilt in kernel: every rung of
    ``plan`` in one launch of ``csrc/gs_math.cu`` (``rung_by_rung``: one
    launch per rung, the same kernel, for checking the ordering).

    In place: ``buf`` [n + 2·sum(w), 6] the velocity stream; ``imp``
    [C, P·(1+S) + P] the merged impulse matrix whose last P columns are
    the rhs_wo_bias store (written biased, read unbiased). ``pose`` [n, 8]
    (rotation xyzw, translation, scale) the bodies' poses, which "biased"
    reads. ``win2d`` [C, K] the packed fields of every row, ``num_points``
    [C]. ``consts`` as for :func:`gs_math_block_rhs`."""
    global LAUNCHES
    from wgmath_tpu_torch.core import cuda_build

    if mode not in ("biased", "unbiased"):
        raise ValueError(f"gs_sweep_rhs: unknown mode {mode!r}")
    biased = mode == "biased"
    offs, kstage = _column_offsets("gs_math", win2d, meta, PACK_FIELDS,
                                   p_max, s_len)
    _check_sweep("gs_math", plan, win2d, num_points, buf, imp, 6,
                 p_max * (2 + s_len), p_max)
    if biased and (pose is None or pose.device != win2d.device
                   or pose.dtype != torch.float32 or pose.dim() != 2
                   or pose.shape[1] != 8 or not pose.is_contiguous()):
        raise ValueError("gs_math sweep: biased needs pose, a contiguous "
                         f"float32 [bodies, 8] matrix on {win2d.device}")
    win, ld_win = _rows(win2d, win2d.shape[0], win2d.shape[1], "win2d")
    ready, ticket, epoch = _next_epoch(plan)
    lib = cuda_build.load("gs_math")
    fn = lib.gs_math_rhs_sweep
    fn.argtypes = _ARGTYPES_SWEEP
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(win2d.device).cuda_stream
    for chunk0, nchunks in _launch_ranges(plan, rung_by_rung):
        err = fn(p_max, int(biased), plan.chunks.data_ptr(),
                 plan.sides.data_ptr(), ready, ticket, epoch, chunk0,
                 nchunks, win.data_ptr(), ld_win, kstage, offs,
                 num_points.data_ptr(), buf.data_ptr(), buf.stride(0),
                 pose.data_ptr() if biased else None, imp.data_ptr(),
                 imp.stride(0), *[float(c) for c in consts], stream)
        if err != 0:
            raise RuntimeError(f"gs_math sweep launch failed: error {err}")
        LAUNCHES += 1


def gs_sweep_block(plan: SweepPlan, win2d, meta, cfm_factor, n_rhs, t_rhs,
                   num_points, buf, imp, *, p_max: int, s_len: int,
                   rung_by_rung: bool = False) -> None:
    """One GS sweep with the rhs passed in (the ladder, or the chained
    stream, as ``plan`` says): every rung in one launch of
    ``csrc/gs_math_block.cu`` (``rung_by_rung``: one launch per rung).

    In place: ``buf`` [rows, 6] the velocity buffer (the ladder's body
    table, or the chained stream), ``imp`` [C, P·(1+S)] the merged impulse
    matrix. ``cfm_factor`` [C], ``n_rhs`` [C, P], ``t_rhs`` [C, P, S] this
    substep's softness and right-hand sides."""
    global LAUNCHES_BLOCK
    from wgmath_tpu_torch.core import cuda_build

    total = win2d.shape[0]
    offs, kstage = _column_offsets("gs_math_block", win2d, meta,
                                   UPDATE_FIELDS, p_max, s_len)
    _check_sweep("gs_math_block", plan, win2d, num_points, buf, imp, 6,
                 p_max * (1 + s_len), p_max)
    for nm, t in (("cfm_factor", cfm_factor), ("n_rhs", n_rhs),
                  ("t_rhs", t_rhs)):
        if t.device != win2d.device:
            raise ValueError(f"gs_math_block sweep: {nm} not on "
                             f"{win2d.device}")
    win, ld_win = _rows(win2d, total, win2d.shape[1], "win2d")
    cfv, ld_cf = _rows(cfm_factor, total, 1, "cfm_factor")
    nrv, ld_nr = _rows(n_rhs, total, p_max, "n_rhs")
    trv, ld_tr = _rows(t_rhs, total, p_max * s_len, "t_rhs")
    ready, ticket, epoch = _next_epoch(plan)
    lib = cuda_build.load("gs_math_block")
    fn = lib.gs_math_block_sweep
    fn.argtypes = _ARGTYPES_SWEEP_BLOCK
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(win2d.device).cuda_stream
    for chunk0, nchunks in _launch_ranges(plan, rung_by_rung):
        err = fn(p_max, plan.chunks.data_ptr(), plan.sides.data_ptr(),
                 ready, ticket, epoch, chunk0,
                 nchunks, win.data_ptr(), ld_win, kstage, offs,
                 cfv.data_ptr(), ld_cf, nrv.data_ptr(), ld_nr,
                 trv.data_ptr(), ld_tr, num_points.data_ptr(),
                 buf.data_ptr(), buf.stride(0), imp.data_ptr(),
                 imp.stride(0), stream)
        if err != 0:
            raise RuntimeError(f"gs_math_block sweep launch failed: error "
                               f"{err}")
        LAUNCHES_BLOCK += 1
