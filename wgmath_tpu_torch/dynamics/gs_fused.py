"""The fused Gauss-Seidel solver: one kernel launch per sweep (counterpart of
``wgmath_tpu/dynamics/gs_fused.py``).

Everything is component-major, ``[rows, lanes]``: the velocity table ``vt``
[8, Wg] (rows 0-2 linear, 3-5 angular, 6-7 zero; one lane per body, lane
``Wg - 1`` a permanently zero trash lane), impulses ``[P, Ctot]`` /
``[P*S, Ctot]``, the window fields ``winT`` [K, Ctot]. The constraints lie
in the static rung-padded colour-major layout of
``compact_contacts(static_windows=...)``: colour k (k = 1..C) at offset
``sum(rungs[:k])`` with ``rungs = (rung0,) + windows``; colour 0 is the
uncoloured residue, never swept. Per colour, ``idx[k-1]`` gathers both
sides' bodies (a-sides at lanes ``[0, rung)``, b-sides at
``[rung, 2 rung)``) and ``inv[k-1]`` maps a body lane to the row that
writes it (a-side j, b-side ``rung + j``; every other lane to the trash
lane): a same-colour scatter is a permutation.

Three kernels (``csrc/gs_fused.cu``), each beside its plain PyTorch version:

- :func:`fused_sweep` (B10, replaces ``_fused_sweep_pallas``): one whole
  sweep over every colour window in one launch, the colours ordered by
  per-body readiness flags;
- :func:`fused_substep1` (B11, replaces ``_substep1_pallas``): impulses
  scaled by the warmstart coefficient, the warmstart of every colour, then
  per colour the rhs rebuilt from the poses and the biased sweep;
- :func:`fused_integrate` (B12, replaces the kernel of ``fused_integrate``):
  the component-major pose update. The step does not launch it: B12 reads
  only B11's velocities, the poses and the COMs, so ``fused_sweep(...,
  integrate=...)`` has B10's opening, which holds those velocities, do the
  same lane arithmetic.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
version. ``LAUNCHES_SWEEP``, ``LAUNCHES_SUBSTEP1`` and
``LAUNCHES_INTEGRATE`` count the launches (the last the standalone B12
only); ``INTEGRATES_IN_SWEEP`` counts the B10 launches that carried an
integrate. B10 and B11 cut their work into
chunks taken from a ticket (:func:`fused_chunks`); a row waits for its
bodies' previous writers (:func:`prev_writers` is the plain version of the
kernels' lookup).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from wgmath_tpu_torch.dynamics.gs_math import (
    PACK_FIELDS,
    UPDATE_FIELDS,
    _point_updates,
    _size,
    pack_meta,
    rows_per_chunk,
)

LAUNCHES_SWEEP = 0
LAUNCHES_SUBSTEP1 = 0
LAUNCHES_INTEGRATE = 0
INTEGRATES_IN_SWEEP = 0

ROWS = 8  # velocity / pose rows: 3 linear + 3 angular + 2 zero
# the rows of the rhs-relinearization source block, in the kernel's order
SRC_FIELDS = ("local_pt_a", "local_pt_b", "info_dist", "info_normal_vel",
              "t_rhs_wo_bias")
MAX_COLORS = 64  # the kernels' window table size


def fused_layout(windows: tuple, rung0: int):
    """Static colour-major rung layout: ``offsets[c]`` is the first row of
    colour c (c = 0 the residue class), ``total = offsets[-1]``."""
    rungs = (rung0,) + tuple(windows)
    offsets = np.concatenate([[0], np.cumsum(rungs)]).astype(np.int32)
    return rungs, offsets, int(offsets[-1])


def gather_width(n_bodies: int, windows: tuple) -> int:
    """Lane width of the velocity / idx / inv tables: every body, both
    sides of the largest window, and the trash lane, rounded up to 128."""
    need = max(n_bodies + 1, 2 * max(windows) + 1 if windows else 1)
    return -(-need // 128) * 128


class FusedTickets(NamedTuple):
    """Tickets of one B10 / B11 launch (``csrc/gs_fused.cu``), R =
    ``rows_per_chunk(p_max)`` rows a chunk, thread t of chunk i on row or
    lane ``i R + t``: colour c's chunks (0-based, the layout's colour
    c + 1) are ``[first[c], first[c + 1])``; the opening's (every lane and
    the residue rows) ``[opening[0], opening[1])``; B11's delta chunks
    (``DELTA_ROWS`` colour rows a thread, from row ``rung0``)
    ``[deltas[0], deltas[1])``. B11: deltas, opening, colours; B10:
    colours, then the opening (nothing waits on it)."""

    first: list
    opening: tuple
    deltas: tuple


DELTA_ROWS = 4  # rows a thread of B11's delta chunks (csrc/gs_fused.cu)


def fused_chunks(windows: tuple, rung0: int, w_g: int, p_max: int,
                 substep: bool) -> FusedTickets:
    """The tickets of a B11 (``substep``) or B10 launch."""
    r = rows_per_chunk(p_max)
    n_open = -(-max(w_g, rung0) // r)
    n_delta = -(-sum(windows) // (r * DELTA_ROWS)) if substep else 0
    first = [n_delta + n_open if substep else 0]
    for w in windows:
        first.append(first[-1] - (-int(w) // r))
    opening = ((n_delta, n_delta + n_open) if substep
               else (first[-1], first[-1] + n_open))
    return FusedTickets(first, opening, (0, n_delta))


def prev_writers(inv, counts, windows: tuple):
    """Plain version of the lookup B10 and B11 make for every row before
    it waits: [C + 1, Wg] int64, entry [c, b] the latest occupied colour
    c' < c (0-based; occupied: ``counts[c' + 1] > 0``) whose inverse
    permutation names a row for body b, or -1. A row of colour c waits for
    that colour's write of its body; row C is the last writer over all
    colours (-1: B10's opening copies the lane)."""
    c, w_g = inv.shape
    dev = inv.device
    rung = torch.as_tensor(windows, dtype=torch.int64, device=dev)[:, None]
    occ = (counts[1:c + 1].to(dev) > 0)[:, None]
    jj = inv.to(torch.int64)
    writes = occ & (jj >= 0) & (jj < 2 * rung)
    colour = torch.arange(c, device=dev)[:, None].expand(c, w_g)
    last = torch.where(writes, colour, -1).cummax(0).values
    return torch.cat([torch.full((1, w_g), -1, device=dev), last])


def _row_maps(windows: tuple, rung0: int, device):
    """Static (colour - 1, rank, rung, in a colour) of every row."""
    rungs, offsets, ctot = fused_layout(windows, rung0)
    col = np.zeros((ctot,), np.int64)
    rank = np.zeros((ctot,), np.int64)
    rung_of = np.zeros((ctot,), np.int64)
    in_color = np.zeros((ctot,), bool)
    for k in range(1, len(windows) + 1):
        off, rung = int(offsets[k]), rungs[k]
        col[off:off + rung] = k - 1
        rank[off:off + rung] = np.arange(rung)
        rung_of[off:off + rung] = rung
        in_color[off:off + rung] = True
    return tuple(torch.as_tensor(x, device=device)
                 for x in (col, rank, rung_of, in_color))


def build_fused_tables(body_a, body_b, dyn_a, dyn_b, valid, *,
                       windows: tuple, rung0: int, w_g: int):
    """Per-colour gather table ``idx`` [C, Wg] and inverse permutation
    ``inv`` [C, Wg] (int32) from the rung-padded colour-major rows."""
    rungs, offsets, ctot = fused_layout(windows, rung0)
    assert body_a.shape[0] == ctot, (body_a.shape, ctot)
    c = len(windows)
    dev = body_a.device
    trash = w_g - 1
    idx = torch.zeros((c, w_g), dtype=torch.int32, device=dev)
    for k in range(1, c + 1):
        off, rung = int(offsets[k]), rungs[k]
        idx[k - 1, :rung] = body_a[off:off + rung].to(torch.int32)
        idx[k - 1, rung:2 * rung] = body_b[off:off + rung].to(torch.int32)
    col, rank, rung_of, in_color = _row_maps(tuple(windows), rung0, dev)
    ok_a = in_color & valid & dyn_a & (body_a < w_g)
    ok_b = in_color & valid & dyn_b & (body_b < w_g)
    # one flat table for every colour; dropped sides land on its last slot
    flat_a = torch.where(ok_a, col * w_g + body_a,
                         torch.full_like(body_a, c * w_g))
    flat_b = torch.where(ok_b, col * w_g + body_b,
                         torch.full_like(body_b, c * w_g))
    inv = torch.full((c * w_g + 1,), trash, dtype=torch.int32, device=dev)
    inv[flat_a] = rank.to(torch.int32)
    inv[flat_b] = (rank + rung_of).to(torch.int32)
    return idx, inv[:c * w_g].reshape(c, w_g)


# ------------------------------ plain math --------------------------------


def _fields_cm(win, meta, rhs_extras, p_max, s_len):
    """Component-major field dict from a [K, rung] window slice."""
    def rows(name, shape):
        a0, tail = meta[name]
        v = win[a0:a0 + _size(tail), :]
        return v.reshape(shape + (v.shape[-1],))

    f = {"dir_a": rows("dir_a", (3,)),
         "tangent_a": rows("tangent_a", (s_len, 3)),
         "im_a": rows("im_a", (3,)), "im_b": rows("im_b", (3,)),
         "limit": rows("limit", (1,)),
         "n_torque_a": rows("n_torque_a", (p_max, 3)),
         "n_torque_b": rows("n_torque_b", (p_max, 3)),
         "n_ii_torque_a": rows("n_ii_torque_a", (p_max, 3)),
         "n_ii_torque_b": rows("n_ii_torque_b", (p_max, 3)),
         "n_r": rows("n_r", (p_max,)),
         "t_torque_a": rows("t_torque_a", (p_max, s_len, 3)),
         "t_torque_b": rows("t_torque_b", (p_max, s_len, 3)),
         "t_ii_torque_a": rows("t_ii_torque_a", (p_max, s_len, 3)),
         "t_ii_torque_b": rows("t_ii_torque_b", (p_max, s_len, 3)),
         "t_r": rows("t_r", (p_max, 3))}
    f["cfm"], f["n_rhs"], f["t_rhs"], f["nump"], f["active"] = rhs_extras
    return f


def _pad_table(x, rows: int, cols: int):
    """Zero-pad [r, c] x to [rows, cols] at the top left."""
    out = torch.zeros((rows, cols), dtype=x.dtype, device=x.device)
    out[:x.shape[0], :x.shape[1]] = x
    return out


def _sweep_color(c, off, rung, w_g, vt, n_imp, t_imp, winT, activeT, numpT,
                 cfmT, n_rhs_w, t_rhs_w, idx_row, inv_row, meta, p_max,
                 s_len):
    """One colour window. ``n_rhs_w`` [P, rung] / ``t_rhs_w`` [P*S, rung]
    are the colour's rhs. Returns (v_add [8, Wg] to add to vt, new_n
    [P, rung], new_t [P*S, rung])."""
    def sl(x):
        return x[:, off:off + rung]

    pp = torch.index_select(vt, 1, idx_row[:2 * rung].long())
    v1l, v1a = pp[0:3, :rung], pp[3:6, :rung]
    v2l, v2a = pp[0:3, rung:], pp[3:6, rung:]
    f = _fields_cm(sl(winT), meta,
                   (cfmT, n_rhs_w.reshape(p_max, rung),
                    t_rhs_w.reshape(p_max, s_len, rung), sl(numpT),
                    sl(activeT)), p_max, s_len)
    prev_n = sl(n_imp).reshape(p_max, rung)
    prev_t = sl(t_imp).reshape(p_max, s_len, rung)
    # the point update (gs_math._point_updates, the plain copy of the
    # kernels' csrc/gs_point_updates.cuh) on row-major views
    rm = {name: f[name].movedim(-1, 0) for name in UPDATE_FIELDS}
    rm["limit"] = f["limit"].reshape(rung)
    new_n, new_t, d1, d2 = _point_updates(
        rm, f["cfm"].reshape(rung), f["n_rhs"].movedim(-1, 0),
        f["t_rhs"].movedim(-1, 0), f["nump"].reshape(rung),
        f["active"].reshape(rung) > 0.5,
        torch.cat([v1l, v1a]).T, torch.cat([v2l, v2a]).T,
        prev_n.movedim(-1, 0), prev_t.movedim(-1, 0), p_max)
    # [6, 2 rung] deltas → a zero-padded [8, Wg] table; the inverse
    # permutation places each body's delta at its lane (trash lane = 0)
    d_pad = _pad_table(torch.cat([d1, d2]).T, ROWS, w_g)
    v_add = torch.index_select(d_pad, 1, inv_row.long())
    return (v_add, new_n.T.reshape(p_max, rung),
            new_t.movedim(0, -1).reshape(p_max * s_len, rung))


def _quat_rot_cm(q, v):
    """Rotate [3, L] v by the [4, L] xyzw quaternion q."""
    u, w = q[0:3], q[3:4]

    def cr(a, b):
        return torch.cat([a[1:2] * b[2:3] - a[2:3] * b[1:2],
                          a[2:3] * b[0:1] - a[0:1] * b[2:3],
                          a[0:1] * b[1:2] - a[1:2] * b[0:1]], dim=0)

    uv = cr(u, v)
    return v + 2.0 * (w * uv + cr(u, uv))


def _sum3(x):
    """Sum over the first axis of 3 rows, left to right (the kernels')."""
    return x[0:1] + x[1:2] + x[2:3]


def _ws_color(off, rung, w_g, n_imp, t_imp, winT, activeT, numpT, inv_row,
              meta, p_max, s_len):
    """Warmstart velocity deltas of one colour window as a [8, Wg] add
    through the inverse permutation."""
    def sl(x):
        return x[:, off:off + rung]

    f = _fields_cm(sl(winT), meta, (None, None, None, sl(numpT),
                                    sl(activeT)), p_max, s_len)
    active = f["active"] > 0.5
    dir_a = f["dir_a"]
    zero = torch.zeros((), device=dir_a.device)
    d1l = torch.zeros_like(dir_a)
    d2l = torch.zeros_like(dir_a)
    d1a = torch.zeros_like(dir_a)
    d2a = torch.zeros_like(dir_a)
    n_t = sl(n_imp).reshape(p_max, rung)
    t_t = sl(t_imp).reshape(p_max, s_len, rung)
    for k in range(p_max):
        m = active & (f["nump"] > k)
        imp = torch.where(m, n_t[k:k + 1], zero)
        d1l = d1l + dir_a * (f["im_a"] * imp)
        d1a = d1a + f["n_ii_torque_a"][k] * imp
        d2l = d2l - dir_a * (f["im_b"] * imp)
        d2a = d2a + f["n_ii_torque_b"][k] * imp
        for j in range(s_len):
            timp = torch.where(m, t_t[k, j:j + 1], zero)
            tj = f["tangent_a"][j]
            d1l = d1l + tj * (f["im_a"] * timp)
            d1a = d1a + f["t_ii_torque_a"][k, j] * timp
            d2l = d2l - tj * (f["im_b"] * timp)
            d2a = d2a + f["t_ii_torque_b"][k, j] * timp
    d12 = torch.cat([torch.cat([d1l, d1a]), torch.cat([d2l, d2a])], dim=1)
    return torch.index_select(_pad_table(d12, ROWS, w_g), 1,
                              inv_row.long())


def _rhs_color(off, rung, poseT, idx_row, winT, rhs_srcT, src_meta, meta,
               p_max, s_len, w_g, *, inv_dt, erp_inv_dt, allowed_err,
               max_corr):
    """The colour's substep rhs relinearized from the poses gathered
    through its index row. Returns (n_rhs [P, rung], n_rhs_wo [P, rung],
    t_rhs [P*S, rung])."""
    pp = torch.index_select(poseT, 1, idx_row[:2 * rung].long())
    q1, t1, s1 = pp[0:4, :rung], pp[4:7, :rung], pp[7:8, :rung]
    q2, t2, s2 = pp[0:4, rung:], pp[4:7, rung:], pp[7:8, rung:]

    def src(name, shape):
        a0, tail = src_meta[name]
        return rhs_srcT[a0:a0 + _size(tail), off:off + rung].reshape(
            shape + (rung,))

    d0 = meta["dir_a"][0]
    dir_a = winT[d0:d0 + 3, off:off + rung]
    ta0 = meta["tangent_a"][0]
    tang = winT[ta0:ta0 + s_len * 3, off:off + rung].reshape(s_len, 3, rung)
    lpa = src("local_pt_a", (p_max, 3))
    lpb = src("local_pt_b", (p_max, 3))
    idist = src("info_dist", (p_max,))
    invel = src("info_normal_vel", (p_max,))
    trwb = src("t_rhs_wo_bias", (p_max, s_len))
    n_rhs, n_wo, t_rhs = [], [], []
    for k in range(p_max):
        drift = (s1 * _quat_rot_cm(q1, lpa[k]) + t1
                 - (s2 * _quat_rot_cm(q2, lpb[k]) + t2))
        dist = idist[k:k + 1] + _sum3(drift * dir_a)
        wo = invel[k:k + 1] + torch.clamp(dist, min=0.0) * inv_dt
        bias = torch.clamp((dist + allowed_err) * erp_inv_dt, -max_corr, 0.0)
        n_rhs.append(wo + bias)
        n_wo.append(wo)
        for j in range(s_len):
            t_rhs.append(trwb[k, j:j + 1] + _sum3(drift * tang[j]) * inv_dt)
    return torch.cat(n_rhs), torch.cat(n_wo), torch.cat(t_rhs)


def _fused_sweep_torch(vt, n_imp, t_imp, winT, activeT, numpT, cfm, n_rhsT,
                       t_rhsT, idx, inv, counts, *, windows, rung0, p_max,
                       s_len, meta):
    """Plain version of kernel B10."""
    w_g = vt.shape[1]
    _, offsets, _ = fused_layout(windows, rung0)
    cfm = float(cfm)
    n_imp, t_imp = n_imp.clone(), t_imp.clone()
    for k, rung in enumerate(windows, start=1):
        if int(counts[k]) <= 0:
            continue
        off = int(offsets[k])
        cfm_w = torch.full((1, rung), cfm, device=vt.device)
        v_add, new_n, new_t = _sweep_color(
            k, off, rung, w_g, vt, n_imp, t_imp, winT, activeT, numpT, cfm_w,
            n_rhsT[:, off:off + rung], t_rhsT[:, off:off + rung],
            idx[k - 1], inv[k - 1], meta, p_max, s_len)
        vt = vt + v_add
        n_imp[:, off:off + rung] = new_n
        t_imp[:, off:off + rung] = new_t
    return vt, n_imp, t_imp


def _substep1_torch(vt, n_imp, t_imp, winT, rhs_srcT, poseT, activeT, numpT,
                    idx, inv, counts, *, windows, rung0, p_max, s_len, meta,
                    src_meta, scalars):
    """Plain version of kernel B11."""
    ws_coeff, cfm, inv_dt, erp_inv_dt, allowed_err, max_corr = scalars
    w_g = vt.shape[1]
    _, offsets, _ = fused_layout(windows, rung0)
    n_imp = n_imp * ws_coeff
    t_imp = t_imp * ws_coeff
    n_wo_out = torch.zeros((p_max, n_imp.shape[1]), device=vt.device)
    live = [(k, int(offsets[k]), rung)
            for k, rung in enumerate(windows, start=1) if int(counts[k]) > 0]
    # warmstart of every colour, added in ascending colour order
    for k, off, rung in live:
        vt = vt + _ws_color(off, rung, w_g, n_imp, t_imp, winT, activeT,
                            numpT, inv[k - 1], meta, p_max, s_len)
    # per colour: the rhs from the poses, then the biased sweep
    for k, off, rung in live:
        n_rhs, n_wo, t_rhs = _rhs_color(
            off, rung, poseT, idx[k - 1], winT, rhs_srcT, src_meta, meta,
            p_max, s_len, w_g, inv_dt=inv_dt, erp_inv_dt=erp_inv_dt,
            allowed_err=allowed_err, max_corr=max_corr)
        n_wo_out[:, off:off + rung] = n_wo
        cfm_w = torch.full((1, rung), cfm, device=vt.device)
        v_add, new_n, new_t = _sweep_color(
            k, off, rung, w_g, vt, n_imp, t_imp, winT, activeT, numpT, cfm_w,
            n_rhs, t_rhs, idx[k - 1], inv[k - 1], meta, p_max, s_len)
        vt = vt + v_add
        n_imp[:, off:off + rung] = new_n
        t_imp[:, off:off + rung] = new_t
    return vt, n_imp, t_imp, n_wo_out


def _cm_quat_mul(a, b):
    ax, ay, az, aw = a[0:1], a[1:2], a[2:3], a[3:4]
    bx, by, bz, bw = b[0:1], b[1:2], b[2:3], b[3:4]
    return torch.cat([aw * bx + ax * bw + ay * bz - az * by,
                      aw * by - ax * bz + ay * bw + az * bx,
                      aw * bz + ax * by - ay * bx + az * bw,
                      aw * bw - ax * bx - ay * by - az * bz], dim=0)


def _cm_integrate(poseP, vt, comT, dt: float):
    """Plain version of kernel B12: component-major semi-implicit Euler
    pose update. ``poseP`` [8, L] = quat 4 + translation 3 + scale 1;
    ``vt`` rows 0:3 linear, 3:6 angular; ``comT`` [3, L] local COM."""
    q, t, s = poseP[0:4], poseP[4:7], poseP[7:8]
    lin, ang = vt[0:3], vt[3:6]
    init_com = s * _quat_rot_cm(q, comT) + t
    v = ang * dt
    angle = torch.sqrt(_sum3(v * v))
    half = 0.5 * angle
    small = angle < 1e-6
    sinc_half = torch.where(small, 0.5 - angle * angle / 48.0,
                            torch.sin(half) / torch.clamp(angle, min=1e-30))
    dq = torch.cat([v * sinc_half, torch.cos(half)], dim=0)
    rotated = _quat_rot_cm(dq, t - init_com)
    new_q = _cm_quat_mul(dq, q)
    new_q = new_q * torch.rsqrt(
        new_q[0:1] * new_q[0:1] + new_q[1:2] * new_q[1:2]
        + new_q[2:3] * new_q[2:3] + new_q[3:4] * new_q[3:4] + 1e-30)
    new_t = init_com + rotated * s + lin * dt
    return torch.cat([new_q, new_t, s], dim=0)


# ------------------------------- wrappers ---------------------------------


def _f32_rows(x, rows: int, lanes: int, what: str):
    """(tensor, row stride) of ``x`` as [rows, lanes] f32 with unit lane
    stride; raises on anything else."""
    if x.dtype != torch.float32 or tuple(x.shape) != (rows, lanes):
        raise ValueError(f"{what}: float32 [{rows}, {lanes}] expected, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if lanes > 1 and x.stride(1) != 1:
        raise ValueError(f"{what}: lanes must be contiguous")
    return x, x.stride(0) if rows > 1 else lanes


def _check_common(kernel, vt, n_imp, t_imp, winT, activeT, numpT, idx, inv,
                  counts, windows, rung0, p_max, s_len, meta):
    """Shapes, types and devices shared by B10 and B11. Returns the layout
    table (first rows, rungs, tickets), the tickets (:func:`fused_chunks`),
    the point update's column table and row count, Ctot, Wg and the row
    strides of n_imp, t_imp and winT."""
    dev = vt.device
    _, offsets, ctot = fused_layout(windows, rung0)
    c = len(windows)
    if s_len != 2 or p_max not in (1, 4):
        raise ValueError(f"{kernel} kernel: (p_max={p_max}, s_len={s_len}) "
                         "not instantiated (p_max 1 or 4, s_len 2)")
    if not 0 < c <= MAX_COLORS:
        raise ValueError(f"{kernel} kernel: 1..{MAX_COLORS} colours")
    w_g = vt.shape[1]
    if w_g <= 2 * max(windows):
        raise ValueError(f"{kernel} kernel: lane width {w_g} cannot hold "
                         "both sides of the largest window and the trash lane")
    for nm, t in (("vt", vt), ("n_imp", n_imp), ("t_imp", t_imp),
                  ("winT", winT), ("activeT", activeT), ("numpT", numpT),
                  ("idx", idx), ("inv", inv), ("counts", counts)):
        if t.device != dev:
            raise ValueError(f"{kernel} kernel: {nm} not on {dev}")
    if not (vt.is_contiguous() and vt.dtype == torch.float32
            and vt.shape[0] == ROWS):
        raise ValueError(f"{kernel} kernel: vt must be contiguous f32 "
                         f"[{ROWS}, Wg]")
    for nm, t, shape in (("idx", idx, (c, w_g)), ("inv", inv, (c, w_g)),
                         ("counts", counts, (c + 2,))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{kernel} kernel: {nm} must be contiguous "
                             f"int32 {shape}")
    lds = (_f32_rows(n_imp, p_max, ctot, "n_imp")[1],
           _f32_rows(t_imp, p_max * s_len, ctot, "t_imp")[1],
           _f32_rows(winT, winT.shape[0], ctot, "winT")[1])
    for nm, t in (("activeT", activeT), ("numpT", numpT)):
        if not (t.is_contiguous() and t.dtype == torch.float32
                and tuple(t.shape) == (1, ctot)):
            raise ValueError(f"{kernel} kernel: {nm} must be contiguous "
                             f"f32 [1, {ctot}]")
    want = _pack_tails(p_max, s_len)
    for name in UPDATE_FIELDS:
        if name not in meta or tuple(meta[name][1]) != want[name]:
            raise ValueError(f"{kernel} kernel: field {name} missing or of "
                             "the wrong shape")
        if not 0 <= int(meta[name][0]) <= winT.shape[0] - _size(want[name]):
            raise ValueError(f"{kernel} kernel: field {name} lies outside "
                             "winT")
    cols = (ctypes.c_int * len(PACK_FIELDS))(
        *[int(meta[nm][0]) if nm in UPDATE_FIELDS else -1
          for nm in PACK_FIELDS])
    k_load = max(int(meta[nm][0]) + _size(want[nm]) for nm in UPDATE_FIELDS)
    chunks = fused_chunks(windows, rung0, w_g, p_max,
                          kernel == "fused_substep1")
    tab = (ctypes.c_int * (3 * c + 5))(
        *[int(offsets[k]) for k in range(1, c + 1)], *windows,
        *chunks.first, *chunks.opening, *chunks.deltas)
    return tab, chunks, cols, k_load, ctot, w_g, lds


def _pack_tails(p_max, s_len):
    return {k: tuple(t) for k, (_, t) in pack_meta(p_max, s_len).items()}


class _Sync:
    """B10 / B11's flags on one device (int32, zeros at first): ``ready``
    a readiness flag per body lane, ``ticket`` the chunk counter (the
    kernels keep it at 0 between launches), ``count`` B11's delta chunks
    done; ``epoch`` the last launch's, ``done`` the count B11's last launch
    reached. Nothing is cleared: each launch waits for values of its own
    epoch, and for its own delta chunks on top of the count before it."""

    def __init__(self, dev, lanes: int, epoch: int):
        buf = torch.zeros(lanes + 2, dtype=torch.int32, device=dev)
        self.ready, self.ticket, self.count = buf[:lanes], \
            buf[lanes:lanes + 1], buf[lanes + 1:]
        self.epoch = epoch
        self.done = 0

    def args(self):
        """(flags, ticket, flag base ``epoch·(MAX_COLORS + 1)``) of the
        current launch."""
        return (self.ready.data_ptr(), self.ticket.data_ptr(),
                self.epoch * (MAX_COLORS + 1) % 2 ** 32)


_SYNCS: dict = {}


def _sync(dev, w_g: int) -> _Sync:
    """The flags of ``dev``, raised to the next launch's epoch. Launches
    on one stream run one after another, so one set serves them all."""
    sync = _SYNCS.get(dev)
    if sync is None or sync.ready.shape[0] < w_g:
        sync = _SYNCS[dev] = _Sync(dev, w_g, sync.epoch if sync else 0)
    sync.epoch += 1
    return sync


def _launch_ranges(chunks: FusedTickets, colour_by_colour: bool):
    """(first ticket, tickets) of each launch: one for every chunk, or one
    for the opening (with B11's delta chunks) and one a colour, in ticket
    order."""
    first, (open0, open1), (delta0, delta1) = chunks
    if not colour_by_colour:
        return [(0, max(first[-1], open1))]
    ranges = [(a, b - a) for a, b in zip(first, first[1:])]
    start = delta0 if delta1 > delta0 else open0
    opening = [(start, open1 - start)]
    return opening + ranges if start == 0 else ranges + opening


_I, _P, _F, _U = ctypes.c_int, ctypes.c_void_p, ctypes.c_float, ctypes.c_uint
# the C entry points' parameters, in order (csrc/gs_fused.cu)
# flags, ticket, flag base, first ticket, tickets, stream
_SYNC_ARGTYPES = [_P, _P, _U, _I, _I, _P]
_SWEEP_ARGTYPES = [_I, _I, _P, _I, _I, _I, _P,  # layout, column table
                   _P, _P, _P, _I, _P, _I, _P, _P,  # vt, impulses in / out
                   _P, _I, _P, _P, _F,  # winT, active, nump, cfm
                   _P, _I, _P, _I,  # n_rhsT, t_rhsT
                   _P, _P, _P, _F,  # integrate: poses, COMs, new poses, dt
                   _P, _P, _P] + _SYNC_ARGTYPES  # idx, inv, counts
_SUBSTEP1_ARGTYPES = [_I, _I, _P, _I, _I, _I, _P, _P,
                      _P, _P, _P, _I, _P, _I, _P, _P, _P,
                      _P, _I, _P, _I, _P, _P, _P,  # winT, srcT, pose, ...
                      _P, _P, _P] + [_F] * 6 + [_P, _P, _U] + _SYNC_ARGTYPES
_INTEGRATE_ARGTYPES = [_I, _P, _P, _P, _P, _F, _P]

# blocks of the last launch of each (one a chunk: every ticket of the sweep
# in one launch), for reports
LAST_GRID = {"fused_sweep": 0, "fused_substep1": 0}


def _integrate_operands(integrate, w_g: int, dev):
    """(poses, COMs, new poses, dt) pointers and values of B10's carried
    integrate: ``integrate`` = (poseP [8, Wg], comT [3, Wg], dt), or None
    for null pointers."""
    if integrate is None:
        return None, (None, None, None, 0.0)
    pose, com, dt = integrate
    for nm, t, rows in (("poseP", pose, ROWS), ("comT", com, 3)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (rows, w_g) or not t.is_contiguous()):
            raise ValueError(f"fused_sweep kernel: integrate's {nm} must be "
                             f"contiguous f32 [{rows}, {w_g}] on {dev}")
    out = torch.empty_like(pose)
    return out, (pose.data_ptr(), com.data_ptr(), out.data_ptr(), float(dt))


def _launch_sweep(vt, n_imp, t_imp, winT, activeT, numpT, cfm, n_rhsT,
                  t_rhsT, idx, inv, counts, *, windows, rung0, p_max, s_len,
                  meta, integrate=None, colour_by_colour: bool = False):
    """Kernel B10, carrying B12 in its opening when ``integrate`` is given
    (``colour_by_colour``: the same kernel launched once a colour and once
    for the opening, in ticket order and under one epoch, for checking the
    order)."""
    global LAUNCHES_SWEEP, INTEGRATES_IN_SWEEP
    from wgmath_tpu_torch.core import cuda_build

    tab, chunks, cols, k_load, ctot, w_g, (ld_n, ld_t, ld_w) = _check_common(
        "fused_sweep", vt, n_imp, t_imp, winT, activeT, numpT, idx, inv,
        counts, windows, rung0, p_max, s_len, meta)
    dev = vt.device
    for nm, t in (("n_rhsT", n_rhsT), ("t_rhsT", t_rhsT)):
        if t.device != dev:
            raise ValueError(f"fused_sweep kernel: {nm} not on {dev}")
    _, ld_nr = _f32_rows(n_rhsT, p_max, ctot, "n_rhsT")
    _, ld_tr = _f32_rows(t_rhsT, p_max * s_len, ctot, "t_rhsT")
    v_out = torch.empty_like(vt)
    n_out = torch.empty((p_max, ctot), device=dev)
    t_out = torch.empty((p_max * s_len, ctot), device=dev)
    pose_out, integ = _integrate_operands(integrate, w_g, dev)
    lib = cuda_build.load("gs_fused")
    fn = lib.fused_sweep_launch
    fn.argtypes = _SWEEP_ARGTYPES
    fn.restype = ctypes.c_int
    ready, ticket, base = _sync(dev, w_g).args()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for chunk0, nchunks in _launch_ranges(chunks, colour_by_colour):
        err = fn(p_max, len(windows), tab, w_g, ctot, k_load, cols,
                 vt.data_ptr(), v_out.data_ptr(), n_imp.data_ptr(), ld_n,
                 t_imp.data_ptr(), ld_t, n_out.data_ptr(), t_out.data_ptr(),
                 winT.data_ptr(), ld_w, activeT.data_ptr(),
                 numpT.data_ptr(), float(cfm), n_rhsT.data_ptr(), ld_nr,
                 t_rhsT.data_ptr(), ld_tr, *integ, idx.data_ptr(),
                 inv.data_ptr(), counts.data_ptr(), ready, ticket, base,
                 chunk0, nchunks, stream)
        if err != 0:
            raise RuntimeError(f"fused_sweep kernel launch failed: error "
                               f"{err}")
        LAUNCHES_SWEEP += 1
        LAST_GRID["fused_sweep"] = nchunks
        if pose_out is not None and \
                chunk0 <= chunks.opening[0] < chunk0 + nchunks:
            INTEGRATES_IN_SWEEP += 1
    if pose_out is None:
        return v_out, n_out, t_out
    return v_out, n_out, t_out, pose_out


def _fused_sweep_plain(vt, n_imp, t_imp, winT, activeT, numpT, cfm, n_rhsT,
                       t_rhsT, idx, inv, counts, *, integrate=None, **kw):
    """Plain version of B10 with its carried integrate:
    :func:`_fused_sweep_torch`, then :func:`_cm_integrate` on the same
    input velocities."""
    out = _fused_sweep_torch(vt, n_imp, t_imp, winT, activeT, numpT, cfm,
                             n_rhsT, t_rhsT, idx, inv, counts, **kw)
    if integrate is None:
        return out
    pose, com, dt = integrate
    return out + (_cm_integrate(pose, vt, com, float(dt)),)


def fused_sweep(vt, n_imp, t_imp, winT, activeT, numpT, cfm, n_rhsT, t_rhsT,
                idx, inv, counts, *, windows: tuple, rung0: int, p_max: int,
                s_len: int, meta, integrate=None):
    """One full GS sweep over every colour window.

    ``vt`` [8, Wg] velocities; ``n_imp`` [P, Ctot] / ``t_imp`` [P*S, Ctot]
    impulses; ``winT`` [K, Ctot] the window fields (``meta``: name → (first
    row, trailing shape)); ``activeT`` / ``numpT`` [1, Ctot]; ``cfm`` a
    scalar; ``n_rhsT`` [P, Ctot] / ``t_rhsT`` [P*S, Ctot]; ``idx`` / ``inv``
    [C, Wg] int32; ``counts`` [C+2] class sizes (a colour with count 0 is
    skipped). Returns the updated (vt, n_imp, t_imp).

    ``integrate`` = (poseP [8, Wg], comT [3, Wg], dt): also the pose update
    of :func:`fused_integrate` from the input ``vt``, appended to the
    outputs as a new [8, Wg] tensor. Kernel B10, carrying B12's arithmetic
    in its opening, on a CUDA tensor; :func:`_fused_sweep_torch` and
    :func:`_cm_integrate` on a CPU tensor."""
    args = (vt, n_imp, t_imp, winT, activeT, numpT, cfm, n_rhsT, t_rhsT,
            idx, inv, counts)
    kw = dict(windows=tuple(windows), rung0=rung0, p_max=p_max, s_len=s_len,
              meta=meta, integrate=integrate)
    if vt.device.type == "cuda":
        return _launch_sweep(*args, **kw)
    if vt.device.type == "cpu":
        return _fused_sweep_plain(*args, **kw)
    raise ValueError(f"fused_sweep: unsupported device {vt.device}")


def _launch_substep1(vt, n_imp, t_imp, winT, rhs_srcT, poseT, activeT, numpT,
                     idx, inv, counts, *, windows, rung0, p_max, s_len, meta,
                     src_meta, scalars, colour_by_colour: bool = False):
    """Kernel B11 (``colour_by_colour`` as for :func:`_launch_sweep`)."""
    global LAUNCHES_SUBSTEP1
    from wgmath_tpu_torch.core import cuda_build

    tab, chunks, cols, k_load, ctot, w_g, (ld_n, ld_t, ld_w) = _check_common(
        "fused_substep1", vt, n_imp, t_imp, winT, activeT, numpT, idx, inv,
        counts, windows, rung0, p_max, s_len, meta)
    dev = vt.device
    for nm, t in (("rhs_srcT", rhs_srcT), ("poseT", poseT)):
        if t.device != dev:
            raise ValueError(f"fused_substep1 kernel: {nm} not on {dev}")
    if not (poseT.is_contiguous() and poseT.dtype == torch.float32
            and tuple(poseT.shape) == (ROWS, w_g)):
        raise ValueError(f"fused_substep1 kernel: poseT must be contiguous "
                         f"f32 [{ROWS}, {w_g}]")
    want = _pack_tails(p_max, s_len)
    for name in SRC_FIELDS:
        if name not in src_meta or tuple(src_meta[name][1]) != want[name] \
                or not 0 <= int(src_meta[name][0]) \
                <= rhs_srcT.shape[0] - _size(want[name]):
            raise ValueError(f"fused_substep1 kernel: source field {name} "
                             "missing, of the wrong shape or outside "
                             "rhs_srcT")
    src_cols = (ctypes.c_int * len(SRC_FIELDS))(
        *[int(src_meta[nm][0]) for nm in SRC_FIELDS])
    _, ld_s = _f32_rows(rhs_srcT, rhs_srcT.shape[0], ctot, "rhs_srcT")
    v_out = torch.empty_like(vt)
    n_out = torch.empty((p_max, ctot), device=dev)
    t_out = torch.empty((p_max * s_len, ctot), device=dev)
    nwo = torch.empty((p_max, ctot), device=dev)
    # each row's two warmstart deltas, 8 floats a side (DELTA_LD)
    wsd = torch.empty((ctot, 2, 8), device=dev)
    lib = cuda_build.load("gs_fused")
    fn = lib.fused_substep1_launch
    fn.argtypes = _SUBSTEP1_ARGTYPES
    fn.restype = ctypes.c_int
    sync = _sync(dev, w_g)
    ready, ticket, base = sync.args()
    done = (sync.done + chunks.deltas[1] - chunks.deltas[0]) % 2 ** 32
    stream = torch.cuda.current_stream(dev).cuda_stream
    for chunk0, nchunks in _launch_ranges(chunks, colour_by_colour):
        err = fn(p_max, len(windows), tab, w_g, ctot, k_load, cols,
                 src_cols, vt.data_ptr(), v_out.data_ptr(), n_imp.data_ptr(),
                 ld_n, t_imp.data_ptr(), ld_t, n_out.data_ptr(),
                 t_out.data_ptr(), nwo.data_ptr(), winT.data_ptr(), ld_w,
                 rhs_srcT.data_ptr(), ld_s, poseT.data_ptr(),
                 activeT.data_ptr(), numpT.data_ptr(), idx.data_ptr(),
                 inv.data_ptr(), counts.data_ptr(),
                 *[float(x) for x in scalars], wsd.data_ptr(),
                 sync.count.data_ptr(), done, ready, ticket,
                 base, chunk0, nchunks, stream)
        if err != 0:
            raise RuntimeError(f"fused_substep1 kernel launch failed: "
                               f"error {err}")
        LAUNCHES_SUBSTEP1 += 1
        LAST_GRID["fused_substep1"] = nchunks
    sync.done = done
    return v_out, n_out, t_out, nwo


def fused_substep1(vt, n_imp, t_imp, winT, rhs_srcT, poseT, activeT, numpT,
                   idx, inv, counts, *, windows: tuple, rung0: int,
                   p_max: int, s_len: int, meta, src_meta, scalars):
    """Substep opening: impulses scaled by ``ws_coeff``, the warmstart of
    every colour added to ``vt`` in ascending colour order, then per colour
    the rhs rebuilt from ``poseT`` ([8, Wg]: quat 4 + translation 3 +
    scale 1) and the BIASED sweep. Returns (vt, n_imp, t_imp, n_rhs_wo_bias
    [P, Ctot]); the last feeds the unbiased :func:`fused_sweep`.

    ``rhs_srcT`` holds the relinearization fields (``src_meta``: name →
    (first row, trailing shape)); ``scalars`` = (ws_coeff, cfm, inv_dt,
    erp_inv_dt, allowed_err, max_corr). The residue class (colour 0) is not
    warmstarted here: its rows can share bodies, so the caller applies
    them. Kernel B11 on a CUDA tensor, :func:`_substep1_torch` on a CPU
    tensor."""
    args = (vt, n_imp, t_imp, winT, rhs_srcT, poseT, activeT, numpT, idx,
            inv, counts)
    kw = dict(windows=tuple(windows), rung0=rung0, p_max=p_max, s_len=s_len,
              meta=meta, src_meta=src_meta,
              scalars=tuple(float(x) for x in scalars))
    if vt.device.type == "cuda":
        return _launch_substep1(*args, **kw)
    if vt.device.type == "cpu":
        return _substep1_torch(*args, **kw)
    raise ValueError(f"fused_substep1: unsupported device {vt.device}")


def _launch_integrate(poseP, vt, comT, dt):
    global LAUNCHES_INTEGRATE
    from wgmath_tpu_torch.core import cuda_build

    dev = poseP.device
    lanes = poseP.shape[-1]
    for nm, t, rows in (("poseP", poseP, ROWS), ("vt", vt, ROWS),
                        ("comT", comT, 3)):
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != (rows, lanes) or not t.is_contiguous()):
            raise ValueError(f"fused_integrate kernel: {nm} must be "
                             f"contiguous f32 [{rows}, {lanes}] on {dev}")
    out = torch.empty_like(poseP)
    lib = cuda_build.load("gs_fused")
    fn = lib.fused_integrate_launch
    fn.argtypes = _INTEGRATE_ARGTYPES
    fn.restype = ctypes.c_int
    err = fn(lanes, poseP.data_ptr(), vt.data_ptr(), comT.data_ptr(),
             out.data_ptr(), float(dt),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_integrate kernel launch failed: error "
                           f"{err}")
    LAUNCHES_INTEGRATE += 1
    return out


def fused_integrate(poseP, vt, comT, dt):
    """Component-major pose update: ``poseP`` [8, L], ``vt`` [8, L],
    ``comT`` [3, L] → the new [8, L] poses. Kernel B12 on a CUDA tensor,
    :func:`_cm_integrate` on a CPU tensor. The fused step has
    :func:`fused_sweep` carry it instead."""
    if poseP.device.type == "cuda":
        return _launch_integrate(poseP, vt, comT, dt)
    if poseP.device.type == "cpu":
        return _cm_integrate(poseP, vt, comT, float(dt))
    raise ValueError(f"fused_integrate: unsupported device {poseP.device}")
