"""Contact solver (counterpart of ``wgmath_tpu/dynamics/solver.py``:
colouring, warmstart, the colour-major layout and chain, the Gauss-Seidel
sweeps under the ``gs_windows`` ladder or uniform / split windows, and the
pseudo-Jacobi solver).

- **Colouring** (``color_pairs`` on the broad phase's pairs,
  ``color_constraints`` in the solve): per colour, a few Luby claim
  rounds; each candidate edge scatter-mins a hashed priority into its
  dynamic bodies and wins when it owns both. The hash is the JAX
  package's uint32 arithmetic, emulated in int64 with a 32-bit mask after
  every step. ``minimize_colors`` then drains high classes into low ones.
- **Layout**: constraints in colour-major order; colour c's class is the
  window ``[offsets[c], offsets[c] + windows[c-1])``. Pair-slot and
  colour-compacted contacts arrive in that order
  (``pad_solver_fields_packed``); otherwise one sort and one row gather put
  them there (``build_color_layout``, ``sort_solver_fields_packed``).
- **Sweeps** (``gs_color_major_pass``), one impulse kernel launch per
  sweep on the card: the *ladder* reads both sides' velocities by body
  index and adds each active dynamic side's delta back onto its body row;
  the *chained* sweep keeps velocities in a stream (body table + one
  2w-row segment per colour), reads through the cached last-writer chain
  and writes each side where the chain advances to its own stream row.
  ``build_sweep_plan`` turns the ladder into one table per solve: the
  rungs cut into chunks of their class rows, and for every side the row
  it reads, the row it writes and the earlier side whose write it waits
  for (the chain's ``src``; for the ladder each body's previous writer).
  The kernel orders the rungs by those per-side readiness flags, not by
  launch boundaries (``csrc/gs_sweep.cuh``). The rhs comes from
  ``update_rhs_sorted`` once per substep (``gs_math.gs_sweep_block``) or,
  with rhs-in-rung, is rebuilt in the kernel from the bodies' poses
  (``gs_math.gs_sweep_rhs``). On CPU tensors ``_sweep_torch`` runs the
  same table rung by rung through the plain row math. Without a ladder
  every colour sweeps a uniform window (the split windows: a narrower one
  past ``gs_split``); ``uniform_windows`` turns that into a ladder of the
  rows each class really runs, so it is the same one launch a sweep.
- **Jacobi** (``jacobi_pass``): each body walks its constraint sides
  (``build_body_constraint_csr``) against a snapshot of the others, in
  plain PyTorch, as the JAX package runs it in XLA.
- **Joints** (``JointSolve``, ``dynamics/joint.py``): per substep a joint
  build and pass before the biased contact sweep, another pass after
  integrating, in the joints' own colours.

Every ``lax.cond`` of the JAX solve is a Python branch on a host value.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

from wgmath_tpu_torch.core import collectives
from wgmath_tpu_torch.core.dispatch import host_int, host_list, to_device
from wgmath_tpu_torch.dynamics.body import (
    Bodies,
    Velocity,
    WorldMassProperties,
    integrate_velocity,
)
from wgmath_tpu_torch.dynamics.build_fused import (
    F32_SORT_FIELDS,
    build_constraints_fused,
)
from wgmath_tpu_torch.dynamics.constraint import (
    ContactConstraints,
    Contacts,
    build_constraints,
    remove_cfm_and_bias,
    update_constraints,
    update_rhs_sorted,
)
from wgmath_tpu_torch.dynamics.gs_fused import (
    build_fused_tables,
    fused_layout,
    fused_substep1,
    fused_sweep,
    gather_width,
)
from wgmath_tpu_torch.dynamics.gs_math import (
    PACK_FIELDS,
    UPDATE_FIELDS,
    Rung,
    SweepPlan,
    _gs_math_rhs_torch,
    _gs_math_torch,
    _point_updates,
    _size,
    gs_math_block,
    gs_sweep_block,
    gs_sweep_rhs,
    rows_per_chunk,
)
from wgmath_tpu_torch.dynamics.joint import (
    build_joint_constraints,
    joint_gs_pass,
    remove_joint_bias,
)
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry.sim import Sim

_MASK32 = 0xFFFFFFFF
_INF32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Colouring
# ---------------------------------------------------------------------------


def color_pairs(body_a, body_b, valid, dyn_a, dyn_b, num_bodies: int, *,
                max_colors: int = 32, claim_rounds: int = 4,
                class_cap: int = 0):
    """Edge-colour a body-pair graph (colours 1..max_colors-1; residue 0
    under ``class_cap``, else the last colour)."""
    cons = SimpleNamespace(body_a=body_a, body_b=body_b, valid=valid)
    return _color_edges(cons, dyn_a, dyn_b, num_bodies,
                        max_colors=max_colors, claim_rounds=claim_rounds,
                        class_cap=class_cap)


def color_constraints(cons, num_bodies: int, *, max_colors: int = 32,
                      claim_rounds: int = 4, class_cap: int = 0):
    """Edge-colour the constraint graph in the solve (the dynamic flags
    from the inverse masses); as :func:`color_pairs`."""
    dyn_a, dyn_b = _dyn_sides(cons)
    return _color_edges(cons, dyn_a, dyn_b, num_bodies,
                        max_colors=max_colors, claim_rounds=claim_rounds,
                        class_cap=class_cap)


def _color_edges(cons, dyn_a, dyn_b, num_bodies: int, *, max_colors: int,
                 claim_rounds: int, class_cap: int):
    c = cons.body_a.shape[0]
    dev = cons.body_a.device
    hash_shift = max(int(c - 1).bit_length(), 1)
    idx = torch.arange(c, device=dev)
    dyn2 = torch.cat([dyn_a, dyn_b])
    bodies2 = torch.cat([cons.body_a, cons.body_b])
    trash2 = num_bodies + torch.arange(2 * c, device=dev)

    def priorities(salt: int):
        h = (idx * 2654435761 + (salt * 0x9E3779B9 & _MASK32)) & _MASK32
        h = h ^ (h >> 15)
        return ((h << hash_shift) & _MASK32) | idx

    # The JAX while_loop stops once every valid edge is coloured; a colour
    # with no candidates is a no-op, so a fixed loop gives the same colours
    # without a host sync per colour.
    colors = torch.zeros(c, dtype=torch.int64, device=dev)
    for color in range(1, max_colors):
        used = torch.zeros(num_bodies + 2 * c, dtype=torch.bool, device=dev)
        for r in range(claim_rounds):
            cand = cons.valid & (colors == 0)
            cand &= ~(used[cons.body_a] & dyn_a) & ~(used[cons.body_b]
                                                     & dyn_b)
            prio = priorities(color * 31 + r)
            cand2 = torch.cat([cand, cand]) & dyn2
            prio2 = torch.cat([prio, prio])
            slot = torch.full((num_bodies + 1,), _INF32, dtype=torch.int64,
                              device=dev)
            slot.scatter_reduce_(
                0, torch.where(cand2, bodies2,
                               torch.full_like(bodies2, num_bodies)),
                torch.where(cand2, prio2, torch.full_like(prio2, _INF32)),
                "amin")
            win_a = ~dyn_a | (slot[torch.clamp(cons.body_a,
                                               max=num_bodies - 1)] == prio)
            win_b = ~dyn_b | (slot[torch.clamp(cons.body_b,
                                               max=num_bodies - 1)] == prio)
            win = cand & win_a & win_b
            if class_cap:
                already = (colors == color).sum()
                even = ((cons.valid & (colors == 0)).sum()
                        // max(max_colors - color, 1) + 1)
                cap = torch.clamp(even, min=class_cap)
                win &= torch.cumsum(win.to(torch.int64), 0) + already <= cap
            colors = torch.where(win, color, colors)
            win2 = torch.cat([win, win]) & dyn2
            used[torch.where(win2, bodies2, trash2)] = True
    if not class_cap:
        colors = torch.where(cons.valid & (colors == 0), max_colors, colors)
    return colors


def pair_key(ba, bb, valid, num_bodies: int | None = None):
    """u32 key (a<<16 | b) per pair; invalid slots → 0xFFFFFFFF. The
    keys alias from 65,536 bodies on (the same-contact-set predicate
    shares them): ``num_bodies`` checks that, raising ``ValueError``
    where the JAX package fails an assertion."""
    if num_bodies is not None and num_bodies >= (1 << 16):
        raise ValueError(f"{num_bodies} bodies: 16-bit pair keys alias at "
                         ">= 65536")
    k = ((ba << 16) & _MASK32) | (bb & 0xFFFF)
    return torch.where(valid, k, torch.full_like(k, _INF32))


def transfer_pair_colors(new_ba, new_bb, new_valid, old_ba, old_bb,
                         old_valid, old_colors):
    """Carry pair colours across a broad-phase refresh by key match;
    genuinely new pairs get 0."""
    ko = pair_key(old_ba, old_bb, old_valid)
    kn = pair_key(new_ba, new_bb, new_valid)
    order = torch.argsort(ko, stable=True)
    ko_s = ko[order]
    oc_s = old_colors[order]
    pos = torch.clamp(torch.searchsorted(ko_s, kn), max=ko.shape[0] - 1)
    hit = (ko_s[pos] == kn) & new_valid & (kn != _INF32)
    return torch.where(hit, oc_s[pos], torch.zeros_like(kn))


def assign_new_pair_colors(ba, bb, valid, colors, dyn_a, dyn_b,
                           num_bodies: int, *, max_colors: int,
                           class_cap: int, new_cap: int, n_new: int):
    """Greedy sequential colouring of the ``n_new`` uncoloured pairs (at
    most ``new_cap``): each takes the first colour unused at both its
    dynamic bodies and under the class budget, else stays 0."""
    c = ba.shape[0]
    dev = ba.device
    mc = max_colors + 1
    used = _used_colors(ba, bb, valid, colors, dyn_a, dyn_b, num_bodies,
                        max_colors)
    used[num_bodies] = False
    counts = torch.zeros(mc, dtype=torch.int64, device=dev).index_add_(
        0, torch.clamp(colors, 0, max_colors),
        (valid & (colors > 0)).to(torch.int64))
    cap = class_cap if class_cap else c
    is_new = valid & (colors == 0)
    slots = torch.sort(torch.where(is_new, torch.arange(c, device=dev),
                                   torch.full_like(ba, c))).values
    col_ids = torch.arange(mc, device=dev)
    colors = colors.clone()
    for i in range(min(n_new, new_cap)):
        s = slots[i]
        a, b = ba[s], bb[s]
        free = ~(used[a] & dyn_a[s]) & ~(used[b] & dyn_b[s])
        free &= counts < cap
        free[0] = False
        color = torch.where(free.any(), torch.argmax(free.to(torch.int32)),
                            torch.zeros_like(s))
        colors[s] = color
        hit = color > 0
        used[torch.where(hit & dyn_a[s], a, num_bodies), color] = True
        used[torch.where(hit & dyn_b[s], b, num_bodies), color] = True
        used[num_bodies] = False
        counts = counts + (hit & (col_ids == color)).to(torch.int64)
    return colors


def _used_colors(ba, bb, valid, colors, dyn_a, dyn_b, num_bodies: int,
                 max_colors: int):
    """[num_bodies + 1, max_colors + 1] flags: colour k is taken at a body
    by one of its dynamic sides (row ``num_bodies`` collects the rest)."""
    nb = torch.full_like(ba, num_bodies)
    rows2 = torch.cat([torch.where(valid & dyn_a & (colors > 0), ba, nb),
                       torch.where(valid & dyn_b & (colors > 0), bb, nb)])
    used = torch.zeros((num_bodies + 1, max_colors + 1), dtype=torch.bool,
                       device=ba.device)
    used[rows2, torch.clamp(torch.cat([colors, colors]), 0, max_colors)] = True
    return used


def minimize_colors(ba, bb, valid, colors, dyn_a, dyn_b, num_bodies: int, *,
                    max_colors: int, sweeps: int = 2, class_cap: int = 0):
    """Drain the high colour classes into low ones: per sweep, each source
    class from ``max_colors`` down to 2 moves every edge to its lowest
    colour free at both dynamic ends (a class is an independent set, so its
    moves commute); ``class_cap`` ranks the arrivals per destination and
    keeps the late ones at their source."""
    mc = max_colors + 1
    col_ids = torch.arange(mc, device=ba.device)
    ba_s = torch.clamp(ba, max=num_bodies - 1)
    bb_s = torch.clamp(bb, max=num_bodies - 1)
    nb = torch.full_like(ba, num_bodies)
    rows = torch.arange(ba.shape[0], device=ba.device)
    for _ in range(sweeps):
        used = _used_colors(ba, bb, valid, colors, dyn_a, dyn_b, num_bodies,
                            max_colors)
        counts = torch.zeros(mc, dtype=torch.int64, device=ba.device)
        counts.index_add_(0, torch.clamp(colors, 0, max_colors),
                          (valid & (colors > 0)).to(torch.int64))
        for src in range(max_colors, 1, -1):
            movers = valid & (colors == src)
            free = (~(used[ba_s] & dyn_a[:, None])
                    & ~(used[bb_s] & dyn_b[:, None])
                    & (col_ids[None, :] < src) & (col_ids[None, :] > 0))
            tgt = torch.argmax(free.to(torch.int32), dim=1)  # lowest free
            can = movers & free[rows, tgt]
            if class_cap:
                onehot = (can[:, None] & (col_ids[None, :] == tgt[:, None]))
                rank = torch.cumsum(onehot.to(torch.int64), 0)
                can &= (rank + counts[None, :])[rows, tgt] <= class_cap
            colors = torch.where(can, tgt, colors)
            used[torch.cat([torch.where(can & dyn_a, ba, nb),
                            torch.where(can & dyn_b, bb, nb)]),
                 torch.cat([tgt, tgt])] = True
            moved = torch.zeros(mc, dtype=torch.int64, device=ba.device)
            moved.index_add_(0, torch.where(can, tgt, 0), can.to(torch.int64))
            moved[0] = 0
            counts = counts + moved - moved.sum() * (col_ids == src)
    return colors


# ---------------------------------------------------------------------------
# Warmstart
# ---------------------------------------------------------------------------


def _build_sides(body_a, body_b, dyn_a, dyn_b, valid, n: int):
    """Order the 2C constraint sides by body and give each body its
    [left, right) segment of that order."""
    side_valid = torch.cat([valid & dyn_a, valid & dyn_b])
    key = torch.where(side_valid, torch.cat([body_a, body_b]),
                      torch.full_like(side_valid, n, dtype=torch.int64))
    order = torch.argsort(key, stable=True)
    sorted_keys = key[order]
    bodies_idx = torch.arange(n, device=body_a.device)
    left = torch.searchsorted(sorted_keys, bodies_idx)
    right = torch.searchsorted(sorted_keys, bodies_idx, right=True)
    return order, left, right


def _ws_deltas(ns, n_imp, t_imp, mask, p_max):
    """Per-side warmstart velocity deltas [2M, dim + adim] (6 in 3D, 3 in
    2D, where the angular terms are scalars)."""
    d1l = torch.zeros_like(ns.dir_a)
    d2l = torch.zeros_like(ns.dir_a)
    d1a = torch.zeros_like(ns.n_torque_a[:, 0])
    d2a = torch.zeros_like(d1a)
    zero = torch.zeros((), device=n_imp.device)

    def col(x):  # an impulse against an angular term (a scalar in 2D)
        return x[:, None] if d1a.ndim == 2 else x

    for k in range(p_max):
        on = mask & (k < ns.num_points)
        imp = torch.where(on, n_imp[:, k], zero)
        d1l = d1l + ns.dir_a * (ns.im_a * imp[:, None])
        d1a = d1a + ns.n_ii_torque_a[:, k] * col(imp)
        d2l = d2l - ns.dir_a * (ns.im_b * imp[:, None])
        d2a = d2a + ns.n_ii_torque_b[:, k] * col(imp)
        for j in range(ns.tangent_a.shape[-2]):
            timp = torch.where(on, t_imp[:, k, j], zero)
            tj = ns.tangent_a[:, j]
            d1l = d1l + tj * (ns.im_a * timp[:, None])
            d1a = d1a + ns.t_ii_torque_a[:, k, j] * col(timp)
            d2l = d2l - tj * (ns.im_b * timp[:, None])
            d2a = d2a + ns.t_ii_torque_b[:, k, j] * col(timp)
    da = torch.cat([d1a, d2a])
    return torch.cat([torch.cat([d1l, d2l]),
                      da if da.ndim == 2 else da[:, None]], dim=-1)


def _packed(vels: Velocity) -> torch.Tensor:
    """[N, dim + adim] rows of linear then angular velocity."""
    ang = vels.angular
    return torch.cat([vels.linear, ang if ang.ndim == 2 else ang[:, None]],
                     dim=-1)


def _unpacked(rows: torch.Tensor, dim: int) -> Velocity:
    """:func:`_packed`'s inverse (a scalar angular velocity in 2D)."""
    if dim == 2:
        return Velocity(rows[:, :2], rows[:, 2])
    return Velocity(rows[:, :3], rows[:, 3:6])


def _ws_apply(vels: Velocity, packed, sides) -> Velocity:
    """Segment-difference application of per-side deltas (no scatters).
    The prefix sums run along the rows of the transposed [6, 2C] deltas:
    a cumsum over dim 0 of a [2C, 6] tensor is a scan only six columns
    wide on the card (~11 ms at 2C = 80k)."""
    order, left, right = sides
    packed_t = packed.t()[:, order]
    cs = torch.cat([torch.zeros((packed_t.shape[0], 1),
                                device=packed.device),
                    torch.cumsum(packed_t, dim=1)], dim=1)
    seg = (cs[:, right] - cs[:, left]).t()
    dim = vels.linear.shape[-1]
    ang = seg[:, dim:]
    return Velocity(vels.linear + seg[:, :dim],
                    vels.angular + (ang if dim == 3 else ang[:, 0]))


def _dyn_sides(cons):
    """Dynamic flags of both sides from the inverse masses (statics have
    zero inverse mass on every axis)."""
    return (torch.any(cons.im_a != 0.0, dim=-1),
            torch.any(cons.im_b != 0.0, dim=-1))


def warmstart_apply(cons: ContactConstraints, vels: Velocity) -> Velocity:
    """Apply the constraints' stored impulses to the velocities: every
    side's delta added onto its body row by one ``index_add`` over the
    a-sides then the b-sides (the JAX package's order of adds; on the
    card the adds of one body meet in atomics, in no fixed order).
    :func:`warmstart_apply_sorted` is the scatter-free form the solve
    runs."""
    deltas = _ws_deltas(cons, cons.n_impulse, cons.t_impulse, cons.valid,
                        cons.n_impulse.shape[1])
    rows = _packed(vels).index_add(
        0, torch.cat([cons.body_a, cons.body_b]), deltas)
    return _unpacked(rows, vels.linear.shape[-1])


def build_sorted_sides(cons: ContactConstraints, n: int):
    """Per-frame prep for :func:`warmstart_apply_sorted`: the 2C constraint
    sides ordered by body, and each body's [left, right) segment."""
    dyn_a, dyn_b = _dyn_sides(cons)
    return _build_sides(cons.body_a, cons.body_b, dyn_a, dyn_b, cons.valid,
                        n)


def warmstart_apply_sorted(cons: ContactConstraints, vels: Velocity,
                           sides) -> Velocity:
    """Apply the constraints' own impulses to the velocities through the
    body-sorted sides: gathers and one prefix sum, no scatter-adds."""
    deltas = _ws_deltas(cons, cons.n_impulse, cons.t_impulse, cons.valid,
                        cons.n_impulse.shape[1])
    return _ws_apply(vels, deltas, sides)


def slotwise_warmstart(cons: ContactConstraints, prev: ContactConstraints,
                       params: SimParams) -> ContactConstraints:
    """Impulse carry-over when slot i holds the same pair as last frame."""
    ws = params.warmstart_coefficient
    v = cons.valid
    return dataclasses.replace(
        cons,
        n_impulse=torch.where(v[:, None], prev.n_impulse * ws,
                              cons.n_impulse),
        n_impulse_jacobi=torch.where(v[:, None], prev.n_impulse_jacobi * ws,
                                     cons.n_impulse_jacobi),
        t_impulse=torch.where(v[:, None, None], prev.t_impulse * ws,
                              cons.t_impulse),
        t_impulse_jacobi=torch.where(v[:, None, None],
                                     prev.t_impulse_jacobi * ws,
                                     cons.t_impulse_jacobi))


def transfer_warmstart(cons: ContactConstraints, prev: ContactConstraints,
                       params: SimParams) -> ContactConstraints:
    """Impulse transfer by (body_a, body_b) key: sort last frame's keys,
    search this frame's, copy matched impulses scaled by the coefficient."""
    key_prev = pair_key(prev.body_a, prev.body_b, prev.valid)
    order = torch.argsort(key_prev, stable=True)
    sorted_prev = key_prev[order]
    key_new = pair_key(cons.body_a, cons.body_b, cons.valid)
    pos = torch.clamp(torch.searchsorted(sorted_prev, key_new), 0,
                      prev.body_a.shape[0] - 1)
    hit = (sorted_prev[pos] == key_new) & cons.valid
    src = order[pos]
    ws = params.warmstart_coefficient
    return dataclasses.replace(
        cons,
        n_impulse=torch.where(hit[:, None], prev.n_impulse[src] * ws,
                              cons.n_impulse),
        n_impulse_jacobi=torch.where(hit[:, None],
                                     prev.n_impulse_jacobi[src] * ws,
                                     cons.n_impulse_jacobi),
        t_impulse=torch.where(hit[:, None, None], prev.t_impulse[src] * ws,
                              cons.t_impulse),
        t_impulse_jacobi=torch.where(hit[:, None, None],
                                     prev.t_impulse_jacobi[src] * ws,
                                     cons.t_impulse_jacobi))


# ---------------------------------------------------------------------------
# Colour-major layout
# ---------------------------------------------------------------------------


def gs_colored_pass(cons: ContactConstraints, vels: Velocity, colors, *,
                    max_colors: int = 32, num_colors=None):
    """One Gauss-Seidel sweep over the unsorted constraints, colour after
    colour (1 to ``num_colors``) and every row of a colour at once: gather
    both sides' velocities, run the point updates
    (``gs_math._point_updates``), keep the active rows' new impulses and
    add each side's velocity delta back onto its body. ``num_colors``
    (an int or a device scalar) defaults to the largest colour of a valid
    row, read on the host. ``max_colors`` is the JAX package's argument
    and bounds nothing here. Returns ``(Velocity, cons with the new
    impulses)``. The solve sweeps the colour-major layout instead
    (:func:`gs_color_major_pass`)."""
    if num_colors is None:
        num_colors = torch.amax(torch.where(cons.valid, colors,
                                            torch.zeros_like(colors)))
    if isinstance(num_colors, torch.Tensor):
        num_colors = host_int(num_colors)
    dim = cons.dim
    p_max = cons.n_impulse.shape[1]
    f = {name: getattr(cons, name) for name in UPDATE_FIELDS}
    sides = torch.cat([cons.body_a, cons.body_b])
    rows = _packed(vels)
    n_imp, t_imp = cons.n_impulse, cons.t_impulse
    for color in range(1, num_colors + 1):
        active = cons.valid & (colors == color)
        new_n, new_t, d1, d2 = _point_updates(
            f, cons.cfm_factor, cons.n_rhs, cons.t_rhs, cons.num_points,
            active, rows[cons.body_a], rows[cons.body_b], n_imp, t_imp,
            p_max)
        n_imp = torch.where(active[:, None], new_n, n_imp)
        t_imp = torch.where(active[:, None, None], new_t, t_imp)
        rows = rows.index_add(0, sides, torch.cat([d1, d2]))
    return (_unpacked(rows, dim),
            dataclasses.replace(cons, n_impulse=n_imp, t_impulse=t_imp))


def build_color_layout(colors, valid, *, max_colors: int, cmax: int):
    """Colour-major constraint ordering: ``order`` sorted by colour
    (stable; invalid slots last) with per-colour ``offsets`` / ``counts``;
    ``cmax`` padding entries (= C) keep every rung window in bounds.
    Returns (order_padded, offsets, counts)."""
    c = colors.shape[0]
    dev = colors.device
    key = torch.where(valid, colors, torch.full_like(colors, max_colors + 1))
    order = torch.argsort(key, stable=True)
    counts = torch.zeros(max_colors + 2, dtype=torch.int64,
                         device=dev).index_add_(0, key,
                                                valid.to(torch.int64))
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(counts, 0)[:-1]])
    order_padded = torch.cat([order, torch.full((cmax,), c,
                                                dtype=torch.int64,
                                                device=dev)])
    return order_padded, offsets, counts


def pack_sorted_fields(ss):
    """The substep-invariant solver fields of ``ss`` as one [C, K] f32
    matrix and its layout map name → (first column, trailing shape)."""
    c = ss.body_a.shape[0]
    cols, meta, at = [], {}, 0
    for f in PACK_FIELDS:
        v = getattr(ss, f)
        tail = tuple(v.shape[1:])
        meta[f] = (at, tail)
        cols.append(v.reshape(c, _size(tail)).to(torch.float32))
        at += _size(tail)
    return torch.cat(cols, dim=1), meta


def _field_matrix(cons: ContactConstraints):
    """Every float field the solver reads as one [C, K_all] matrix (the
    ``PACK_FIELDS`` first) and its layout map."""
    c = cons.body_a.shape[0]
    cols, meta, at = [], {}, 0
    for f in F32_SORT_FIELDS:
        v = getattr(cons, f)
        tail = tuple(v.shape[1:])
        meta[f] = (at, tail)
        cols.append(v.reshape(c, _size(tail)).to(torch.float32))
        at += _size(tail)
    return torch.cat(cols, dim=1), meta


def _sorted_namespace(big, meta, ints: dict):
    """(fields namespace, (packed window block, its map)): the float fields
    are column views of ``big``."""
    n = big.shape[0]
    fields = {f: big[:, a0:a0 + _size(t)].reshape((n,) + t)
              for f, (a0, t) in meta.items()}
    fields.update(ints)
    last = PACK_FIELDS[-1]
    k_pack = meta[last][0] + _size(meta[last][1])
    return SimpleNamespace(**fields), (big[:, :k_pack],
                                       {f: meta[f] for f in PACK_FIELDS})


SORT_FIELDS = ("dir_a", "tangent_a", "im_a", "im_b", "cfm_factor", "limit",
               "num_points", "n_torque_a", "n_torque_b", "n_ii_torque_a",
               "n_ii_torque_b", "n_rhs", "n_r", "t_torque_a", "t_torque_b",
               "t_ii_torque_a", "t_ii_torque_b", "t_rhs", "t_r", "body_a",
               "body_b", "n_rhs_wo_bias", "t_rhs_wo_bias", "valid",
               "local_pt_a", "local_pt_b", "info_dist", "info_normal_vel")


def sort_solver_fields(cons: ContactConstraints, order_padded):
    """The solver-read fields (``SORT_FIELDS``) gathered field by field
    into colour-major order; padding entries of ``order_padded`` (= C)
    become invalid rows with no points. Returns a namespace of them.
    :func:`sort_solver_fields_packed` is the one-gather form the solve
    runs."""
    c = cons.body_a.shape[0]
    idx = torch.clamp(order_padded, max=c - 1)
    pad = order_padded >= c
    ns = {f: getattr(cons, f)[idx] for f in SORT_FIELDS}
    ns["num_points"] = torch.where(pad, torch.zeros_like(ns["num_points"]),
                                   ns["num_points"])
    ns["valid"] = ns["valid"] & ~pad
    return SimpleNamespace(**ns)


def sort_solver_fields_packed(cons: ContactConstraints, order_padded):
    """Colour-major sort of every solver-read field by one row gather of
    the [C, K_all] field matrix; padding entries of ``order_padded`` (= C)
    become invalid rows with no points. Returns as
    :func:`pad_solver_fields_packed`."""
    c = cons.body_a.shape[0]
    idx = torch.clamp(order_padded, max=c - 1)
    pad = order_padded >= c
    big, meta = _field_matrix(cons)
    num_points = cons.num_points[idx]
    return _sorted_namespace(big[idx], meta, dict(
        body_a=cons.body_a[idx], body_b=cons.body_b[idx],
        num_points=torch.where(pad, torch.zeros_like(num_points),
                               num_points),
        valid=cons.valid[idx] & ~pad))


def pad_solver_fields_packed(cons: ContactConstraints, pad: int):
    """Constraints already in colour-major order: one concat builds the
    [C + pad, K_all] field matrix; ``pad`` zero rows keep every rung window
    in bounds. Returns (fields namespace, (packed window block, meta))."""
    dev = cons.body_a.device
    big, meta = _field_matrix(cons)
    big = torch.cat([big, torch.zeros((pad, big.shape[1]), device=dev)])
    zpad = torch.zeros(pad, dtype=torch.int64, device=dev)
    return _sorted_namespace(big, meta, dict(
        body_a=torch.cat([cons.body_a, zpad]),
        body_b=torch.cat([cons.body_b, zpad]),
        num_points=torch.cat([cons.num_points, zpad]),
        valid=torch.cat([cons.valid, torch.zeros(pad, dtype=torch.bool,
                                                 device=dev)])))


def build_gs_chain(body_a_s, body_b_s, dyn_a_s, dyn_b_s, offsets, counts,
                   windows: tuple, n: int):
    """Last-writer index chain for the chained sweep.

    Stream rows ``[0, n)`` are the body table; colour c (window w at
    offset W_c = sum(windows[:c-1])) writes its a-side and b-side rows at
    ``n + 2·W_c + [0, 2w)``. ``src[2·W_c + s]`` is the stream row holding
    the latest velocity of that slot's body; ``last_writer[b]`` the row of
    body b's final velocity. Only active dynamic sides advance the chain.
    ``offsets``/``counts`` are host ints."""
    dev = body_a_s.device
    w_max = max(windows) if windows else 1
    total = body_a_s.shape[0]
    cur = torch.cat([torch.arange(n, device=dev),
                     torch.zeros(w_max, dtype=torch.int64, device=dev)])
    srcs = []
    w_off = 0
    for ci, w in enumerate(windows, start=1):
        if w == 0:
            continue
        start = min(max(offsets[ci], 0), total - w)
        slot = torch.arange(w, device=dev)
        ba = body_a_s[start:start + w]
        bb = body_b_s[start:start + w]
        active = slot < counts[ci]
        wa = active & dyn_a_s[start:start + w]
        wb = active & dyn_b_s[start:start + w]
        srcs.append(cur[torch.cat([ba, bb])])
        pos_a = n + 2 * w_off + slot
        trash = n + slot
        cur[torch.where(wa, ba, trash)] = pos_a
        cur[torch.where(wb, bb, trash)] = pos_a + w
        w_off += w
    return torch.cat(srcs), cur[:n]


# ---------------------------------------------------------------------------
# Gauss-Seidel sweeps over the window ladder
# ---------------------------------------------------------------------------


def _rung_start(offsets, ci: int, w: int, total: int) -> int:
    """First row of colour ``ci``'s window, clamped into the buffer."""
    return min(max(offsets[ci], 0), total - w)


def _prev_writer(body, writes):
    """For each side in ladder order, the last earlier side that writes its
    body (-1 where none): the ladder's dependency chain, from one sort by
    (body, position) and a running max."""
    n_sides = body.shape[0]
    if n_sides == 0:
        return body.clone()
    pos = torch.arange(n_sides, device=body.device)
    key = body * n_sides + pos
    order = torch.argsort(key)
    prev = torch.cummax(torch.where(writes, key, -1)[order], 0).values
    prev = torch.cat([prev.new_full((1,), -1), prev[:-1]])
    same = (prev >= 0) & (prev // n_sides == body[order])
    dep = torch.where(same, prev % n_sides, -1)
    return torch.empty_like(dep).scatter_(0, order, dep)


def build_sweep_plan(sorted_cons, layout_host, windows: tuple,
                     n_bodies: int, chain=None, *, p_max: int) -> SweepPlan:
    """The sweep table of one solve (substep-invariant; see
    :class:`~wgmath_tpu_torch.dynamics.gs_math.SweepPlan`).

    A rung runs the slots of its class only (``slot < min(count, w)``);
    the window's later slots belong to later rungs. A row is active where
    its slot is in the class and its contact is live (in pair-slot layouts
    a class row can be a cached pair with no contact this frame: it runs
    masked, passing velocities through with its impulses kept). ``chain``
    = (src, last_writer) of :func:`build_gs_chain` selects the chained
    table: a side reads ``src``, waits for it where it is a stream row, and
    writes its own stream row where a later side or ``last_writer`` reads
    it (exactly where the chain advanced). Without a chain (the ladder) a
    side reads and writes its body row, writes only where the row is
    active and the side dynamic, and waits for the body's previous writer.

    Everything on the host (rung starts, class sizes, chunks, each side's
    constraint row) is known from ``layout_host``; it goes to the device in
    one copy that does not sync."""
    offsets, counts = layout_host
    total = sorted_cons.body_a.shape[0]
    dev = sorted_cons.body_a.device
    rows = rows_per_chunk(p_max)
    rungs, chunks, side_row, side_in_class = [], [], [], []
    w_off = 0
    for ci, w in enumerate(windows, start=1):
        if w == 0:
            continue
        start = _rung_start(offsets, ci, w, total)
        m = min(max(counts[ci], 0), w)
        c0 = len(chunks)
        chunks += [(start + s0, min(rows, m - s0), 2 * w_off + s0,
                    2 * w_off + w + s0) for s0 in range(0, m, rows)]
        rungs.append(Rung(ci, start, w, w_off, m, c0, len(chunks)))
        r = np.arange(start, start + w)
        side_row.append(np.concatenate([r, r + total]))
        in_class = np.arange(w) < m
        side_in_class.append(np.concatenate([in_class, in_class]))
        w_off += w
    n_sides, n_chunks = 2 * w_off, len(chunks)
    host = np.concatenate([np.asarray(chunks, np.int32).reshape(-1)]
                          + side_row + side_in_class).astype(np.int32)
    tab = to_device(torch.from_numpy(host), dev)
    chunk_t = tab[:4 * n_chunks].view(n_chunks, 4)
    side_t = tab[4 * n_chunks:4 * n_chunks + n_sides].long()
    in_class = tab[4 * n_chunks + n_sides:].bool()
    body = torch.cat([sorted_cons.body_a, sorted_cons.body_b])[side_t]
    act = in_class & torch.cat([sorted_cons.valid,
                                sorted_cons.valid])[side_t]
    none = torch.full_like(body, -1)
    if chain is not None:
        src, last_writer = chain
        read_later = torch.zeros(n_sides + 1, dtype=torch.bool, device=dev)
        for ref in (src, last_writer):
            read_later[torch.where(ref >= n_bodies, ref - n_bodies,
                                   n_sides)] = True
        pos = torch.arange(n_sides, device=dev)
        read = src
        write = torch.where(read_later[:n_sides], pos + n_bodies, none)
        wait = torch.where(src >= n_bodies, src - n_bodies, none)
    else:
        dyn = torch.cat(_dyn_sides(sorted_cons))[side_t]
        writes = act & dyn
        read = body
        write = torch.where(writes, body, none)
        wait = _prev_writer(body, writes)
    sides = torch.stack([read, write, wait, 2 * body + act.long()],
                        1).to(torch.int32)
    return SweepPlan(chunks=chunk_t, sides=sides, rungs=tuple(rungs),
                     p_max=p_max,
                     ready=torch.zeros(n_sides + 1, dtype=torch.int32,
                                       device=dev))


def _sweep_torch(plan: SweepPlan, sorted_cons, packed_fields, buf, imp, *,
                 rhs_mode: str | None, rhs_consts: tuple | None, p_max: int,
                 s_len: int, pose=None, shard=None) -> None:
    """Plain PyTorch version of one sweep kernel (``gs_math.gs_sweep_rhs``
    / ``gs_sweep_block``), rung by rung in place on ``buf`` / ``imp``: the
    same table and the same row math. A side that writes gets its row as
    the row it read with ``v + (w - v)``; a side that does not writes back
    the row it read (the same bits: nothing else in the rung writes it),
    which keeps the scatter free of a mask.

    ``shard`` (a ``core.collectives.Shard``) splits each rung across the
    ranks: rank k runs the rung's rows ``[k·l, (k+1)·l)`` (l the rows over
    the rank count, rounded up) through the row math, on a CUDA tensor
    with 3D rows as one launch of B2 (``gs_math.gs_math_block``), and one
    all-reduce carries the rung's velocity deltas and new impulses. Every
    row is one rank's and zeros on the others, so the sum is exact and the
    same on every rank, which then scatters the whole rung as above."""
    pf2d, pf_meta = packed_fields
    sides = plan.sides.long()
    pt = p_max * s_len
    dev = buf.device
    width = buf.shape[1]
    kernel = shard is not None and dev.type == "cuda" and width == 6
    for r in plan.rungs:
        m, w = r.rows, r.window
        if m == 0:
            continue
        slot = torch.arange(m, device=dev)
        e = sides[torch.cat([2 * r.w_off + slot, 2 * r.w_off + w + slot])]
        pp = buf[e[:, 0]]
        lo, hi = 0, m
        if shard is not None:
            lw = -(-m // shard.n)
            lo = min(shard.rank * lw, m)
            hi = min(lo + lw, m)
        k = hi - lo
        rows = slice(r.start + lo, r.start + hi)
        new_cols = []
        if k:
            p1, p2 = pp[lo:hi], pp[m + lo:m + hi]
            active = (e[lo:hi, 3] & 1) != 0
            win_i = imp[rows]
            prev_n = win_i[:, :p_max]
            prev_t = win_i[:, p_max:p_max + pt].reshape(k, p_max, s_len)
            num_pts = sorted_cons.num_points[rows]
            if rhs_mode is not None:
                kw = dict(mode=rhs_mode, consts=rhs_consts, p_max=p_max,
                          s_len=s_len)
                if rhs_mode == "biased":
                    body = e[:, 3] >> 1
                    new_n, new_t, d1, d2, rhs_wo = _gs_math_rhs_torch(
                        pf2d[rows], pf_meta, num_pts, active, p1, p2,
                        prev_n, prev_t, pose1=pose[body[lo:hi]],
                        pose2=pose[body[m + lo:m + hi]], **kw)
                else:
                    rhs_wo = win_i[:, p_max + pt:]
                    new_n, new_t, d1, d2 = _gs_math_rhs_torch(
                        pf2d[rows], pf_meta, num_pts, active, p1, p2,
                        prev_n, prev_t, n_rhs_wo=rhs_wo, **kw)
                new_cols = [new_n, new_t.reshape(k, -1), rhs_wo]
            elif kernel:
                view = SimpleNamespace(
                    cfm_factor=sorted_cons.cfm_factor[rows],
                    n_rhs=sorted_cons.n_rhs[rows],
                    t_rhs=sorted_cons.t_rhs[rows], num_points=num_pts)
                new_n, new_t, d1, d2 = gs_math_block(
                    pf2d[rows], pf_meta, view, active, p1, p2, prev_n,
                    prev_t, p_max=p_max, s_len=s_len)
                new_cols = [new_n, new_t.reshape(k, -1)]
            else:
                new_n, new_t, d1, d2 = _gs_math_torch(
                    pf2d[rows], pf_meta, sorted_cons.cfm_factor[rows],
                    sorted_cons.n_rhs[rows], sorted_cons.t_rhs[rows],
                    num_pts, active, p1, p2, prev_n, prev_t, p_max=p_max,
                    s_len=s_len)
                new_cols = [new_n, new_t.reshape(k, -1)]
        if shard is not None:
            payload = torch.zeros((m, 2 * width + imp.shape[1]), device=dev)
            if k:
                payload[lo:hi] = torch.cat([d1, d2] + new_cols, dim=1)
            collectives.all_reduce_sum(payload, shard)
            d1, d2 = payload[:, :width], payload[:, width:2 * width]
            new_cols = [payload[:, 2 * width:]]
        writes = e[:, 1] >= 0
        buf[torch.where(writes, e[:, 1], e[:, 0])] = torch.where(
            writes[:, None], pp + torch.cat([d1, d2]), pp)
        imp[r.start:r.start + m] = torch.cat(new_cols, dim=1)


def run_sweep(plan: SweepPlan, sorted_cons, packed_fields, buf, imp, *,
              rhs_mode: str | None = None, rhs_consts: tuple | None = None,
              pose=None, p_max: int, s_len: int,
              rung_by_rung: bool = False, shard=None) -> None:
    """One sweep in place on the velocity buffer ``buf`` and the merged
    impulse matrix ``imp`` (``pose``: the bodies' [n, 8] poses, for
    ``rhs_mode`` "biased"): one kernel launch on CUDA tensors
    (``gs_math.gs_sweep_rhs`` with ``rhs_mode``, else
    ``gs_math.gs_sweep_block``; ``rung_by_rung`` launches the same kernel
    once per rung), :func:`_sweep_torch` on CPU tensors. A 2D sweep (rows
    of three velocities) is :func:`_sweep_torch` on either device: the JAX
    package runs it in XLA, and the kernels take 3D rows only. Under a
    ``shard`` every rung is split across the ranks in :func:`_sweep_torch`
    (B2 launched on each rank's slice on a CUDA tensor)."""
    pf2d, pf_meta = packed_fields
    if (buf.device.type != "cuda" or buf.shape[1] == 3
            or shard is not None):
        _sweep_torch(plan, sorted_cons, packed_fields, buf, imp,
                     rhs_mode=rhs_mode, rhs_consts=rhs_consts, p_max=p_max,
                     s_len=s_len, pose=pose, shard=shard)
    elif rhs_mode is not None:
        gs_sweep_rhs(plan, pf2d, pf_meta, sorted_cons.num_points, buf, imp,
                     mode=rhs_mode, consts=rhs_consts, p_max=p_max,
                     s_len=s_len, pose=pose, rung_by_rung=rung_by_rung)
    else:
        gs_sweep_block(plan, pf2d, pf_meta, sorted_cons.cfm_factor,
                       sorted_cons.n_rhs, sorted_cons.t_rhs,
                       sorted_cons.num_points, buf, imp, p_max=p_max,
                       s_len=s_len, rung_by_rung=rung_by_rung)


def gs_color_major_pass(sorted_cons, vels: Velocity, n_imp_s, t_imp_s,
                        layout_host, windows: tuple, chain=None, *,
                        packed_fields, rhs_mode: str | None = None,
                        rhs_consts: tuple | None = None, rhs_store=None,
                        pose_tab=None, sweep_plan: SweepPlan | None = None,
                        shard=None):
    """One PGS sweep over the colour-major constraints, colour by colour
    along the window ladder (:func:`run_sweep`: one kernel launch on CUDA
    tensors).

    ``layout_host`` = (offsets, counts) as host ints. ``chain`` =
    (src, last_writer) from :func:`build_gs_chain` selects the chained
    sweep; ``None`` the ladder sweep (read and write by body index).
    ``rhs_mode`` (chained only): "biased" rebuilds each rung's rhs in the
    kernel from the bodies' poses (``pose_tab`` [n, 8]) and stores
    rhs_wo_bias; "unbiased" consumes that store with cfm = 1; ``None``
    takes ``cfm_factor`` / ``n_rhs`` / ``t_rhs`` from ``sorted_cons``.
    ``sweep_plan`` is the per-solve table of :func:`build_sweep_plan`
    (built here when absent). ``shard`` (a ``core.collectives.Shard``,
    the ladder only) splits each rung across the ranks
    (:func:`_sweep_torch`). Impulses stay in sorted space. Returns
    (vels, n_imp_s, t_imp_s[, rhs_store])."""
    p_max = n_imp_s.shape[1]
    s_len = sorted_cons.tangent_a.shape[-2]
    n_bodies = vels.linear.shape[0]
    dev = vels.linear.device
    if sweep_plan is None:
        sweep_plan = build_sweep_plan(sorted_cons, layout_host, windows,
                                      n_bodies, chain, p_max=p_max)
    dim = vels.linear.shape[-1]
    buf = _packed(vels)
    if rhs_mode is not None:
        assert chain is not None and rhs_consts is not None \
            and rhs_store is not None
        assert rhs_mode != "biased" or pose_tab is not None
    if chain is not None:
        # the velocity stream: body table + one 2w-row segment per colour
        buf = torch.cat([buf, torch.zeros((2 * sum(windows), buf.shape[1]),
                                          device=dev)])
    pt = p_max * s_len
    # the impulses travel as one merged [C, P·(1+S)] matrix (the
    # rhs-in-rung store rides it as trailing columns)
    imp_cols = [n_imp_s, t_imp_s.reshape(t_imp_s.shape[0], -1)]
    if rhs_mode is not None:
        imp_cols.append(rhs_store)
    imp = torch.cat(imp_cols, dim=1)
    run_sweep(sweep_plan, sorted_cons, packed_fields, buf, imp,
              rhs_mode=rhs_mode, rhs_consts=rhs_consts,
              pose=pose_tab if rhs_mode == "biased" else None, p_max=p_max,
              s_len=s_len, shard=shard)
    packed = buf[chain[1]] if chain is not None else buf
    out = (_unpacked(packed, dim), imp[:, :p_max],
           imp[:, p_max:p_max + pt].reshape(t_imp_s.shape))
    if rhs_mode is not None:
        return out + (imp[:, p_max + pt:],)
    return out


def uniform_windows(counts, *, max_colors: int, cmax: int,
                    tail_window: int = 0, split: int = 0) -> tuple:
    """The rows each colour 1..``max_colors`` sweeps without a ladder
    (host ints; ``counts`` the layout's class counts on the host): colour
    c's window is ``cmax`` rows from its offset, and with ``tail_window``
    the colours past ``split`` take that narrower window. Rows past the
    class run masked there, so only ``min(count, window)`` rows do work: a
    plan built from these windows has one rung per occupied colour, its
    sides sized by the counts, and a class larger than its window keeps
    its later rows unswept for the frame. Colour 0 (the residue) is not
    swept."""
    return tuple(min(max(counts[c], 0),
                     tail_window if tail_window and c > split else cmax)
                 for c in range(1, max_colors + 1))


# ---------------------------------------------------------------------------
# The Jacobi solver: each body solves its own constraints in turn against a
# snapshot of the others (plain PyTorch, as the JAX package runs it in XLA)
# ---------------------------------------------------------------------------


def build_body_constraint_csr(cons, num_bodies: int):
    """(entries, offsets, counts): ``entries[offsets[b] + k]`` is
    ``2·cid + side`` of the k-th constraint side at dynamic body ``b``, in
    constraint order, a-sides before b-sides (one stable sort)."""
    c = cons.body_a.shape[0]
    dyn_a, dyn_b = _dyn_sides(cons)
    nb = torch.full_like(cons.body_a, num_bodies)
    keys = torch.cat([torch.where(dyn_a & cons.valid, cons.body_a, nb),
                      torch.where(dyn_b & cons.valid, cons.body_b, nb)])
    idx = torch.arange(c, device=keys.device)
    sk, order = torch.sort(keys, stable=True)
    entries = torch.cat([idx * 2, idx * 2 + 1])[order]
    counts = torch.bincount(sk, minlength=num_bodies + 1)[:num_bodies]
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    return entries, offsets, counts


def jacobi_pass(cons: ContactConstraints, vels: Velocity, csr, *,
                max_per_body: int = 32):
    """One pseudo-Jacobi pass: every body walks its first ``max_per_body``
    constraint sides in turn, updating its own velocity against the other
    bodies' velocities from before the pass, and stores each impulse on its
    own side (a-sides in ``n_impulse`` / ``t_impulse``, b-sides in the
    ``*_jacobi`` copies). Returns ``(vels, cons)``."""
    entries, offsets, counts = csr
    p_max = cons.n_impulse.shape[1]
    c = cons.body_a.shape[0]
    snap = _packed(vels)
    own = snap
    imps = [torch.cat([x, torch.zeros_like(x[:1])]) for x in (
        cons.n_impulse, cons.n_impulse_jacobi, cons.t_impulse,
        cons.t_impulse_jacobi)]
    last = entries.shape[0] - 1
    for k in range(max_per_body):
        active = k < counts
        v = entries[torch.clamp(offsets + k, 0, last)]
        cid = torch.where(active, v >> 1, 0)
        is_a = (v & 1) == 0
        other = snap[torch.where(is_a, cons.body_b[cid], cons.body_a[cid])]
        p1 = torch.where(is_a[:, None], own, other)
        p2 = torch.where(is_a[:, None], other, own)
        n_imp, n_imp_j, t_imp, t_imp_j = imps
        prev_n = torch.where(is_a[:, None], n_imp[cid], n_imp_j[cid])
        prev_t = torch.where(is_a[:, None, None], t_imp[cid], t_imp_j[cid])
        f = {name: getattr(cons, name)[cid] for name in UPDATE_FIELDS}
        new_n, new_t, w1, w2 = _point_updates(
            f, cons.cfm_factor[cid], cons.n_rhs[cid], cons.t_rhs[cid],
            cons.num_points[cid], active, p1, p2, prev_n, prev_t, p_max,
            deltas=False)
        # each (constraint, side) belongs to one body: unique rows; the
        # inactive ones land on the extra row past the buffer
        cid_a = torch.where(active & is_a, cid, c)
        cid_b = torch.where(active & ~is_a, cid, c)
        n_imp[cid_a] = new_n
        n_imp_j[cid_b] = new_n
        t_imp[cid_a] = new_t
        t_imp_j[cid_b] = new_t
        own = torch.where(active[:, None],
                          torch.where(is_a[:, None], w1, w2), own)
    n_imp, n_imp_j, t_imp, t_imp_j = (x[:c] for x in imps)
    return (_unpacked(own, vels.linear.shape[-1]),
            dataclasses.replace(cons, n_impulse=n_imp,
                                n_impulse_jacobi=n_imp_j, t_impulse=t_imp,
                                t_impulse_jacobi=t_imp_j))


def _solve_jacobi(bodies: Bodies, cons, vels: Velocity, inc, sub,
                  params: SimParams, max_per_body: int, joint_solve=None):
    """The Jacobi substep loop (the JAX package's ``substep_jacobi``):
    relinearize, a biased pass, integrate, an unbiased pass; with
    ``joint_solve`` (:class:`JointSolve`) a joint build and pass before
    the biased pass and an unbiased joint pass after integrating. Returns
    as :func:`solve`: no colours, no class sizes, no solve bundle."""
    n = bodies.num_bodies
    csr = build_body_constraint_csr(cons, n)
    # bodies with fewer sides than the loop sit out its later rounds, so
    # the loop stops at the busiest body (one read) with the same result
    rounds = min(max_per_body, host_int(csr[2].max()))
    poses = bodies.poses
    com = bodies.local_mprops.com
    for _ in range(params.num_solver_iterations):
        vels = Velocity(vels.linear + inc, vels.angular)
        cons = update_constraints(cons, poses, sub)
        if joint_solve is not None:
            vels = joint_solve.biased(poses, vels)
        vels, cons = jacobi_pass(cons, vels, csr, max_per_body=rounds)
        poses = integrate_velocity(poses, vels, com, sub.dt)
        if joint_solve is not None:
            vels = joint_solve.unbiased(vels)
        cons = remove_cfm_and_bias(cons)
        vels, cons = jacobi_pass(cons, vels, csr, max_per_body=rounds)
    zeros = torch.zeros(2, dtype=torch.int64, device=inc.device)
    return (poses, vels, cons, zeros, torch.zeros_like(cons.body_a), None)


# ---------------------------------------------------------------------------
# Full TGS-soft solve under the window ladder
# ---------------------------------------------------------------------------


class JointSolve:
    """The joint passes of one solve, around its contact sweeps (the JAX
    package's per-substep joint build and passes): :meth:`biased` builds
    the joints' constraints from the substep's ``poses`` and the frame's
    mass properties and runs one pass; :meth:`unbiased` drops the bias and
    runs another. Joint impulses start at zero every substep: joints have
    no warmstart."""

    def __init__(self, joints, mprops: WorldMassProperties, sub: SimParams,
                 max_colors: int):
        self.joints, self.mprops, self.sub = joints, mprops, sub
        self.max_colors = max_colors
        self.cons = None

    def build(self, poses: Sim) -> None:
        self.cons = build_joint_constraints(self.joints, poses, self.mprops,
                                            self.sub)

    def run(self, vels: Velocity) -> Velocity:
        vels, self.cons = joint_gs_pass(self.cons, vels, self.joints.colors,
                                        max_colors=self.max_colors)
        return vels

    def biased(self, poses: Sim, vels: Velocity) -> Velocity:
        self.build(poses)
        return self.run(vels)

    def unbiased(self, vels: Velocity) -> Velocity:
        self.cons = remove_joint_bias(self.cons)
        return self.run(vels)


def static_offsets(static_layout: tuple) -> list:
    """The class offsets of the static rung placement (``gs_static_slots``)
    on the host: class c >= 1 starts at ``sum(static_layout[:c-1])``, the
    residue (0) and the invalid rows (``max_colors + 1``) at the tail,
    ``sum(static_layout)``."""
    w = np.concatenate([[0], np.cumsum(static_layout)]).astype(np.int64)
    return [int(x) for x in np.concatenate([[w[-1]], w[:-1], [w[-1]]])]


def _layout_sides(cons, colors, bodies: Bodies, *, max_colors: int,
                  cmax: int, windows: tuple, presorted: bool, layout_valid,
                  chained: bool, static_layout: tuple | None = None):
    """The solve bundle (order_padded, offsets, counts, side order, left,
    right[, chain src, last writer]) and its offsets + counts on the host.

    ``presorted``: the constraints are colour-major already, so the order
    is the identity. ``layout_valid`` (pair slots) is the PAIR validity:
    layout, sides and chain then cover every cached pair and read no
    per-frame contact data, so the bundle can be cached while the
    broad-phase cache holds. ``static_layout`` (presorted only, the static
    pair slots' ladder): the offsets are the host constants of
    :func:`static_offsets`, so only the counts are read back."""
    dev = colors.device
    c_cap = cons.body_a.shape[0]
    n = bodies.num_bodies
    if presorted:
        lv = layout_valid if layout_valid is not None else cons.valid
        key = torch.where(lv, torch.clamp(colors, 0, max_colors),
                          torch.full_like(colors, max_colors + 1))
        counts = torch.zeros(max_colors + 2, dtype=torch.int64,
                             device=dev).index_add_(0, key,
                                                    lv.to(torch.int64))
        if static_layout is not None:
            offsets = to_device(torch.tensor(static_offsets(static_layout)),
                                dev)
        else:
            offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                             device=dev),
                                 torch.cumsum(counts, 0)[:-1]])
        order_padded = torch.cat([torch.arange(c_cap, device=dev),
                                  torch.full((cmax,), c_cap,
                                             dtype=torch.int64, device=dev)])
    else:
        order_padded, offsets, counts = build_color_layout(
            colors, cons.valid, max_colors=max_colors, cmax=cmax)
    if layout_valid is not None:
        # dynamic flags from the body table, not from cons.im (the same
        # bits: statics have zero inverse mass on every axis)
        dyn_bodies = bodies.is_dynamic()
        dyn_a, dyn_b = dyn_bodies[cons.body_a], dyn_bodies[cons.body_b]
        lv_s = layout_valid
    else:
        dyn_a, dyn_b = _dyn_sides(cons)
        lv_s = cons.valid
    idxp = torch.clamp(order_padded, max=c_cap - 1)
    padv = order_padded >= c_cap
    ba_p, bb_p = cons.body_a[idxp], cons.body_b[idxp]
    dyn_a_p, dyn_b_p = dyn_a[idxp], dyn_b[idxp]
    bundle = (order_padded, offsets, counts) + _build_sides(
        ba_p, bb_p, dyn_a_p, dyn_b_p, lv_s[idxp] & ~padv, n)
    off_h = _layout_host(bundle, static_layout if presorted else None)
    if chained:
        bundle += build_gs_chain(ba_p, bb_p, dyn_a_p, dyn_b_p,
                                 off_h[:max_colors + 2],
                                 off_h[max_colors + 2:], windows, n)
    return bundle, off_h


def _layout_host(bundle, static_layout: tuple | None) -> list:
    """A solve bundle's offsets and counts on the host: one read, of the
    counts only where the offsets are the static layout's constants."""
    if static_layout is not None:
        return static_offsets(static_layout) + host_list(bundle[2])
    return host_list(torch.cat([bundle[1], bundle[2]]))


def _bundle_shapes(c_cap, cmax, max_colors, n, windows, chained: bool):
    shapes = [(c_cap + cmax,), (max_colors + 2,), (max_colors + 2,),
              (2 * (c_cap + cmax),), (n,), (n,)]
    if chained:
        shapes += [(2 * sum(windows),), (n,)]
    return shapes


def solve(bodies: Bodies, mprops: WorldMassProperties, contacts: Contacts,
          params: SimParams, *, max_colors: int,
          warmstart_from: ContactConstraints | None, gs_cmax: int,
          colors_in: torch.Tensor | None = None, gs_windows: tuple = (),
          prev_colors=None, use_jacobi: bool = False,
          max_per_body: int = 32, gs_tail_window: int = 0, gs_split: int = 8,
          pair_slots: bool = False, layout_valid=None,
          stable_hint: bool | None = None,
          cache_in=None, presorted: bool = False, chained: bool = False,
          rhs_in_rung: bool = False, fused: bool = False,
          fused_rung0: int = 0, fused_class_counts=None, joints=None,
          stable_slots: bool = True, shard=None,
          static_layout: tuple | None = None):
    """Complete constraint solve for one frame. Returns ``(poses, vels,
    constraints, max_class, colors, solve_cache)``.

    ``joints`` (a 3D ``JointSet``): every substep builds the joints'
    constraints from its poses once its warmstart is applied, runs one
    joint pass before the biased contact sweep (or Jacobi pass) and one
    unbiased joint pass after integrating (:class:`JointSolve`), as the
    JAX package does; under the fused solver see below.

    Colours: ``colors_in`` (the broad phase's cached pair colours), else
    last frame's ``prev_colors`` where this frame's pair keys equal last
    frame's (and the shapes agree), else :func:`color_constraints` under
    ``gs_cmax`` as the class cap. Windows: the ``gs_windows`` ladder, else
    a uniform window of ``cmax`` = min(C, n + 64, gs_cmax) rows a colour,
    with ``gs_tail_window`` the colours past ``gs_split`` narrower (the
    split windows); either way one sweep is one plan
    (:func:`build_sweep_plan`, :func:`uniform_windows`). ``use_jacobi``
    runs the pseudo-Jacobi solver instead (:func:`jacobi_pass`,
    ``max_per_body`` sides a body), with no colours and no solve bundle.

    ``presorted``: the contacts (hence the constraints and ``colors_in``)
    are colour-major already (pair slots, or
    ``compact_contacts(sort_by_extra=True)``): identity layout, no field
    sort. ``pair_slots``: the contacts sit at their cached pair slots;
    ``layout_valid`` is then the pair validity, and ``stable_hint`` (the
    host's "broad-phase cache hit") says the slots are bitwise stable
    (both are read only under ``pair_slots``, as in the JAX package).
    Without pair slots that predicate is the bitwise equality of this
    frame's pair keys with last frame's (one host sync). Stable slots reuse
    the cached bundle (and ``prev_colors``) and warmstart slot by slot;
    otherwise the bundle is rebuilt and impulses transfer by key.
    ``stable_slots`` False (a scene with a mesh, whose rows re-pick their
    triangles in the same slots) transfers by key even then.
    ``chained`` selects the chained sweep, ``rhs_in_rung`` (chained only)
    the in-kernel rhs rebuild; both need the ladder, and without it the
    sweep is the unchained one, as in the JAX package. ``static_layout``
    (the static pair slots' ladder, with ``presorted`` pair slots): class
    c's rows start at the fixed ``sum(static_layout[:c-1])``, so the
    layout's offsets are host constants (:func:`static_offsets`) and
    only its counts are read back.

    ``fused`` (with ``presorted`` contacts in the static rung-padded layout
    of ``compact_contacts(static_windows=...)`` and their TRUE per-class
    counts ``fused_class_counts``) selects the fused solver: the fused
    constraint build (B9), then per substep the residue warmstart, one
    :func:`~wgmath_tpu_torch.dynamics.gs_fused.fused_substep1` and one
    unbiased ``fused_sweep`` carrying the pose update (``fused_integrate``'s
    arithmetic, on the substep's velocities); ``fused_rung0``
    is the residue class's rung. ``chained`` is then ignored. With joints
    the substep is the JAX package's ``substep_gs`` with the fused sweep
    instead: the rhs from ``update_rhs_sorted``, the warmstart of every
    row through the body-sorted sides, the biased joint pass, one
    standalone ``fused_sweep`` (B10) on the biased rhs, the integration,
    the unbiased joint pass and B10 again on the unbiased rhs (no B11,
    nothing carried).

    ``shard`` (a ``core.collectives.Shard``, or ``(group, n_ranks)``):
    every rank holds the whole solve, and each colour's rows are split
    across the ranks (:func:`_sweep_torch`), as the JAX package splits
    its colour windows under ``shard_map``. The windows and ``cmax`` round
    up to multiples of the rank count; the fused solver, the presorted
    layout, the chained sweep, the rhs rebuilt in the sweep and the split
    windows are off, as in the JAX package; Jacobi and the joints stay
    replicated."""
    shard = collectives.resolve(shard)
    dim = bodies.dim
    sub = params.substep().with_dim(dim)
    n = bodies.num_bodies
    dev = bodies.poses.translation.device
    assert n < (1 << 16), f"{n} bodies: 16-bit pair keys alias"
    use_fused = (fused and bool(gs_windows) and presorted and dim == 3
                 and colors_in is not None and fused_class_counts is not None
                 and not use_jacobi and shard is None)
    if use_fused:
        cons, big_t, big_meta = build_constraints_fused(
            bodies.poses, bodies.vels, mprops, contacts, params)
    else:
        cons = build_constraints(bodies.poses, bodies.vels, mprops, contacts,
                                 params)
    if not pair_slots:
        layout_valid = stable_hint = None
    same = None
    if (warmstart_from is not None
            and warmstart_from.body_a.shape == cons.body_a.shape):
        if layout_valid is not None:
            if stable_hint is not None:
                same = bool(stable_hint)
        else:
            prev = warmstart_from
            same = bool(host_int(torch.all(
                pair_key(cons.body_a, cons.body_b, cons.valid)
                == pair_key(prev.body_a, prev.body_b, prev.valid))))
    if warmstart_from is not None:
        # slot i holds last frame's manifold exactly when the keys are
        # stable, unless mesh manifolds re-pick their triangles in the
        # same slots (``stable_slots`` False): then always by key
        if same and stable_slots:
            cons = slotwise_warmstart(cons, warmstart_from, params)
        else:
            cons = transfer_warmstart(cons, warmstart_from, params)

    dynamic = bodies.is_dynamic()
    keep_v = (dynamic | bodies.is_kinematic())[:, None]
    zero = torch.zeros((), device=dev)
    vels = Velocity(torch.where(keep_v, bodies.vels.linear, zero),
                    torch.where(keep_v if dim == 3 else keep_v[:, 0],
                                bodies.vels.angular, zero))
    g = sub.gravity_array(dim, device=dev)
    inc = torch.where(dynamic[:, None], g[None, :] * sub.dt, zero)
    joint_solve = (None if joints is None
                   else JointSolve(joints, mprops, sub, max_colors))
    if use_jacobi:
        return _solve_jacobi(bodies, cons, vels, inc, sub, params,
                             max_per_body, joint_solve)

    c_cap = cons.body_a.shape[0]
    if colors_in is not None:
        colors = colors_in
    elif (same and prev_colors is not None
          and prev_colors.shape == cons.body_a.shape):
        # the pair graph is last frame's: its colours still hold
        colors = prev_colors
    else:
        colors = color_constraints(cons, n, max_colors=max_colors,
                                   class_cap=gs_cmax)
    windows = tuple(gs_windows[:max_colors])
    if windows:
        assert len(gs_windows) >= max_colors
        if shard is not None:
            windows = tuple(-(-w // shard.n) * shard.n for w in windows)
        cmax = max(windows)
    else:
        # a class holds at most one constraint a dynamic body
        cmax = min(c_cap, n + 64)
        if gs_cmax:
            cmax = min(cmax, gs_cmax)
    if shard is not None:
        # colour windows split evenly across the ranks
        cmax = -(-cmax // shard.n) * shard.n
        presorted = chained = rhs_in_rung = False
        gs_tail_window = 0
    if use_fused:
        return _solve_fused(
            bodies, cons, big_t, big_meta, vels, inc, sub, params,
            windows=windows, rung0=fused_rung0,
            class_counts=fused_class_counts, max_colors=max_colors,
            same=same, cache_in=cache_in, colors=colors,
            joint_solve=joint_solve)
    chained = chained and bool(windows)
    use_rhs_rung = rhs_in_rung and chained and dim == 3
    use_tail = bool(gs_tail_window and gs_tail_window < cmax and not windows)

    if same and cache_in is not None and [tuple(x.shape) for x in
                                          cache_in] == _bundle_shapes(
            c_cap, cmax, max_colors, n, windows, chained):
        bundle = tuple(cache_in)
        off_h = _layout_host(bundle, static_layout if presorted else None)
    else:
        bundle, off_h = _layout_sides(
            cons, colors, bodies, max_colors=max_colors, cmax=cmax,
            windows=windows, presorted=presorted, layout_valid=layout_valid,
            chained=chained, static_layout=static_layout)
    order_padded, _, class_counts = bundle[:3]
    ws_sides = bundle[3:6]
    chain = bundle[6:8] if chained else None
    layout_host = (off_h[:max_colors + 2], off_h[max_colors + 2:])
    if not windows:
        windows = uniform_windows(
            layout_host[1], max_colors=max_colors, cmax=cmax,
            tail_window=gs_tail_window if use_tail else 0, split=gs_split)

    # everything below lives in colour-sorted space for the whole solve
    if presorted:
        ss, packed_fields = pad_solver_fields_packed(cons, cmax)
        n_imp_s = torch.cat([cons.n_impulse, torch.zeros(
            (cmax,) + cons.n_impulse.shape[1:], device=dev)])
        t_imp_s = torch.cat([cons.t_impulse, torch.zeros(
            (cmax,) + cons.t_impulse.shape[1:], device=dev)])
    else:
        ss, packed_fields = sort_solver_fields_packed(cons, order_padded)
        idx_s0 = torch.clamp(order_padded, max=c_cap - 1)
        n_imp_s = cons.n_impulse[idx_s0]
        t_imp_s = cons.t_impulse[idx_s0]
    total = ss.body_a.shape[0]
    p_max = cons.n_impulse.shape[1]
    # the sweep plan is substep-invariant
    sweep_kw = dict(packed_fields=packed_fields,
                    sweep_plan=build_sweep_plan(ss, layout_host, windows, n,
                                                chain, p_max=p_max))
    if shard is not None:
        sweep_kw["shard"] = shard
    poses = bodies.poses
    com = bodies.local_mprops.com
    if use_rhs_rung:
        sweep_kw["rhs_consts"] = (
            float(sub.inv_dt), float(sub.contact_erp_inv_dt),
            float(sub.allowed_linear_error),
            float(sub.max_corrective_velocity),
            float(sub.contact_cfm_factor))
    else:
        cfm_biased = torch.full((total,), sub.contact_cfm_factor, device=dev)
        cfm_one = torch.ones(total, device=dev)
    for _ in range(params.num_solver_iterations):
        vels = Velocity(vels.linear + inc, vels.angular)
        if not use_rhs_rung:
            # relinearize the rhs in sorted space, once per substep
            n_rhs, n_rhs_wo_bias, t_rhs = update_rhs_sorted(ss, poses, sub)
        n_imp_s = n_imp_s * sub.warmstart_coefficient
        t_imp_s = t_imp_s * sub.warmstart_coefficient
        deltas = _ws_deltas(ss, n_imp_s, t_imp_s, ss.valid, p_max)
        vels = _ws_apply(vels, deltas, ws_sides)
        if joint_solve is not None:
            vels = joint_solve.biased(poses, vels)
        if use_rhs_rung:
            pose_tab = torch.cat([poses.rotation, poses.translation,
                                  poses.scale[:, None]], dim=-1)
            vels, n_imp_s, t_imp_s, rhs_store = gs_color_major_pass(
                ss, vels, n_imp_s, t_imp_s, layout_host, windows, chain,
                rhs_mode="biased", pose_tab=pose_tab,
                rhs_store=torch.zeros((total, p_max), device=dev),
                **sweep_kw)
            poses = integrate_velocity(poses, vels, com, sub.dt)
            if joint_solve is not None:
                vels = joint_solve.unbiased(vels)
            vels, n_imp_s, t_imp_s, _ = gs_color_major_pass(
                ss, vels, n_imp_s, t_imp_s, layout_host, windows, chain,
                rhs_mode="unbiased", rhs_store=rhs_store, **sweep_kw)
        else:
            biased = SimpleNamespace(**vars(ss))
            biased.n_rhs, biased.t_rhs = n_rhs, t_rhs
            biased.cfm_factor = cfm_biased
            vels, n_imp_s, t_imp_s = gs_color_major_pass(
                biased, vels, n_imp_s, t_imp_s, layout_host, windows, chain,
                **sweep_kw)
            poses = integrate_velocity(poses, vels, com, sub.dt)
            if joint_solve is not None:
                vels = joint_solve.unbiased(vels)
            unbiased = SimpleNamespace(**vars(ss))
            unbiased.n_rhs, unbiased.t_rhs = n_rhs_wo_bias, ss.t_rhs_wo_bias
            unbiased.cfm_factor = cfm_one
            vels, n_imp_s, t_imp_s = gs_color_major_pass(
                unbiased, vels, n_imp_s, t_imp_s, layout_host, windows,
                chain, **sweep_kw)
    # un-sort the impulses once (next frame's warmstart source)
    if presorted:
        n_imp, t_imp = n_imp_s[:c_cap], t_imp_s[:c_cap]
    else:
        # order_padded holds every slot once; its padding entries land on
        # one extra row that is cut off
        n_imp = torch.zeros((c_cap + 1,) + n_imp_s.shape[1:], device=dev)
        t_imp = torch.zeros((c_cap + 1,) + t_imp_s.shape[1:], device=dev)
        n_imp[order_padded] = n_imp_s
        t_imp[order_padded] = t_imp_s
        n_imp, t_imp = n_imp[:c_cap], t_imp[:c_cap]
    cons = dataclasses.replace(cons, n_impulse=n_imp, t_impulse=t_imp)
    head = torch.amax(class_counts[1:max_colors + 1])
    # uncoloured residue (segment 0 is not swept): report it through the
    # head so the host regrows gs_cmax
    head = head + torch.where(class_counts[0] > 0, cmax + class_counts[0],
                              torch.zeros_like(head))
    # the split windows' overflow signal: the largest class past gs_split
    tail = (torch.amax(class_counts[gs_split + 1:max_colors + 1])
            if use_tail and gs_split < max_colors else torch.zeros_like(head))
    max_class = torch.stack([head, tail])
    if gs_windows:
        # the class counts ride along for the host's rung regrow
        max_class = torch.cat([max_class, class_counts])
    return poses, vels, cons, max_class, colors, bundle


# ---------------------------------------------------------------------------
# The fused solver (gs_fused.py): static rung-padded layout, one kernel per
# sweep, velocities / poses / impulses component-major for the whole solve
# ---------------------------------------------------------------------------

# the relinearization rows the substep kernel reads from the field matrix
_RELIN_FIELDS = ("t_rhs_wo_bias", "local_pt_a", "local_pt_b", "info_dist",
                 "info_normal_vel")
# the residue rows' fields the out-of-kernel warmstart reads
_RESIDUE_FIELDS = ("dir_a", "tangent_a", "im_a", "im_b", "n_torque_a",
                   "n_ii_torque_a", "n_torque_b", "n_ii_torque_b",
                   "t_ii_torque_a", "t_ii_torque_b", "num_points")


def _fused_bundle(cons, windows: tuple, rung0: int, class_counts,
                  max_colors: int, n: int, w_g: int):
    """The 8-part fused solve bundle: identity order, the static offsets and
    the TRUE class counts (the rung-regrow signal), the warmstart sides,
    and the per-colour ``idx`` / ``inv`` tables."""
    dev = cons.body_a.device
    c_cap = cons.body_a.shape[0]
    _, offs, _ = fused_layout(windows, rung0)
    counts = torch.cat([class_counts.to(torch.int64), torch.zeros(
        max_colors + 2 - class_counts.shape[0], dtype=torch.int64,
        device=dev)])
    dyn_a, dyn_b = _dyn_sides(cons)
    return ((torch.arange(c_cap, device=dev),
             torch.as_tensor(offs, dtype=torch.int64, device=dev), counts)
            + _build_sides(cons.body_a, cons.body_b, dyn_a, dyn_b,
                           cons.valid, n)
            + build_fused_tables(cons.body_a, cons.body_b, dyn_a, dyn_b,
                                 cons.valid, windows=windows, rung0=rung0,
                                 w_g=w_g))


def _solve_fused(bodies: Bodies, cons, big_t, big_meta, vels: Velocity, inc,
                 sub, params: SimParams, *, windows: tuple, rung0: int,
                 class_counts, max_colors: int, same, cache_in, colors,
                 joint_solve=None):
    """The substep loop of the fused solver (the JAX package's
    ``substep_fused``, or with ``joint_solve`` its ``substep_gs`` with the
    fused sweep: :func:`_fused_joint_substeps`); returns as
    :func:`solve`."""
    n = bodies.num_bodies
    dev = big_t.device
    c_cap = cons.body_a.shape[0]
    _, _, ctot = fused_layout(windows, rung0)
    assert c_cap == ctot, (c_cap, ctot)
    w_g = gather_width(n, windows)
    p_max = cons.n_impulse.shape[1]
    s_len = cons.tangent_a.shape[-2]
    shapes = [(c_cap,), (max_colors + 2,), (max_colors + 2,), (2 * c_cap,),
              (n,), (n,), (len(windows), w_g), (len(windows), w_g)]
    if same and cache_in is not None and [tuple(x.shape) for x in
                                          cache_in] == shapes:
        bundle = tuple(cache_in)
    else:
        bundle = _fused_bundle(cons, windows, rung0, class_counts,
                               max_colors, n, w_g)
    counts = bundle[2].to(torch.int32)
    idx = bundle[6].to(torch.int32).contiguous()
    inv = bundle[7].to(torch.int32).contiguous()

    # substep-invariant operands, all rows of B9's field matrix
    k_pack = big_meta["cfm_factor"][0]
    win_t = big_t[:k_pack]
    meta = {f: big_meta[f] for f in PACK_FIELDS}
    src0 = min(big_meta[f][0] for f in _RELIN_FIELDS)
    src_t = big_t[src0:]
    src_meta = {f: (big_meta[f][0] - src0, big_meta[f][1])
                for f in _RELIN_FIELDS}
    t0 = big_meta["t_rhs_wo_bias"][0]
    trwb_t = big_t[t0:t0 + p_max * s_len]
    active_t = cons.valid.to(torch.float32)[None, :]
    nump_t = cons.num_points.to(torch.float32)[None, :]
    ws = float(sub.warmstart_coefficient)
    scalars = (ws, float(sub.contact_cfm_factor), float(sub.inv_dt),
               float(sub.contact_erp_inv_dt),
               float(sub.allowed_linear_error),
               float(sub.max_corrective_velocity))
    kw = dict(windows=windows, rung0=rung0, p_max=p_max, s_len=s_len,
              meta=meta)
    inc_t = torch.zeros((8, w_g), device=dev)
    inc_t[0:3, :n] = inc.T
    com_t = torch.zeros((3, w_g), device=dev)
    com_t[:, :n] = bodies.local_mprops.com.T
    if rung0:
        # the residue rows (colour 0) can share bodies, so no inverse
        # permutation exists: their warmstart is added outside the kernel,
        # static and invalid sides routed to the trash lane
        res = SimpleNamespace(**{f: getattr(cons, f)[:rung0]
                                 for f in _RESIDUE_FIELDS})
        res_valid = cons.valid[:rung0]
        dyn_a, dyn_b = _dyn_sides(res)
        trash = torch.full_like(res.num_points, w_g - 1)
        res_lanes = torch.cat([
            torch.where(res_valid & dyn_a, cons.body_a[:rung0], trash),
            torch.where(res_valid & dyn_b, cons.body_b[:rung0], trash)])
        res_index = (torch.arange(6, device=dev)[:, None], res_lanes[None])

    n_t = cons.n_impulse.reshape(c_cap, p_max).T.contiguous()
    t_t = cons.t_impulse.reshape(c_cap, p_max * s_len).T.contiguous()
    if joint_solve is not None:
        return _fused_joint_substeps(
            bodies, cons, vels, inc, sub, params, bundle, n_t, t_t,
            (win_t, active_t, nump_t), (idx, inv, counts), kw, w_g,
            joint_solve, max_colors=max_colors, rung0=rung0,
            windows=windows, colors=colors)
    vt = torch.zeros((8, w_g), device=dev)
    vt[0:3, :n] = vels.linear.T
    vt[3:6, :n] = vels.angular.T
    pose_p = torch.zeros((8, w_g), device=dev)
    pose_p[:, :n] = torch.cat([bodies.poses.rotation,
                               bodies.poses.translation,
                               bodies.poses.scale[:, None]], dim=-1).T
    for _ in range(params.num_solver_iterations):
        vt = vt + inc_t
        if rung0:
            d = _ws_deltas(res, n_t[:, :rung0].T * ws,
                           t_t[:, :rung0].T.reshape(rung0, p_max, s_len) * ws,
                           res_valid, p_max)
            # accumulate=True adds duplicates one after another in index
            # order on both devices (a sort on the card, no atomics)
            vt.index_put_(res_index, d.T, accumulate=True)
            vt[:, w_g - 1] = 0.0
        vt, n_t, t_t, n_wo = fused_substep1(
            vt, n_t, t_t, win_t, src_t, pose_p, active_t, nump_t, idx, inv,
            counts, src_meta=src_meta, scalars=scalars, **kw)
        # the pose update reads the substep's velocities: B10's opening
        # carries it
        vt, n_t, t_t, pose_p = fused_sweep(
            vt, n_t, t_t, win_t, active_t, nump_t, 1.0, n_wo, trwb_t, idx,
            inv, counts, integrate=(pose_p, com_t, sub.dt), **kw)
    vels = Velocity(vt[0:3, :n].T, vt[3:6, :n].T)
    poses = Sim(pose_p[0:4, :n].T, pose_p[4:7, :n].T, pose_p[7, :n])
    return _fused_result(poses, vels, cons, n_t, t_t, bundle,
                         max_colors=max_colors, rung0=rung0, windows=windows,
                         colors=colors)


def _fused_joint_substeps(bodies: Bodies, cons, vels: Velocity, inc, sub,
                          params: SimParams, bundle, n_t, t_t, fields,
                          tables, kw, w_g: int, joint_solve: JointSolve, *,
                          max_colors: int, rung0: int, windows: tuple,
                          colors):
    """The fused solver's substeps with joints (the JAX package's
    ``substep_gs`` with ``run_sweep``'s fused branch): velocities, poses
    and the rhs row-major, the impulses component-major as B10 takes them,
    each sweep one standalone B10 launch on velocities packed afresh."""
    n = bodies.num_bodies
    dev = n_t.device
    c_cap = cons.body_a.shape[0]
    p_max, s_len = kw["p_max"], kw["s_len"]
    ws = float(sub.warmstart_coefficient)
    cfm_biased = float(sub.contact_cfm_factor)
    poses, com = bodies.poses, bodies.local_mprops.com

    def sweep(vels, n_t, t_t, cfm, n_rhs, t_rhs):
        vt = torch.zeros((8, w_g), device=dev)
        vt[0:3, :n] = vels.linear.T
        vt[3:6, :n] = vels.angular.T
        vt, n_t, t_t = fused_sweep(
            vt, n_t, t_t, *fields, cfm,
            n_rhs.reshape(c_cap, p_max).T.contiguous(),
            t_rhs.reshape(c_cap, p_max * s_len).T.contiguous(), *tables,
            **kw)
        return Velocity(vt[0:3, :n].T, vt[3:6, :n].T), n_t, t_t

    for _ in range(params.num_solver_iterations):
        vels = Velocity(vels.linear + inc, vels.angular)
        n_rhs, n_rhs_wo_bias, t_rhs = update_rhs_sorted(cons, poses, sub)
        n_t, t_t = n_t * ws, t_t * ws
        deltas = _ws_deltas(cons, n_t.T, t_t.T.reshape(c_cap, p_max, s_len),
                            cons.valid, p_max)
        vels = _ws_apply(vels, deltas, bundle[3:6])
        vels = joint_solve.biased(poses, vels)
        vels, n_t, t_t = sweep(vels, n_t, t_t, cfm_biased, n_rhs, t_rhs)
        poses = integrate_velocity(poses, vels, com, sub.dt)
        vels = joint_solve.unbiased(vels)
        vels, n_t, t_t = sweep(vels, n_t, t_t, 1.0, n_rhs_wo_bias,
                               cons.t_rhs_wo_bias)
    return _fused_result(poses, vels, cons, n_t, t_t, bundle,
                         max_colors=max_colors, rung0=rung0, windows=windows,
                         colors=colors)


def _fused_result(poses, vels, cons, n_t, t_t, bundle, *, max_colors: int,
                  rung0: int, windows: tuple, colors):
    """The fused solve's return: the impulses row-major again and the
    class counts with the residue's overflow signal."""
    c_cap = cons.body_a.shape[0]
    p_max, s_len = cons.n_impulse.shape[1], cons.tangent_a.shape[-2]
    cons = dataclasses.replace(
        cons, n_impulse=n_t.T.reshape(c_cap, p_max),
        t_impulse=t_t.T.reshape(c_cap, p_max, s_len))
    class_counts = bundle[2]
    head = torch.amax(class_counts[1:max_colors + 1])
    # residue past its own rung: report it through the head so the host
    # regrows gs_cmax
    head = head + torch.where(class_counts[0] > rung0,
                              max(windows) + class_counts[0],
                              torch.zeros_like(head))
    max_class = torch.cat([torch.stack([head, torch.zeros_like(head)]),
                           class_counts])
    return poses, vels, cons, max_class, colors, bundle
