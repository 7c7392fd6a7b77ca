"""One physics frame: mass properties → broad phase (slack cache, repair,
refresh) → narrow phase → constraints → Gauss-Seidel solve under the
window ladder → integration (counterpart of ``wgmath_tpu/pipeline.py``:
``PhysicsState``, ``PipelineConfig``, ``step``, ``step_checked``,
``fine_bucket``).

The JAX step is one jitted program whose branches are ``lax.cond`` /
``lax.switch``; here each branch is a Python branch on a host value (one
counted host sync each, ``core.dispatch.host_int``). ``step`` runs the
grid, brute-force or LBVH broad phase (``bp_algo``; the LBVH's pairs then
pass the grid's sphere prefilter and static-static drop), with its cache
when ``bp_slack`` > 0; the
pair colours ride that cache when ``gs_cmax`` > 0 too, else the solve
colours the contacts itself (reusing last frame's colours while the pair
keys hold). Without ``gs_windows`` every colour sweeps a uniform window
(``gs_tail_window``: narrower past ``gs_split``, the split windows), and
``use_jacobi`` selects the pseudo-Jacobi solver (the README's quick start,
``PipelineConfig(pair_capacity=16384)``, is the uniform windows with
colouring in the solve). Under the ``gs_windows`` ladder it runs the
solver configurations the bench calls

- ``ladder``: contacts compacted colour-major (``contact_capacity``), or
  sorted in the solve when ``contact_capacity == 0``; gather and
  unique-index scatter-add per rung;
- ``chained`` (``gs_chained``): the same layout, velocity stream and
  last-writer chain;
- ``chained_rr`` (+ ``gs_rhs_in_rung``): the rhs rebuilt in the kernel;
- ``chained_ps`` (+ ``gs_pair_slots``): contacts stay at their cached
  colour-major pair slots;
- ``chained_ss`` (+ ``gs_static_slots``): the cached pairs of colour c sit
  at the fixed slots ``[W[c-1], W[c-1] + count_c)``, W the running sum of
  the ladder, and what does not fit its rung (and uncoloured residue) in
  a tail past ``sum(gs_windows)``, unswept for a frame; the solve's class
  offsets are then host constants. It needs ``pair_capacity >=
  sum(gs_windows) + 256``, which ``step_checked`` keeps; below it the
  step runs ``chained_ps``;
- ``fused`` (``gs_fused``): contacts compacted to the static rung-padded
  colour-major layout (``gs_rung0`` rows of residue, then one rung per
  colour; ``contact_capacity`` is ignored), the fused constraint build,
  and per substep one substep kernel, one integration kernel and one
  sweep kernel (``dynamics/gs_fused.py``). It takes precedence over
  ``gs_pair_slots`` and ``gs_chained``, as in the JAX package.
  ``gs_fused_pallas`` chose between two TPU lowerings of the same
  formulation; the port has one, so the flag is accepted and changes
  nothing: on the card the kernels run, on the CPU their plain versions.

``gs_fused``, ``gs_chained`` and ``gs_pair_slots`` need the ladder (and
the fused layout and the pair slots the cached colours); without them the
unfused, unchained form runs, as in the JAX package. Impulse joints
(``state.joints``) solve in every configuration: per substep one joint
pass before the biased contact sweep and one after integrating (under
``fused`` the sweeps are then two standalone sweep kernels a substep, as
in the JAX package). A scene with a triangle mesh appends the mesh
contacts after the narrow phase's (``queries/mesh_contact.py``: the
trimesh-ball pairs at ``mesh_pair_capacity``, the trimesh-convex pairs at
half of it, ``mesh_k_best`` rows a pair), colours in the solve and
transfers warmstart impulses by key: the rows of one pair re-pick their
triangles each frame; a 2D scene with a polyline appends its ball and
cuboid contacts the same way.

2D scenes (bodies with 2D poses: rotations as (cos, sin), scalar angular
velocities) run every configuration above as the JAX package runs them:
the fused solver, the pair-slot layout and the rhs rebuilt in the sweep
are 3D only there, so a 2D step takes the unfused sweep (``gs_fused`` and
``gs_pair_slots`` change nothing) and the rhs of ``update_rhs_sorted``;
its sweeps are plain PyTorch (``solver.run_sweep``), as the JAX package
runs them in XLA (``gs_static_slots`` changes nothing there either).
Broad phases other than the grid, the brute force and the LBVH are
refused with ``NotImplementedError``.

``shard=(group, n_ranks)`` runs the step on ``n_ranks`` ``torch.distributed``
ranks, each holding the whole state (``parallel/sharded_pipeline.py``), and
splits the heavy phases across them as the JAX package's ``shard`` does:
each rank takes a row block of the grid (or brute-force) broad phase, a
share of the pairs in the narrow phase, and a slice of each colour of the
Gauss-Seidel sweep (``solver.solve``). The pairs ride one all-gather a
refresh and are compacted in rank order, which is the single-device
step's order (the colouring hashes pair slots, so the sharded step
colours as the single-device one does). The compacted pairs lie at the
front of the list, so the narrow phase gives rank k every n-th slot from
k (where the JAX package, whose gathered list keeps a gap after each
rank's block, gives it a block of slots); an overflow
rides the sign (one rank negative makes the total negative), and a rank
that fills its share of the capacity reports its share times the rank
count, so that ``step_checked`` regrows ``pair_capacity``. The contacts
come back slot for slot in one all-gather a dtype, and the compaction
demands are the largest rank's times the rank count. The fused solver,
the pair slots (static ones too), the chained sweep and the split
windows are off under a shard, as in the JAX package; the rest runs
replicated and deterministic on every rank.

``pair_count`` = [pairs, contacts, head class, bp_path (0 hit, 1 repair,
2 full), tail class, bc/sat/pfm compaction demand, class counts...].
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

from wgmath_tpu_torch.broad_phase.brute_force import (
    PairList,
    compact_hits,
    find_pairs,
)
from wgmath_tpu_torch.broad_phase.grid import find_pairs_grid, top_k_desc
from wgmath_tpu_torch.broad_phase.lbvh import find_pairs_lbvh
from wgmath_tpu_torch.broad_phase.brute_force import find_pairs_partial
from wgmath_tpu_torch.core import collectives
from wgmath_tpu_torch.core.dispatch import (
    capacity_bucket,
    host_int,
    host_list,
    to_device,
)
from wgmath_tpu_torch.dynamics.body import Bodies, update_mprops
from wgmath_tpu_torch.dynamics.constraint import (
    ContactConstraints,
    Contacts,
    _dot3,
    compact_contacts,
)
from wgmath_tpu_torch.dynamics.joint import JointSet
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.dynamics.solver import (
    assign_new_pair_colors,
    color_pairs,
    minimize_colors,
    solve,
    transfer_pair_colors,
)
from wgmath_tpu_torch.queries import mesh_contact
from wgmath_tpu_torch.queries.gjk import _sqrt
from wgmath_tpu_torch.queries.narrow_phase import narrow_phase
from wgmath_tpu_torch.shapes.shape import (
    BALL,
    CAPSULE,
    CONE,
    CONVEX,
    CUBOID,
    CYLINDER,
    POLYLINE,
    SEGMENT,
    TRIANGLE,
    TRIMESH,
    ShapeSet,
    ball_radii_or_nan,
    world_aabbs,
)


@dataclasses.dataclass
class PhysicsState:
    """World state. ``bp_pairs`` / ``bp_ref`` are the broad-phase cache
    (``bp_slack`` > 0 only); ``bp_colors`` = (pair colours, gs_cmax,
    max_colors, slot flag) with the knobs as host ints, or None without
    cached colours; ``prev_colors`` last frame's contact colours;
    ``solve_cache`` the solve bundle reused while the contact set holds;
    ``joints`` the impulse joints (``dynamics.joint.JointSet``), carried
    from frame to frame unchanged (the JAX package's field, placed last
    here so that positional constructions without it keep working)."""

    bodies: Bodies
    shapes: ShapeSet
    prev_constraints: ContactConstraints | None
    pair_count: torch.Tensor
    prev_colors: torch.Tensor | None = None
    bp_pairs: PairList | None = None
    bp_ref: tuple | None = None  # (mins, maxs) reference boxes
    bp_colors: tuple | None = None
    solve_cache: tuple | None = None
    joints: JointSet | None = None


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration; field names and defaults follow the JAX
    package so a configuration carries across as JSON."""

    pair_capacity: int = 1024
    contact_capacity: int = 0
    use_jacobi: bool = False
    max_colors: int = 32
    max_per_body: int = 32
    broad_phase_block: int = 256
    broad_phase_max_per_row: int = 64
    sat_pair_capacity: int = 0
    pfm_pair_capacity: int = 0
    bc_pair_capacity: int = 0
    gs_cmax: int = 0
    mesh_pair_capacity: int = 512
    mesh_k_best: int = 4
    bp_algo: str = "auto"
    bp_cell_cap: int = 8
    bp_global_cap: int = 16
    bp_cand_budget: int = 48
    manifold_points: int = 0
    bp_slack: float = 0.0
    bp_vel_slack: float = 0.33
    bp_vel_slack_cap: float = 0.1
    bp_recolor_cap: int = 128
    bp_claim_rounds: int = 4
    gs_pair_slots: bool = False
    gs_static_slots: bool = False
    bp_min_color_sweeps: int = 0
    bp_repair_cap: int = 32
    bp_force: str | None = None
    gs_tail_window: int = 0
    gs_split: int = 8
    gs_windows: tuple = ()
    gs_fused: bool = False
    gs_fused_pallas: bool = False
    gs_rung0: int = 256
    gs_chained: bool = False
    gs_rhs_in_rung: bool = False
    fine_capacities: bool = False
    gs_rung_quantum: int = 256
    gs_rung_headroom: float = 1.15

    @staticmethod
    def from_dict(d: dict) -> "PipelineConfig":
        d = dict(d)
        d["gs_windows"] = tuple(d.get("gs_windows", ()))
        return PipelineConfig(**d)


def _check_slice(state: PhysicsState, config: PipelineConfig,
                 shard) -> None:
    """Refuse what the port does not take: broad phases other than the
    grid, the brute force and the LBVH. (A shard is checked against its
    process group by ``core.collectives.resolve``.)"""
    bad = []
    if config.bp_algo not in ("auto", "grid", "brute", "lbvh"):
        bad.append(f"bp_algo={config.bp_algo}")
    if bad:
        raise NotImplementedError(
            "wgmath_tpu_torch.pipeline.step does not take these; refused: "
            + ", ".join(bad))


def auto_manifold_points(shapes: ShapeSet, dim: int, dynamic=None) -> int:
    """Narrowest safe manifold width for this scene, read from the shape
    tags on the host. 3D: 4 where two cuboids can meet and one of them can
    move (cuboid-cuboid SAT clipping emits up to 4 points), or where a
    capsule, cylinder or cone can move or a cuboid can (the support-face
    clip of those pairs emits up to 4); else 1 (every other kernel emits
    one point a pair, and every solver pass costs in proportion to the
    width). The support-mapped kinds are the capsule, cone, cylinder,
    convex polyhedron, segment and triangle. 2D: 2 where two cuboids can
    meet and one can move, or a cuboid can meet a polyline and one of
    them can move (both clip to 2 points); else 1. ``dynamic``: an
    optional per-body dynamic mask; with every shape that could need more
    static (ground and walls) the width stays 1. Pass the result as
    ``PipelineConfig.manifold_points``."""
    tags = shapes.tag.cpu()
    dyn = None
    if dynamic is not None:
        dyn = (dynamic.cpu() if torch.is_tensor(dynamic)
               else torch.tensor(dynamic, dtype=torch.bool))

    def any_dyn(mask):
        return bool(mask.any()) if dyn is None else bool((mask & dyn).any())

    cuboid = tags == CUBOID
    if dim == 2:
        polyline = tags == POLYLINE
        if (int(cuboid.sum()) >= 2 and any_dyn(cuboid)) or (
                int(cuboid.sum()) >= 1 and POLYLINE in shapes.kinds
                and any_dyn(cuboid | polyline)):
            return 2
        return 1
    if int(cuboid.sum()) >= 2 and any_dyn(cuboid):
        return 4
    pfm = ((tags == CAPSULE) | (tags == CONE) | (tags == CYLINDER)
           | (tags == CONVEX) | (tags == SEGMENT) | (tags == TRIANGLE))
    if bool(pfm.any()) and (any_dyn(pfm) or any_dyn(cuboid)):
        return 4
    return 1


def new_state(bodies: Bodies, shapes: ShapeSet,
              joints: JointSet | None = None) -> PhysicsState:
    return PhysicsState(bodies, shapes, None,
                        torch.zeros(8, dtype=torch.int64,
                                    device=bodies.poses.translation.device),
                        joints=joints)


def step(state: PhysicsState, params: SimParams, config: PipelineConfig, *,
         warmstart: bool = True, shard=None) -> PhysicsState:
    """Advance one frame of ``params.dt``."""
    _check_slice(state, config, shard)
    sh = collectives.resolve(shard)
    if sh is not None and config.pair_capacity % sh.n:
        raise ValueError(f"pair_capacity {config.pair_capacity} must be a "
                         f"multiple of the rank count {sh.n}")
    if state.joints is not None and state.joints.dim != state.bodies.dim:
        raise ValueError(f"{state.joints.dim}D joints on "
                         f"{state.bodies.dim}D bodies")
    bodies = state.bodies
    dev = bodies.poses.translation.device
    mprops = update_mprops(bodies.poses, bodies.local_mprops)
    mins, maxs = world_aabbs(state.shapes, bodies.poses,
                             margin=params.prediction_distance)
    radii = (ball_radii_or_nan(state.shapes, bodies.poses)
             if BALL in state.shapes.kinds else None)
    n_bodies = mins.shape[0]
    use_grid = config.bp_algo == "grid" or (config.bp_algo == "auto"
                                            and n_bodies >= 1024)
    slack = config.bp_slack
    dim = mins.shape[1]
    dim_sqrt = float(math.sqrt(dim))
    dyn_mask = bodies.is_dynamic()
    move_mask = bodies.is_moving()
    mc = config.max_colors
    # the pair colours ride the broad-phase cache only under a class cap
    # (which parks colouring residue in an unswept class and signals it);
    # otherwise, for Jacobi, and with a mesh (the k rows of one pair share
    # its dynamic body, so pair colours would break a colour's
    # disjointness), the solve colours (or needs no colours)
    has_mesh = bool(state.shapes.kinds & {TRIMESH, POLYLINE})
    color_with_bp = (slack > 0 and not config.use_jacobi
                     and config.gs_cmax > 0 and not has_mesh)
    # pair-slot layout: the cached pair list is kept colour-major and the
    # contacts stay at their pair slots (not under the fused solver)
    use_pair_slots = (config.gs_pair_slots and color_with_bp
                      and config.gs_chained and bool(config.gs_windows)
                      and not config.gs_fused and dim == 3 and sh is None)
    # static pair slots: each colour at a fixed slot range of the cached
    # list. The tag's flag says which layout the cache holds (1: colour-
    # major, 2 + a hash of the ladder: static rungs), so a cache written
    # under another layout or ladder refreshes
    swin = tuple(config.gs_windows[:mc]) if use_pair_slots else ()
    use_static_slots = (use_pair_slots and config.gs_static_slots
                        and config.pair_capacity >= sum(swin) + 256)
    slot_flag = (2 + zlib.crc32(repr(swin).encode()) % 2000000000
                 if use_static_slots else 1)

    if slack > 0:
        # velocity-aware slack, quantized to three levels so consecutive
        # refreshes reuse bitwise-identical thresholds; the sphere
        # prefilter admits the same drift
        speed = torch.sqrt(torch.sum(bodies.vels.linear ** 2, dim=-1,
                                     keepdim=True))
        cap_v = config.bp_vel_slack_cap
        t1 = 0.25 * cap_v / config.bp_vel_slack
        t2 = 0.75 * cap_v / config.bp_vel_slack
        infl = slack + 0.5 * cap_v * ((speed > t1).to(torch.float32)
                                      + (speed > t2).to(torch.float32))
        radii_bp = (radii + dim_sqrt * infl[:, 0] if radii is not None
                    else None)
    else:
        infl, radii_bp = None, radii
    sphere_margin = params.prediction_distance

    def sharded_bp(mn, mx):
        """This rank's row block of the grid or the brute force (the LBVH
        has no row blocks: under a shard it runs the brute force, as in
        the JAX package), gathered and compacted in rank order."""
        cap_l = config.pair_capacity // sh.n
        nb_l = -(-n_bodies // sh.n)
        off = sh.rank * nb_l
        if use_grid:
            p = find_pairs_grid(
                mn, mx, capacity=cap_l,
                max_per_body=config.broad_phase_max_per_row,
                cell_cap=config.bp_cell_cap,
                global_cap=config.bp_global_cap,
                cand_budget=config.bp_cand_budget, ball_radius=radii_bp,
                margin=sphere_margin, dynamic=dyn_mask, row_offset=off,
                row_count=nb_l)
        else:
            def rsl(x):
                pad = torch.zeros((nb_l * sh.n - n_bodies,) + x.shape[1:],
                                  dtype=x.dtype, device=dev)
                return torch.cat([x, pad])[off:off + nb_l]

            p = find_pairs_partial(
                rsl(mn), rsl(mx), off, mn, mx, capacity=cap_l,
                row_active=rsl(torch.ones(n_bodies, dtype=torch.bool,
                                          device=dev)),
                block=config.broad_phase_block,
                max_per_row=config.broad_phase_max_per_row,
                ball_radius=radii_bp,
                row_ball_radius=None if radii_bp is None else rsl(radii_bp),
                margin=sphere_margin, dynamic=dyn_mask,
                row_dynamic=rsl(dyn_mask))
        g = collectives.all_gather_cat(torch.cat([
            p.body_a, p.body_b, p.valid.to(torch.int64),
            p.count.reshape(1).to(torch.int64)])[None], sh)
        counts = g[:, -1]
        neg = torch.any(counts < 0)
        tot = counts.abs().sum()
        # a rank that fills its share may have dropped pairs the single
        # device keeps: report its share times the ranks (a regrow)
        full = counts.abs().amax()
        tot = torch.where(full > cap_l, torch.maximum(tot, full * sh.n), tot)
        count = torch.where(neg, -torch.clamp(tot, min=1), tot)
        valid = g[:, 2 * cap_l:3 * cap_l].reshape(-1) != 0
        out_a, out_b, emit = compact_hits(
            valid, g[:, :cap_l].reshape(-1), g[:, cap_l:2 * cap_l].reshape(-1),
            config.pair_capacity)
        valid = (torch.arange(config.pair_capacity, device=dev)
                 < torch.clamp(emit, max=config.pair_capacity))
        return PairList(out_a, out_b, valid, count)

    def run_bp(mn, mx):
        if sh is not None:
            return sharded_bp(mn, mx)
        if config.bp_algo == "lbvh":
            # the tree knows no balls and no statics: the grid's sphere
            # prefilter and static-static drop run on its pairs instead,
            # zeroing the dropped rows in place (the grid's pair set while
            # no leaf overflows its 64-pair window, ROADMAP C11)
            p = find_pairs_lbvh(mn, mx, capacity=config.pair_capacity)
            keep = p.valid & (dyn_mask[p.body_a] | dyn_mask[p.body_b])
            if radii_bp is not None:
                centers = (mn + mx) * 0.5
                dc = centers[p.body_a] - centers[p.body_b]
                d = _sqrt(_dot3(dc, dc))
                lim = (radii_bp[p.body_a] + radii_bp[p.body_b]
                       + sphere_margin)
                keep = keep & ~(d > lim)  # a NaN limit keeps the pair
            zero = torch.zeros_like(p.body_a)
            return PairList(torch.where(keep, p.body_a, zero),
                            torch.where(keep, p.body_b, zero), keep, p.count)
        if use_grid:
            return find_pairs_grid(
                mn, mx, capacity=config.pair_capacity,
                max_per_body=config.broad_phase_max_per_row,
                cell_cap=config.bp_cell_cap,
                global_cap=config.bp_global_cap,
                cand_budget=config.bp_cand_budget, ball_radius=radii_bp,
                margin=sphere_margin, dynamic=dyn_mask)
        return find_pairs(mn, mx, capacity=config.pair_capacity,
                          block=config.broad_phase_block,
                          max_per_row=config.broad_phase_max_per_row,
                          ball_radius=radii_bp, margin=sphere_margin,
                          dynamic=dyn_mask)

    def recolor(p, minimize: bool):
        cols = color_pairs(p.body_a, p.body_b, p.valid, dyn_mask[p.body_a],
                           dyn_mask[p.body_b], n_bodies, max_colors=mc,
                           claim_rounds=config.bp_claim_rounds,
                           class_cap=config.gs_cmax)
        if minimize and config.bp_min_color_sweeps:
            cols = minimize_colors(
                p.body_a, p.body_b, p.valid, cols, dyn_mask[p.body_a],
                dyn_mask[p.body_b], n_bodies, max_colors=mc,
                sweeps=config.bp_min_color_sweeps, class_cap=config.gs_cmax)
        return cols

    def carry_colors(p, prev_p, prev_cols, knobs_ok: bool, minimize: bool):
        """Surviving pairs keep their colour; up to bp_recolor_cap new
        pairs are coloured greedily; more churn recolours in full (with
        ``minimize``, then minimizes the colours)."""
        mapped = transfer_pair_colors(p.body_a, p.body_b, p.valid,
                                      prev_p.body_a, prev_p.body_b,
                                      prev_p.valid, prev_cols)
        n_new = host_int((p.valid & (mapped == 0)).sum())
        if knobs_ok and n_new == 0:
            return mapped
        if knobs_ok and n_new <= config.bp_recolor_cap:
            return assign_new_pair_colors(
                p.body_a, p.body_b, p.valid, mapped, dyn_mask[p.body_a],
                dyn_mask[p.body_b], n_bodies, max_colors=mc,
                class_cap=config.gs_cmax, new_cap=config.bp_recolor_cap,
                n_new=n_new)
        return recolor(p, minimize)

    def sort_pairs_cm(p, cols):
        """Colour-major pair order: valid pairs by colour (residue 0
        first), invalid tail; stable."""
        if use_static_slots:
            return sort_pairs_static(p, cols)
        key = torch.where(p.valid, torch.clamp(cols, 0, mc),
                          torch.full_like(cols, mc + 1))
        perm = torch.argsort(key, stable=True)
        return (PairList(p.body_a[perm], p.body_b[perm], p.valid[perm],
                         p.count),
                (cols[perm], config.gs_cmax, mc, slot_flag))

    def sort_pairs_static(p, cols):
        """Static rung placement: colour c's valid pairs at slots
        ``[W[c-1], W[c-1] + count_c)`` in their colour-major order, W the
        running sum of the ladder. Valid pairs that do not fit (a class
        past its rung, uncoloured residue) go to the tail ``[sum(W),
        cap)``; invalid rows are dropped. A tail that does not fit drops
        its last pairs and turns the count negative, of magnitude at
        least ``sum(W)`` + the tail + 256, so that ``step_checked`` regrows
        the capacity."""
        cap = p.body_a.shape[0]
        w_np = np.concatenate([[0], np.cumsum(swin)]).astype(np.int64)
        total = int(w_np[-1])
        tab = to_device(torch.from_numpy(np.concatenate(
            [w_np[:-1], np.asarray(swin, np.int64)])), dev)
        w_start, win = tab[:len(swin)], tab[len(swin):]
        cls = torch.clamp(cols, 0, mc)
        in_class = p.valid & (cls >= 1)
        key = torch.where(in_class, cls, torch.full_like(cls, mc + 1))
        perm = torch.argsort(key, stable=True)
        skey, valid_s = key[perm], p.valid[perm]
        counts = torch.bincount(skey, minlength=mc + 2)
        dyn_off = torch.cumsum(counts, 0) - counts
        rank = torch.arange(cap, device=dev) - dyn_off[skey]
        ci = torch.clamp(skey - 1, 0, len(swin) - 1)
        # class rows are valid by construction
        fits = (skey <= mc) & (rank < win[ci])
        tail_need = valid_s & ~fits
        tail_rank = torch.cumsum(tail_need.to(torch.int64), 0) - 1
        tail_ok = tail_need & (total + tail_rank < cap)
        dst = torch.where(fits, w_start[ci] + rank,
                          torch.where(tail_ok, total + tail_rank,
                                      torch.full_like(rank, cap)))
        n_drop = (tail_need & ~tail_ok).sum()

        def scatter(x):
            # slot ``cap`` collects the dropped rows and is cut off
            out = torch.zeros(cap + 1, dtype=x.dtype, device=dev)
            out[dst] = x[perm]
            return out[:cap]

        need = total + tail_need.sum() + 256
        mag = torch.maximum(p.count.abs(), need)
        count = torch.where((p.count < 0) | (n_drop > 0),
                            -torch.clamp(mag, min=1), p.count)
        return (PairList(scatter(p.body_a), scatter(p.body_b),
                         scatter(p.valid), count),
                (scatter(cols), config.gs_cmax, mc, slot_flag))

    def colored_bp(mn, mx, reuse=None):
        p = run_bp(mn, mx)
        if not color_with_bp:
            return p, (mn, mx), None
        if reuse is None:
            cols = recolor(p, True)
        else:
            prev_p, prev_tag = reuse
            knobs_ok = (prev_tag[1] == config.gs_cmax
                        and prev_tag[2] == mc)
            cols = carry_colors(p, prev_p, prev_tag[0], knobs_ok, True)
        return finish_bp(p, cols, (mn, mx))

    def finish_bp(p, cols, ref):
        if use_pair_slots:
            p, tag = sort_pairs_cm(p, cols)
        else:
            tag = (cols, config.gs_cmax, mc, 0)
        return p, ref, tag

    def repair_bp():
        """Recompute the pair rows of the bodies nearest their reference
        box walls (every escaped body first) against the others' cached
        reference boxes, and merge them into the cached list."""
        ref0, ref1 = state.bp_ref
        ecap = min(config.bp_repair_cap, n_bodies)
        margin = torch.amin(torch.minimum(mins - ref0, ref1 - maxs), dim=1)
        urgency = torch.where(move_mask, -margin,
                              torch.full_like(margin, -math.inf))
        e_ids = top_k_desc(urgency, ecap)[1]
        sel = torch.zeros(n_bodies, dtype=torch.bool, device=dev)
        sel[e_ids] = True
        r0 = torch.where(sel[:, None], mins - infl, ref0)
        r1 = torch.where(sel[:, None], maxs + infl, ref1)
        op = state.bp_pairs
        keep = op.valid & ~sel[op.body_a] & ~sel[op.body_b]
        cols = torch.arange(n_bodies, device=dev)
        ov = torch.all((r0[e_ids][:, None, :] <= r1[None])
                       & (r0[None] <= r1[e_ids][:, None, :]), dim=-1)
        ov &= cols[None, :] != e_ids[:, None]
        ov &= dyn_mask[e_ids][:, None] | dyn_mask[None, :]
        ov &= (~sel[cols])[None, :] | (cols[None, :] > e_ids[:, None])
        if radii is not None:
            refc = 0.5 * (r0 + r1)
            he = 0.5 * torch.amax(r1 - r0, dim=1)
            reach = radii + dim_sqrt * (he - radii)
            d2 = torch.sum((refc[e_ids][:, None, :] - refc[None]) ** 2,
                           dim=-1)
            lim = reach[e_ids][:, None] + reach[None] + sphere_margin
            finite = torch.isfinite(radii)
            both_ball = finite[e_ids][:, None] & finite[None]
            ov &= (d2 <= lim * lim) | ~both_ball
        row_counts = ov.sum(-1)
        kk = min(max(64, config.broad_phase_max_per_row), n_bodies)
        row_overflow = torch.any(row_counts > kk)
        sc2 = torch.where(ov, n_bodies - cols[None, :],
                          torch.zeros_like(cols)[None, :])
        top2 = top_k_desc(sc2, kk)[0]
        hit2 = top2 > 0
        nb = torch.where(hit2, n_bodies - top2, torch.zeros_like(top2))
        na = e_ids[:, None].expand_as(nb)
        cap = config.pair_capacity
        all_a = torch.cat([op.body_a, torch.minimum(na, nb).reshape(-1)])
        all_b = torch.cat([op.body_b, torch.maximum(na, nb).reshape(-1)])
        all_v = torch.cat([keep, hit2.reshape(-1)])
        out_a, out_b, total = compact_hits(all_v, all_a, all_b, cap)
        count = torch.where(row_overflow, -torch.clamp(total, min=1), total)
        valid = torch.arange(cap, device=dev) < torch.clamp(total, max=cap)
        p = PairList(out_a, out_b, valid, count)
        if not color_with_bp:
            return p, (r0, r1), None
        cols_out = carry_colors(p, op, state.bp_colors[0], True, False)
        return finish_bp(p, cols_out, (r0, r1))

    cache_ok = (slack > 0 and state.bp_pairs is not None
                and state.bp_ref is not None
                and state.bp_pairs.body_a.shape[0] == config.pair_capacity
                and (not color_with_bp or state.bp_colors is not None))
    if slack <= 0:
        bp_path = 2
        pairs, _, bp_colors = colored_bp(mins, maxs)
        bp_ref = None
    elif cache_ok:
        n_esc = host_int(torch.any((mins < state.bp_ref[0])
                                   | (maxs > state.bp_ref[1]), dim=1).sum())
        knobs_ok = True
        if color_with_bp:
            # cached colours are stale once the colouring knobs changed
            tag = state.bp_colors
            knobs_ok = tag[1] == config.gs_cmax and tag[2] == mc
            if use_pair_slots:
                # the pair-slot layout needs a cached list sorted under
                # the same slot scheme (flag 1: colour-major, 2 + a hash
                # of the ladder: static rungs); a cache written by another
                # configuration refreshes
                knobs_ok = knobs_ok and len(tag) > 3 and tag[3] == slot_flag
        if knobs_ok and n_esc == 0:
            bp_path = 0
        elif (knobs_ok and config.bp_repair_cap > 0
              and n_esc <= config.bp_repair_cap):
            bp_path = 1
        else:
            bp_path = 2
        bp_path = {"hit": 0, "repair": 1, "miss": 2}.get(config.bp_force,
                                                         bp_path)
        if bp_path == 0:
            pairs, bp_ref, bp_colors = (state.bp_pairs, state.bp_ref,
                                        state.bp_colors)
        elif bp_path == 1:
            pairs, bp_ref, bp_colors = repair_bp()
        else:
            pairs, bp_ref, bp_colors = colored_bp(
                mins - infl, maxs + infl,
                reuse=((state.bp_pairs, state.bp_colors) if color_with_bp
                       else None))
    else:
        bp_path = 2
        pairs, bp_ref, bp_colors = colored_bp(mins - infl, maxs + infl)

    p_max = config.manifold_points or (4 if dim == 3 else 2)
    if sh is None:
        contacts, np_needed = narrow_phase(
            bodies.poses, state.shapes, pairs, params.prediction_distance,
            p_max=p_max, bc_capacity=config.bc_pair_capacity,
            sat_capacity=config.sat_pair_capacity,
            pfm_capacity=config.pfm_pair_capacity)
    else:
        contacts, np_needed = _sharded_narrow_phase(
            bodies.poses, state.shapes, pairs, params, config, p_max, sh)
    if has_mesh:
        contacts = mesh_contact.append_mesh_contacts(
            contacts, bodies.poses, state.shapes, pairs,
            params.prediction_distance,
            pair_capacity=config.mesh_pair_capacity,
            k_best=config.mesh_k_best,
            p_max=p_max)
    contact_colors = bp_colors[0] if color_with_bp else None
    # the fused layout needs the cached colours; without them the ladder
    # (or the uniform windows) runs unfused, as in the JAX package
    use_fused = (config.gs_fused and bool(config.gs_windows)
                 and contact_colors is not None and dim == 3 and sh is None)
    fused_class_counts = None
    if use_pair_slots:
        # no compaction: the constraint buffer spans pair_capacity and
        # contact-invalid rows are masked in the solve
        contact_count = contacts.valid.sum()
        presorted = True
    elif use_fused:
        # the static rung-padded layout: colour k at a fixed offset, padded
        # to its rung; the TRUE class counts are the rung-regrow signal
        windows = (config.gs_rung0,) + tuple(config.gs_windows[:mc])
        contacts, contact_count, contact_colors, fused_class_counts = \
            compact_contacts(contacts, 0, extra=contact_colors,
                             sort_by_extra=True, static_windows=windows)
        presorted = True
    elif config.contact_capacity and contact_colors is not None:
        # colour-major compaction: the solve needs no sort of its own
        contacts, contact_count, contact_colors = compact_contacts(
            contacts, config.contact_capacity, extra=contact_colors,
            sort_by_extra=True)
        presorted = True
    elif config.contact_capacity:
        contacts, contact_count = compact_contacts(contacts,
                                                   config.contact_capacity)
        presorted = False
    else:
        contact_count = contacts.valid.sum()
        presorted = False
    prev = state.prev_constraints if warmstart else None
    if prev is not None and prev.n_impulse.shape[1] != contacts.dist.shape[1]:
        prev = None
    poses, vels, cons, max_class, colors, solve_cache = solve(
        bodies, mprops, contacts, params, max_colors=mc,
        warmstart_from=prev, gs_cmax=config.gs_cmax,
        colors_in=contact_colors, gs_windows=config.gs_windows,
        prev_colors=state.prev_colors if warmstart else None,
        use_jacobi=config.use_jacobi, max_per_body=config.max_per_body,
        gs_tail_window=config.gs_tail_window, gs_split=config.gs_split,
        layout_valid=pairs.valid if use_pair_slots else None,
        stable_hint=bp_path == 0 if use_pair_slots else None,
        cache_in=state.solve_cache if warmstart else None,
        presorted=presorted, chained=config.gs_chained,
        rhs_in_rung=config.gs_rhs_in_rung, fused=use_fused,
        fused_rung0=config.gs_rung0, fused_class_counts=fused_class_counts,
        joints=state.joints, stable_slots=not has_mesh, shard=sh,
        static_layout=swin if use_static_slots else None)
    new_bodies = Bodies(poses, vels, bodies.local_mprops, bodies.kinematic)
    head = torch.stack([pairs.count.to(torch.int64), contact_count,
                        max_class[0],
                        torch.tensor(bp_path, dtype=torch.int64, device=dev),
                        max_class[1]])
    counts = torch.cat([head, np_needed, max_class[2:]])
    # the broad-phase cache is kept only under a slack
    return PhysicsState(new_bodies, state.shapes, cons, counts, colors,
                        pairs if slack > 0 else None, bp_ref, bp_colors,
                        solve_cache, state.joints)


def _sharded_narrow_phase(poses, shapes, pairs: PairList, params,
                          config: PipelineConfig, p_max: int,
                          sh: collectives.Shard):
    """Rank k's pair slots ``k, k + n, k + 2n, ...`` through the narrow
    phase, at the compaction capacities over the rank count n. The pairs
    lie packed at the front of the list, so a stride gives every rank its
    share of them (blocks of slots would give the first rank nearly all).
    The manifolds come back slot for slot, and the demands are the largest
    rank's times the rank count."""
    cap_l = config.pair_capacity // sh.n
    sl = slice(sh.rank, None, sh.n)
    part = PairList(pairs.body_a[sl].contiguous(),
                    pairs.body_b[sl].contiguous(),
                    pairs.valid[sl].contiguous(), pairs.count)

    def div(cap):
        return -(-cap // sh.n) if cap else 0

    c_l, need_l = narrow_phase(
        poses, shapes, part, params.prediction_distance, p_max=p_max,
        bc_capacity=div(config.bc_pair_capacity),
        sat_capacity=div(config.sat_pair_capacity),
        pfm_capacity=div(config.pfm_pair_capacity))
    names = [f.name for f in dataclasses.fields(Contacts)]
    fields = [getattr(c_l, f) for f in names]
    # the demands ride the integer buffer as a column of the first rows
    need = torch.zeros((cap_l, need_l.shape[0]), dtype=torch.int64,
                       device=need_l.device)
    need[0] = need_l
    got = collectives.gather_fields(fields + [need], sh)
    np_needed = got[-1].reshape(sh.n, cap_l, -1)[:, 0].amax(0) * sh.n

    def slot_order(x):
        # rank-major [n, cap_l] -> slot j·n + k
        return x.reshape((sh.n, cap_l) + x.shape[1:]).transpose(
            0, 1).reshape(x.shape)

    return (Contacts(**{f: slot_order(x) for f, x in zip(names, got[:-1])}),
            np_needed)


def fine_bucket(n: int, *, floor: int = 2048, quantum: int = 1024,
                headroom: float = 1.10) -> int:
    """``headroom``·n rounded up to a ``quantum`` multiple."""
    return max(floor, -(-int(int(n) * headroom) // quantum) * quantum)


def step_checked(state: PhysicsState, params: SimParams,
                 config: PipelineConfig, stats=None):
    """Step, then re-bucket every capacity the device counts overflowed and
    re-run the frame. Returns ``(state, config)``."""
    first_frame = state.prev_constraints is None
    new = step(state, params, config, warmstart=not first_frame)
    counts = host_list(new.pair_count)
    regrow = {}
    if counts[0] < 0:
        grown = {
            "broad_phase_max_per_row": min(
                config.broad_phase_max_per_row * 2, 512),
            "bp_cell_cap": min(config.bp_cell_cap * 2, 32),
            "bp_global_cap": min(config.bp_global_cap * 2, 64),
            "bp_cand_budget": min(config.bp_cand_budget * 3 // 2, 432),
        }
        if all(getattr(config, k) == v for k, v in grown.items()):
            if stats is not None:
                stats.bump("bp_budget_saturated")
            import warnings

            warnings.warn(
                "broad-phase budgets saturated at their caps while still "
                "overflowing; pair list may be truncated this frame")
            if new.bp_ref is not None:
                new = dataclasses.replace(new, bp_ref=(
                    torch.full_like(new.bp_ref[0], math.inf),
                    torch.full_like(new.bp_ref[1], -math.inf)))
        else:
            regrow.update(grown)
        counts[0] = -counts[0]
    bucket = fine_bucket if config.fine_capacities else capacity_bucket
    if counts[0] > config.pair_capacity:
        regrow["pair_capacity"] = bucket(counts[0])
    if (config.contact_capacity and not config.gs_fused
            and not config.gs_pair_slots
            and counts[1] > config.contact_capacity):
        # (the fused layout sizes its buffer from the rungs, the pair-slot
        # layout spans pair_capacity: neither uses this knob)
        regrow["contact_capacity"] = bucket(counts[1])
    if config.gs_cmax and counts[2] > config.gs_cmax:
        regrow["gs_cmax"] = capacity_bucket(counts[2], floor=256)
    if config.gs_tail_window and counts[4] > config.gs_tail_window:
        regrow["gs_tail_window"] = capacity_bucket(counts[4], floor=256)
    for i, knob in ((5, "bc_pair_capacity"), (6, "sat_pair_capacity"),
                    (7, "pfm_pair_capacity")):
        cap = getattr(config, knob)
        if cap and counts[i] > cap:
            regrow[knob] = capacity_bucket(counts[i], floor=256)
    if config.gs_windows and len(counts) >= 8 + config.max_colors + 2:
        cc = counts[8:8 + config.max_colors + 2]
        rungs = list(config.gs_windows[:config.max_colors])
        while len(rungs) < config.max_colors:
            rungs.append(rungs[-1] if rungs else 256)
        changed = False
        q = config.gs_rung_quantum
        hr = config.gs_rung_headroom
        for c in range(config.max_colors):
            occ = cc[c + 1]
            if occ > rungs[c]:
                rungs[c] = max(q, -(-int(occ * hr) // q) * q)
                changed = True
        if not config.gs_fused:
            # prune the rungs past the last occupied class but one (the
            # fused layout keeps every rung)
            last = max((c for c in range(config.max_colors)
                        if cc[c + 1] > 0), default=-1)
            for c in range(last + 2, config.max_colors):
                if rungs[c]:
                    rungs[c] = 0
                    changed = True
        if changed:
            regrow["gs_windows"] = tuple(rungs)
        # the fused layout's residue class has a static rung of its own:
        # it grows the same way (an overflow drops contacts)
        if config.gs_fused and cc[0] > config.gs_rung0:
            regrow["gs_rung0"] = max(
                256, -(-int(cc[0]) * 23 // 20 // 256) * 256)
    if config.gs_static_slots and config.gs_windows:
        # static rung placement needs pair_capacity >= sum(windows) + 256
        # (grow-only, bucketed as the count-driven regrow; after this
        # frame's rung regrow)
        rungs_now = (regrow.get("gs_windows")
                     or config.gs_windows)[:config.max_colors]
        need = sum(rungs_now) + 256
        have = regrow.get("pair_capacity", config.pair_capacity)
        if have < need:
            regrow["pair_capacity"] = max(bucket(need), have)
    if regrow:
        config = dataclasses.replace(config, **regrow)
        if stats is not None:
            stats.bump("capacity_regrowths")
        new = step(state, params, config, warmstart=not first_frame)
    if stats is not None:
        stats.bump("steps")
    return new, config
