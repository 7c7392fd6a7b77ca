"""Export the JAX package's outputs for the port's solve modes (colouring in
the solve, the uniform and split windows, the Jacobi solver) as a JAX-free
``.npz``: ``artifacts/solve_modes_jax.npz``.

Five groups:

- ``graph.<case>.*`` (``tests/test_torch_coloring.py``): seeded constraint
  graphs (300 bodies, five of them static, 1,500 edges, a tenth invalid)
  with JAX's ``color_constraints`` colours (four claim rounds, and one:
  ``colors_r1``), ``minimize_colors`` output (two sweeps over
  ``colors_r1``, whose loose classes leave it work) and
  ``build_body_constraint_csr`` entries, offsets and counts. The cases
  differ in ``max_colors`` and ``class_cap``: no cap, too few colours (the
  legacy residue lands on the last colour), a cap, and a cap with too few
  colours (residue 0).
- ``unit.*`` (``tests/test_torch_solve_modes.py``): from the ``quick``
  pit's warmed state, ``update_constraints`` of its constraints; their
  colours (``max_colors`` 16, ``class_cap`` 48), layout and sorted fields;
  one uniform sweep (``gs_color_major_pass`` without a ladder, window
  ``cmax``) and one split sweep (colours 1-3 at ``cmax``, the rest at a
  tail window of 8, which truncates); and one ``jacobi_pass`` over the
  body CSR.
- ``pit.<mode>.*`` (``tests/test_torch_pipeline_modes.py``): ``ball_pit(160)``
  warmed by 30 JAX frames under each mode's configuration (``warmed.*``,
  ``state_to_arrays`` names, and ``config_json``), then one ``step`` from
  the warmed state (``step.*``). The modes: ``quick`` (``bp_slack`` 0,
  ``gs_cmax`` 0, no windows: colouring in the solve, uniform windows),
  ``uniform_cc`` (``gs_cmax`` 32 with 8 colours: a residue class),
  ``split`` (cached pair colours, warmed with ``gs_tail_window`` 64 and
  stepped with 8, below the tail classes), ``slack_nocolor``
  (``bp_slack`` 0.03, ``gs_cmax`` 0: the broad-phase cache without
  colours, unsorted compaction), ``jacobi`` (``SimParams.jacobi()``,
  ``use_jacobi``) and ``min_colors`` (``bp_min_color_sweeps`` 2 over one
  claim round; its step starts from the warmed state with the
  broad-phase cache dropped, so the frame recolours in full).
  ``config_json`` is the step's configuration. For ``quick`` also JAX's
  grid pair list of the warmed state at ``bp_slack`` 0
  (``quick.bp_pairs.*``). ``regrow.{residue,tail}.*``: one
  ``step_checked`` frame from the ``uniform_cc`` / ``split`` warmed state
  (the regrown configuration and the counts).
- ``pyramid6.*``: ``pyramid(6)`` under the README's quick start,
  ``PipelineConfig(pair_capacity=16384)``, warmed by 20 ``step_checked``
  frames, and one ``step`` from the warmed state.
- ``card.*`` (``chip_smoke.py``): ``pyramid(20)`` (the README's
  ``pyramid3``, 2,871 bodies) warmed by 30 ``step_checked`` frames under
  the quick start (``card.warmed.*``), then three ``step_checked`` frames
  from it under the quick start (``card.quick.ref.<f>.*``) and under the
  testbed's ``--solver jacobi`` (``card.jacobi.ref.<f>.*``); frames 0 and
  1 keep their whole state (``state.*``), so the card can run each frame
  from JAX's state before it. ``card.physics.*``: after 300 quick-start
  frames from the first state, level 0's largest offset from y = 0.5 and
  the largest rise of any box. In the card states the fields of
  ``prev_constraints`` that a step does not read are zeros
  (``export_box_npz.slim``), and so are the impulses whose carry-over the
  step multiplies by a warmstart coefficient of 0 or that its solver
  never reads (``slim_card``): the Jacobi states' four (under
  ``SimParams.jacobi()``), the quick states' Jacobi pair (zeros anyway).

Reals are float32, integers int32. Runs on the CPU, the groups in four
processes at once (5.5 min on an 8-core CPU, most of it the card's 300
frames)::

    JAX_PLATFORMS=cpu python scripts/export_solve_modes_npz.py [--only GROUP]

``--only`` rewrites one group's keys (graph, pit, pyramid6 or card) and
keeps the file's others.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import time
from types import SimpleNamespace

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from export_box_npz import savez_lzma, slim  # noqa: E402
from wgmath_tpu.dynamics import SimParams  # noqa: E402
from wgmath_tpu.dynamics import solver as jsolver  # noqa: E402
from wgmath_tpu.dynamics.constraint import update_constraints  # noqa: E402
from wgmath_tpu.pipeline import (  # noqa: E402
    PipelineConfig,
    step,
    step_checked,
)
from wgmath_tpu.scenes.builders import ball_pit, pyramid  # noqa: E402
from wgmath_tpu_torch.convert import state_to_arrays  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "solve_modes_jax.npz")
GROUPS = ("graph", "pit", "pyramid6", "card")

# graph case -> (max_colors, class_cap)
GRAPH_CASES = {"free": (32, 0), "legacy": (8, 0), "capped": (32, 64),
               "residue": (12, 40)}
GRAPH_BODIES, GRAPH_EDGES, GRAPH_STATIC = 300, 1500, 5

PIT_WARM = 30
PIT_BASE = dict(pair_capacity=2048, bp_algo="grid", manifold_points=1,
                max_colors=16)
PIT_MODES = {
    "quick": PIT_BASE,
    "uniform_cc": dict(PIT_BASE, max_colors=8, gs_cmax=32),
    "split": dict(PIT_BASE, bp_slack=0.03, gs_cmax=512,
                  contact_capacity=1024, gs_tail_window=64, gs_split=3),
    "slack_nocolor": dict(PIT_BASE, bp_slack=0.03, contact_capacity=1024),
    "jacobi": dict(PIT_BASE, use_jacobi=True),
    "min_colors": dict(PIT_BASE, bp_slack=0.03, gs_cmax=512,
                       contact_capacity=1024, bp_min_color_sweeps=2,
                       bp_claim_rounds=1),
}
# the step's change to the warm configuration: the split pile is warmed
# with a tail window that holds its tail classes (a truncating one lets the
# pile fall into itself and overflow the broad phase), then steps with one
# that truncates
PIT_STEP = {"split": dict(gs_tail_window=8)}
# the unit sweeps' colouring and windows
UNIT_COLORS, UNIT_CAP, UNIT_SPLIT, UNIT_TAIL = 16, 48, 3, 8

README_CONFIG = dict(pair_capacity=16384)  # README.md's quick start
PYRAMID6_WARM = 20
CARD_LEVELS, CARD_WARM, CARD_REF, CARD_PHYSICS = 20, 30, 3, 300
LEVEL0_Y = 0.5


def params_for(mode: str) -> SimParams:
    return SimParams.jacobi() if mode == "jacobi" else SimParams()


def _json(cfg) -> np.ndarray:
    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def _put(arrays: dict, prefix: str, state) -> None:
    for k, v in state_to_arrays(state).items():
        arrays[f"{prefix}.{k}"] = v


def graph_group() -> dict:
    arrays = {}
    rng = np.random.default_rng(14)
    n, c = GRAPH_BODIES, GRAPH_EDGES
    for case, (mc, cap) in GRAPH_CASES.items():
        a = rng.integers(0, n, c)
        b = rng.integers(0, n - 1, c)
        b = np.where(b >= a, b + 1, b)
        ba, bb = np.minimum(a, b), np.maximum(a, b)
        valid = rng.random(c) > 0.1
        dyn = np.arange(n) >= GRAPH_STATIC
        im_a = np.repeat(dyn[ba, None], 3, 1).astype(np.float32)
        im_b = np.repeat(dyn[bb, None], 3, 1).astype(np.float32)
        cons = SimpleNamespace(
            body_a=jnp.asarray(ba, jnp.int32), body_b=jnp.asarray(bb,
                                                                 jnp.int32),
            valid=jnp.asarray(valid), im_a=jnp.asarray(im_a),
            im_b=jnp.asarray(im_b))
        colors = jsolver.color_constraints(cons, n, max_colors=mc,
                                           class_cap=cap)
        # one claim round leaves the classes loose: room to minimize
        colors_r1 = jsolver.color_constraints(cons, n, max_colors=mc,
                                              claim_rounds=1, class_cap=cap)
        minimized = jsolver.minimize_colors(
            cons.body_a, cons.body_b, cons.valid, colors_r1,
            jnp.asarray(dyn[ba]), jnp.asarray(dyn[bb]), n, max_colors=mc,
            sweeps=2, class_cap=cap)
        entries, offsets, counts = jsolver.build_body_constraint_csr(cons, n)
        p = f"graph.{case}."
        for k, v in (("body_a", ba), ("body_b", bb), ("valid", valid),
                     ("im_a", im_a), ("im_b", im_b),
                     ("num_bodies", n), ("max_colors", mc),
                     ("class_cap", cap), ("colors", colors),
                     ("colors_r1", colors_r1),
                     ("min_colors", minimized), ("csr.entries", entries),
                     ("csr.offsets", offsets), ("csr.counts", counts)):
            v = np.asarray(v)
            arrays[p + k] = (v if v.dtype == np.bool_ or v.dtype.kind == "f"
                             else v.astype(np.int32))
        col = np.asarray(colors)
        print(f"graph {case}: colours in use {len(set(col[valid]))}, "
              f"residue {int(((col == 0) & valid).sum())}, minimized to "
              f"{len(set(np.asarray(minimized)[valid]))}, "
              f"{int((np.asarray(minimized) != np.asarray(colors_r1)).sum())}"
              " edges moved", flush=True)
    return arrays


def warm(mode: str, arrays: dict):
    """The warmed state and the step's configuration."""
    cfg = PipelineConfig(**PIT_MODES[mode])
    state, params = ball_pit(160), params_for(mode)
    for f in range(PIT_WARM):
        state = step(state, params, cfg, warmstart=f > 0)
    _put(arrays, f"pit.{mode}.warmed", state)
    cfg = dataclasses.replace(cfg, **PIT_STEP.get(mode, {}))
    arrays[f"pit.{mode}.config_json"] = _json(cfg)
    return state, cfg, params


def unit_group(state, arrays: dict) -> None:
    """The sweeps and the Jacobi pass on the quick pit's warmed
    constraints."""
    n = int(state.bodies.poses.translation.shape[0])
    sub = SimParams().substep().with_dim(3)
    cons = update_constraints(state.prev_constraints, state.bodies.poses, sub)
    for f in ("n_rhs", "n_rhs_wo_bias", "t_rhs", "n_impulse", "t_impulse",
              "n_impulse_jacobi", "t_impulse_jacobi", "cfm_factor"):
        arrays[f"unit.update.{f}"] = np.asarray(getattr(cons, f))
    colors = jsolver.color_constraints(cons, n, max_colors=UNIT_COLORS,
                                       class_cap=UNIT_CAP)
    c_cap = int(cons.body_a.shape[0])
    cmax = min(min(c_cap, n + 64), UNIT_CAP)
    layout = jsolver.build_color_layout(colors, cons.valid,
                                        max_colors=UNIT_COLORS, cmax=cmax)
    ss, packed = jsolver.sort_solver_fields_packed(cons, layout[0])
    idx = jnp.minimum(layout[0], c_cap - 1)
    n_imp_s, t_imp_s = cons.n_impulse[idx], cons.t_impulse[idx]
    counts = np.asarray(layout[2])
    num_colors = int(max(c for c in range(1, UNIT_COLORS + 1)
                         if counts[c] > 0))
    vels = state.bodies.vels
    arrays["unit.colors"] = np.asarray(colors, np.int32)
    arrays["unit.cmax"] = np.asarray(cmax, np.int32)
    for k, v in zip(("order_padded", "offsets", "counts"), layout):
        arrays[f"unit.layout.{k}"] = np.asarray(v, np.int32)
    kw = dict(dim=3, packed_fields=packed)
    out = jsolver.gs_color_major_pass(ss, vels, n_imp_s, t_imp_s, layout,
                                      num_colors, cmax=cmax, **kw)
    head = jsolver.gs_color_major_pass(ss, vels, n_imp_s, t_imp_s, layout,
                                       min(num_colors, UNIT_SPLIT),
                                       cmax=cmax, **kw)
    split = jsolver.gs_color_major_pass(ss, head[0], head[1], head[2],
                                        layout, num_colors, cmax=UNIT_TAIL,
                                        color_lo=UNIT_SPLIT + 1, **kw)
    for name, (v, ni, ti) in (("uniform", out), ("split", split)):
        arrays[f"unit.{name}.linear"] = np.asarray(v.linear)
        arrays[f"unit.{name}.angular"] = np.asarray(v.angular)
        arrays[f"unit.{name}.n_imp_s"] = np.asarray(ni)
        arrays[f"unit.{name}.t_imp_s"] = np.asarray(ti)
    csr = jsolver.build_body_constraint_csr(cons, n)
    v, jc = jsolver.jacobi_pass(cons, vels, csr, max_per_body=32)
    arrays["unit.jacobi.linear"] = np.asarray(v.linear)
    arrays["unit.jacobi.angular"] = np.asarray(v.angular)
    for f in ("n_impulse", "n_impulse_jacobi", "t_impulse",
              "t_impulse_jacobi"):
        arrays[f"unit.jacobi.{f}"] = np.asarray(getattr(jc, f))
    print(f"unit: {num_colors} colours, class counts "
          f"{counts[:num_colors + 1].tolist()}, cmax {cmax}", flush=True)


def pit_group() -> dict:
    from wgmath_tpu.broad_phase.grid import find_pairs_grid
    from wgmath_tpu.shapes.shape import ball_radii_or_nan, world_aabbs

    t0 = time.time()
    arrays = {}
    for mode in PIT_MODES:
        state, cfg, params = warm(mode, arrays)
        start = state
        if mode == "min_colors":
            start = dataclasses.replace(state, bp_pairs=None, bp_ref=None,
                                        bp_colors=None)
        _put(arrays, f"pit.{mode}.step", step(start, params, cfg,
                                              warmstart=True))
        if mode == "quick":
            unit_group(state, arrays)
            b = state.bodies
            mins, maxs = world_aabbs(state.shapes, b.poses,
                                     margin=params.prediction_distance)
            p = find_pairs_grid(
                mins, maxs, capacity=cfg.pair_capacity,
                max_per_body=cfg.broad_phase_max_per_row,
                cell_cap=cfg.bp_cell_cap, global_cap=cfg.bp_global_cap,
                cand_budget=cfg.bp_cand_budget,
                ball_radius=ball_radii_or_nan(state.shapes, b.poses),
                margin=params.prediction_distance, dynamic=b.is_dynamic())
            for f in ("body_a", "body_b", "valid", "count"):
                arrays[f"pit.quick.bp_pairs.{f}"] = np.asarray(getattr(p, f))
        if mode in ("uniform_cc", "split"):
            which = "residue" if mode == "uniform_cc" else "tail"
            st1, c1 = step_checked(state, params, cfg)
            arrays[f"regrow.{which}.pair_count"] = np.asarray(st1.pair_count)
            arrays[f"regrow.{which}.config_json"] = _json(c1)
        print(f"pit {mode}: pair_count "
              f"{np.asarray(state.pair_count)[:8].tolist()} "
              f"({time.time() - t0:.0f} s)", flush=True)
    return arrays


def pyramid6_group() -> dict:
    t0 = time.time()
    arrays = {}
    cfg, params = PipelineConfig(**README_CONFIG), SimParams()
    state = pyramid(6)
    for _ in range(PYRAMID6_WARM):
        state, cfg = step_checked(state, params, cfg)
    _put(arrays, "pyramid6.warmed", state)
    arrays["pyramid6.config_json"] = _json(cfg)
    _put(arrays, "pyramid6.step", step(state, params, cfg, warmstart=True))
    print(f"pyramid6: pair_count {np.asarray(state.pair_count).tolist()} "
          f"({time.time() - t0:.0f} s)", flush=True)
    return arrays


def card_group() -> dict:
    """The warmed ``pyramid(20)`` and three frames of each mode."""
    t0 = time.time()
    arrays = {}
    cfg, params = PipelineConfig(**README_CONFIG), SimParams()
    state = pyramid(CARD_LEVELS)
    for _ in range(CARD_WARM):
        state, cfg = step_checked(state, params, cfg)
    _put(arrays, "card.warmed.state", state)
    arrays["card.warmed.config_json"] = _json(cfg)
    print(f"card warmed: pair_count {np.asarray(state.pair_count).tolist()}"
          f" ({time.time() - t0:.0f} s)", flush=True)
    for mode, mparams, mcfg in (
            ("quick", params, cfg),
            ("jacobi", SimParams.jacobi(),
             dataclasses.replace(cfg, use_jacobi=True))):
        st, c = state, mcfg
        arrays[f"card.{mode}.config_json"] = _json(mcfg)
        for f in range(CARD_REF):
            st, c = step_checked(st, mparams, c)
            p = f"card.{mode}.ref.{f}"
            if f < CARD_REF - 1:
                _put(arrays, f"{p}.state", st)
            arrays[f"{p}.translation"] = np.asarray(st.bodies.poses
                                                    .translation)
            arrays[f"{p}.linear"] = np.asarray(st.bodies.vels.linear)
            arrays[f"{p}.pair_count"] = np.asarray(st.pair_count, np.int32)
            arrays[f"{p}.config_json"] = _json(c)
            print(f"card {mode} frame {f}: pair_count "
                  f"{np.asarray(st.pair_count).tolist()} "
                  f"({time.time() - t0:.0f} s)", flush=True)
    return slim_card(slim(arrays))


def slim_card(arrays: dict) -> dict:
    """The card states with the impulses a step cannot use zeroed: under
    ``SimParams.jacobi()`` the carry-over is scaled by a warmstart
    coefficient of 0, and the Gauss-Seidel quick start never reads the
    Jacobi pair."""
    jac = ("n_impulse_jacobi", "t_impulse_jacobi")
    out = {}
    for k, v in arrays.items():
        field = k.rsplit(".", 1)[-1]
        if k.startswith("card.") and ".prev_constraints." in k and (
                field in jac or (k.startswith("card.jacobi.")
                                 and field in ("n_impulse", "t_impulse"))):
            v = np.zeros_like(v)
        out[k] = v
    return out


def physics_group() -> dict:
    """300 quick-start frames of ``pyramid(20)`` from its first state."""
    t0 = time.time()
    cfg, params = PipelineConfig(**README_CONFIG), SimParams()
    state = pyramid(CARD_LEVELS)
    y0 = np.asarray(state.bodies.poses.translation)[:, 1]
    for f in range(CARD_PHYSICS):
        state, cfg = step_checked(state, params, cfg)
        if f % 50 == 49:
            print(f"card physics frame {f + 1} ({time.time() - t0:.0f} s)",
                  flush=True)
    tr = np.asarray(state.bodies.poses.translation)
    level0 = tr[1:1 + CARD_LEVELS ** 2, 1]
    out = {"card.physics.frames": np.asarray(CARD_PHYSICS, np.int32),
           "card.physics.level0_max_off": np.asarray(
               float(np.abs(level0 - LEVEL0_Y).max()), np.float32),
           "card.physics.max_rise": np.asarray(float((tr[:, 1] - y0).max()),
                                               np.float32),
           "card.physics.finite": np.asarray(bool(np.isfinite(tr).all())),
           "card.physics.config_json": _json(cfg)}
    print(f"card physics: level 0 off "
          f"{float(out['card.physics.level0_max_off'])}, max rise "
          f"{float(out['card.physics.max_rise'])} "
          f"({time.time() - t0:.0f} s)", flush=True)
    return out


JOBS = {"graph": (graph_group,), "pit": (pit_group,),
        "pyramid6": (pyramid6_group,), "card": (card_group, physics_group)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=GROUPS, default=None,
                    help="rewrite this group only (default: every group)")
    only = ap.parse_args().only
    t0 = time.time()
    groups = [g for g in GROUPS if only in (None, g)]
    arrays = {}
    if only is not None and os.path.exists(OUT):
        # the pit group also writes the unit and regrow keys
        mine = (only, "unit", "regrow") if only == "pit" else (only,)
        with np.load(OUT) as z:
            arrays = {k: z[k] for k in z.files
                      if k.split(".", 1)[0] not in mine}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        jobs = [pool.apply_async(fn) for g in groups for fn in JOBS[g]]
        for job in jobs:
            arrays.update(job.get())
    savez_lzma(OUT, arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
