"""The port's step in the solve modes without a window ladder, against the
JAX package's: colouring in the solve, uniform and split windows, the
broad-phase cache without colours, the Jacobi solver and colour
minimization. A 160-ball pit is warmed by the JAX package under each
mode's configuration and stepped once by both packages from the warmed
state; ``pyramid(6)`` likewise under the README's quick start,
``PipelineConfig(pair_capacity=16384)``. The JAX package's warmups, steps
and regrown configurations are stored by
``scripts/export_solve_modes_npz.py`` in ``artifacts/solve_modes_jax.npz``
(groups ``pit``, ``regrow``, ``pyramid6``); this file imports no JAX.

Integers are exact: counts, pair lists, colours, the solve bundle,
constraint slots and regrown configurations. Translations are held at
atol 1e-5 m and velocities at atol 5e-5 after one step: XLA on the CPU
fuses ``a*b+c`` into one rounding where PyTorch rounds the product (the
JAX package's CPU sweep is its XLA point update, not the Pallas kernel),
and the substep rhs carries one ulp of a world point into ~1e-5 m/s."""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import (
    PipelineConfig,
    _check_slice,
    step,
    step_checked,
)
from wgmath_tpu_torch.scenes.builders import pyramid
from wgmath_tpu_torch.shapes.shape import BALL, CUBOID, POLYLINE, TRIMESH
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "solve_modes_jax.npz")
MODES = ("quick", "uniform_cc", "split", "slack_nocolor", "jacobi",
         "min_colors")
TR_ATOL, V_ATOL = 1e-5, 5e-5


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return {k: f[k] for k in f.files
                if k.startswith(("pit.", "regrow.", "pyramid6."))}


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _params(mode):
    return SimParams.jacobi() if mode == "jacobi" else SimParams()


def _start(z, group):
    """(the JAX package's warmed state on the CPU, the step's config)."""
    return (state_from_arrays(_sub(z, f"{group}.warmed."), device="cpu"),
            PipelineConfig.from_dict(json.loads(str(
                z[f"{group}.config_json"]))))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _no_bp_cache(state):
    return dataclasses.replace(state, bp_pairs=None, bp_ref=None,
                               bp_colors=None)


def _assert_state_matches(got, want):
    np.testing.assert_array_equal(_np(got.pair_count), _np(want.pair_count))
    for name in ("bp_pairs", "bp_ref", "bp_colors", "solve_cache",
                 "prev_colors"):
        assert (getattr(got, name) is None) == (getattr(want, name) is None)
    if want.bp_pairs is not None:
        for f in ("body_a", "body_b", "valid", "count"):
            np.testing.assert_array_equal(_np(getattr(got.bp_pairs, f)),
                                          _np(getattr(want.bp_pairs, f)), f)
        for g, w in zip(got.bp_ref, want.bp_ref):
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=1e-6)
    if want.bp_colors is not None:
        np.testing.assert_array_equal(_np(got.bp_colors[0]),
                                      _np(want.bp_colors[0]))
        assert got.bp_colors[1:] == tuple(int(x) for x in want.bp_colors[1:])
    if want.prev_colors is not None:
        np.testing.assert_array_equal(_np(got.prev_colors),
                                      _np(want.prev_colors))
    if want.solve_cache is not None:
        assert len(got.solve_cache) == len(want.solve_cache)
        for i, (g, w) in enumerate(zip(got.solve_cache, want.solve_cache)):
            np.testing.assert_array_equal(_np(g), _np(w), f"bundle[{i}]")
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(_np(getattr(got.prev_constraints, f)),
                                      _np(getattr(want.prev_constraints, f)),
                                      f)
    gb, wb = got.bodies, want.bodies
    for g, w, atol in ((gb.poses.translation, wb.poses.translation, TR_ATOL),
                       (gb.poses.rotation, wb.poses.rotation, TR_ATOL),
                       (gb.vels.linear, wb.vels.linear, V_ATOL),
                       (gb.vels.angular, wb.vels.angular, V_ATOL)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-4, atol=atol)
    for f in ("n_impulse", "n_impulse_jacobi", "t_impulse",
              "t_impulse_jacobi"):
        np.testing.assert_allclose(_np(getattr(got.prev_constraints, f)),
                                   _np(getattr(want.prev_constraints, f)),
                                   rtol=1e-3, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("mode", MODES)
def test_one_step_matches_jax(z, mode):
    state, cfg = _start(z, f"pit.{mode}")
    if mode == "min_colors":
        # a frame with no broad-phase cache recolours in full (and then
        # minimizes the colours)
        state = _no_bp_cache(state)
    want = state_from_arrays(_sub(z, f"pit.{mode}.step."), device="cpu")
    got = step(state, _params(mode), cfg)
    _assert_state_matches(got, want)
    counts = _np(got.pair_count)
    assert len(counts) == 8  # no class counts without a ladder
    if mode == "jacobi":
        assert counts[2] == counts[4] == 0 and got.solve_cache is None
        assert not _np(got.prev_colors).any()
    if mode == "uniform_cc":
        assert counts[2] > cfg.gs_cmax  # the residue signal
    if mode == "split":
        assert counts[4] > cfg.gs_tail_window  # a truncated tail class


def test_bp_slack_0_pairs_are_the_bare_boxes_pairs(z):
    """At ``bp_slack`` 0 the broad phase runs on the bare boxes and sphere
    radii, as JAX's does: the moving balls of the warmed pit give JAX's
    pair list of those boxes exactly (with no compaction the constraint
    slots are the pair slots), and no cache is kept."""
    state, cfg = _start(z, "pit.quick")
    speed = torch.linalg.norm(state.bodies.vels.linear, dim=-1)
    # fast enough that a velocity slack would widen their boxes
    assert int((speed > 0.25 * cfg.bp_vel_slack_cap
                / cfg.bp_vel_slack).sum()) > 20
    got = step(state, SimParams(), cfg)
    pairs = _sub(z, "pit.quick.bp_pairs.")
    assert int(got.pair_count[0]) == int(pairs["count"])
    np.testing.assert_array_equal(_np(got.prev_constraints.body_a),
                                  pairs["body_a"])
    np.testing.assert_array_equal(_np(got.prev_constraints.body_b),
                                  pairs["body_b"])
    assert got.bp_pairs is None and got.bp_ref is None
    assert got.bp_colors is None


def test_bp_cache_without_colours(z):
    """``bp_slack`` > 0 with ``gs_cmax`` 0: the cache holds the pairs and
    their reference boxes and no colours; a frame inside the boxes reuses
    it (``bp_path`` 0, JAX's) and the solve colours the contacts."""
    state, cfg = _start(z, "pit.slack_nocolor")
    assert state.bp_pairs is not None and state.bp_colors is None
    got = step(state, SimParams(), cfg)
    assert int(got.pair_count[3]) == 0
    assert got.bp_colors is None and got.prev_colors is not None
    assert torch.equal(got.bp_pairs.body_a, state.bp_pairs.body_a)
    # a refresh keeps no colours either
    refresh = step(state, SimParams(), dataclasses.replace(cfg,
                                                           bp_force="miss"))
    assert int(refresh.pair_count[3]) == 2 and refresh.bp_colors is None


@pytest.mark.parametrize("which", ["residue", "tail"])
def test_step_checked_regrows_like_jax(z, which):
    """The uniform windows' residue regrows ``gs_cmax``; a tail class past
    the split windows' ``gs_tail_window`` regrows it."""
    state, cfg = _start(z, "pit.uniform_cc" if which == "residue"
                        else "pit.split")
    got, got_cfg = step_checked(state, SimParams(), cfg)
    want_cfg = json.loads(str(z[f"regrow.{which}.config_json"]))
    assert dataclasses.asdict(got_cfg) == {
        **want_cfg, "gs_windows": tuple(want_cfg["gs_windows"])}
    knob = "gs_cmax" if which == "residue" else "gs_tail_window"
    assert getattr(got_cfg, knob) > getattr(cfg, knob)
    np.testing.assert_array_equal(_np(got.pair_count),
                                  z[f"regrow.{which}.pair_count"])


def test_flags_that_need_a_ladder_fall_back(z):
    """``gs_fused``, ``gs_chained``, ``gs_rhs_in_rung`` and
    ``gs_pair_slots`` without ``gs_windows`` run the plain uniform sweep;
    with a ladder but no cached colours, the unfused ladder."""
    state, cfg = _start(z, "pit.quick")
    want = step(state, SimParams(), cfg)
    for change in (dict(gs_fused=True), dict(gs_chained=True,
                                             gs_rhs_in_rung=True,
                                             gs_pair_slots=True)):
        got = step(state, SimParams(), dataclasses.replace(cfg, **change))
        assert torch.equal(got.bodies.vels.linear, want.bodies.vels.linear)
        assert torch.equal(got.pair_count, want.pair_count)
    ladder = dataclasses.replace(cfg, gs_windows=(256,) * cfg.max_colors)
    want = step(state, SimParams(), ladder)
    got = step(state, SimParams(), dataclasses.replace(ladder,
                                                       gs_fused=True))
    assert torch.equal(got.bodies.vels.linear, want.bodies.vels.linear)
    assert len(got.solve_cache) == 6  # the ladder's bundle, not fused's


def _fake_state(dim=3, kinds=(BALL,), joints_dim=None):
    return SimpleNamespace(bodies=SimpleNamespace(dim=dim),
                           shapes=SimpleNamespace(kinds=frozenset(kinds)),
                           joints=None if joints_dim is None
                           else SimpleNamespace(dim=joints_dim))


@pytest.mark.parametrize("change", [
    dict(use_jacobi=True), dict(gs_windows=()), dict(gs_cmax=0),
    dict(bp_slack=0.0), dict(bp_min_color_sweeps=2),
    dict(gs_tail_window=64), dict(gs_fused=True), dict(gs_chained=True)])
def test_check_slice_accepts_the_solve_modes(change):
    _check_slice(_fake_state(kinds=(BALL, CUBOID)),
                 dataclasses.replace(PipelineConfig(), **change), None)


# once refused, now taken: sharding (tests/test_torch_parallel.py), the
# LBVH broad phase, the fused solver with joints, the 3D mesh kinds (a
# ball on a trimesh), 2D, 2D joints and the polylines
# (tests/test_torch_pipeline_planar.py steps them)
NOW_TAKEN = ("shard", "bp_algo=lbvh", "gs_fused with joints", "shape kinds",
             "2D", "2D joints", "polylines wait for 2D")


@pytest.mark.parametrize("state, change, shard, what", [
    (_fake_state(), {}, ("x", 4), "shard"),
    (_fake_state(dim=2), {}, None, "2D"),
    (_fake_state(kinds=(BALL, TRIMESH)), {}, None, "shape kinds"),
    (_fake_state(), dict(gs_static_slots=True), None, "gs_static_slots"),
    (_fake_state(), dict(bp_algo="lbvh"), None, "bp_algo=lbvh"),
    (_fake_state(joints_dim=3), dict(gs_fused=True), None,
     "gs_fused with joints"),
    (_fake_state(joints_dim=2), {}, None, "2D joints"),
    (_fake_state(kinds=(BALL, POLYLINE)), {}, None, "polylines wait for 2D"),
])
def test_check_slice_still_refuses(state, change, shard, what):
    cfg = dataclasses.replace(PipelineConfig(), **change)
    if what in NOW_TAKEN:
        _check_slice(state, cfg, shard)
        return
    with pytest.raises(NotImplementedError, match=what):
        _check_slice(state, cfg, shard)


def test_readme_quick_start_on_pyramid6(z):
    """The README's quick start with the port's names, on ``pyramid(6)``
    and the CPU: one step from the JAX package's warmed state against
    JAX's (4-point manifolds, ``pair_capacity`` 16,384, no compaction,
    colouring in the solve, uniform windows), then three checked frames
    from the first state."""
    state, cfg = _start(z, "pyramid6")
    assert cfg == dataclasses.replace(
        PipelineConfig(pair_capacity=16384),
        **{k: getattr(cfg, k) for k in ("broad_phase_max_per_row",
                                        "bp_cell_cap", "bp_global_cap",
                                        "bp_cand_budget")})
    want = state_from_arrays(_sub(z, "pyramid6.step."), device="cpu")
    _assert_state_matches(step(state, SimParams(), cfg), want)

    state = pyramid(6, device="cpu")
    params = SimParams()
    config = PipelineConfig(pair_capacity=16384)
    y0 = state.bodies.poses.translation[:, 1].clone()
    for _ in range(3):
        state, config = step_checked(state, params, config)
    tr = state.bodies.poses.translation
    assert torch.isfinite(tr).all()
    assert float((tr[:, 1] - y0).max()) <= 1e-2  # no box rises
    assert int(state.pair_count[1]) > 0
