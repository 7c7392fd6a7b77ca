"""The port's fused solver step (``gs_fused``) against the JAX package: a
160-ball pit warmed by the JAX package under a scaled-down ``fused``
configuration (grid broad phase with its slack cache, cached pair colours,
the static rung-padded layout with a non-empty residue class), carried
across with ``state_from_arrays``, then stepped once by both packages —
integers exact, floats at the stated tolerances. Then, within the port:
the fused step against the ladder step, the rung regrow of
``step_checked`` (the same configuration sequence as the JAX package's),
the precedence of ``gs_fused`` over the pair-slot layout, and
``gs_fused_pallas``, which changes nothing. The JAX package's warmup, step
and regrow frames are stored by ``scripts/export_pit160_npz.py`` in
``artifacts/pit160_jax.npz`` (group ``fused``), so this file makes no JAX
step of its own."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "pit160_jax.npz")
MAX_COLORS = 12


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return {k[len("fused."):]: v for k, v in f.items()
                if k.startswith("fused.")}


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _config(blob):
    return PipelineConfig.from_dict(json.loads(str(blob)))


@pytest.fixture(scope="module")
def warmed(z):
    """(state arrays, configuration) after the JAX package's warmup under
    the fused configuration: balls landed, contacts formed, BP cache,
    colours and the 8-part fused bundle populated. ``gs_cmax`` 48 caps the
    colour classes, so a residue class (colour 0) is warmstarted outside
    the kernels."""
    arrays = _sub(z, "warmed.")
    counts = arrays["pair_count"]
    cc = counts[8:8 + MAX_COLORS + 2]
    assert counts[1] > 100 and 0 < counts[0] <= 2048
    assert 0 < cc[0] <= 256  # a residue class within its rung
    assert cc[1:].max() <= 32  # every colour fits its rung
    assert sum(k.startswith("solve_cache.") for k in arrays) == 8
    return arrays, _config(z["config_json"])


def _port(arrays, cfg):
    return state_from_arrays(arrays, device="cpu"), cfg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def one_step(z, warmed):
    """One step of each package from the warmed state (the JAX package's
    as stored, with ``warmstart=True`` as the warmup's later frames)."""
    tstate, tcfg = _port(*warmed)
    return (state_from_arrays(_sub(z, "step."), device="cpu"),
            step(tstate, SimParams(), tcfg))


def test_one_fused_step_matches_jax(one_step):
    js, ts = one_step
    # integers exact: counts (the true class counts included), the cached
    # pair list and colours, the 8-part bundle (static offsets, sides,
    # idx / inv), the constraint slots of the rung-padded layout
    np.testing.assert_array_equal(_np(ts.pair_count), _np(js.pair_count))
    for f in ("body_a", "body_b", "valid", "count"):
        np.testing.assert_array_equal(_np(getattr(ts.bp_pairs, f)),
                                      _np(getattr(js.bp_pairs, f)), f)
    np.testing.assert_array_equal(_np(ts.bp_colors[0]),
                                  _np(js.bp_colors[0]))
    np.testing.assert_array_equal(_np(ts.prev_colors), _np(js.prev_colors))
    assert len(ts.solve_cache) == len(js.solve_cache) == 8
    for i, (g, w) in enumerate(zip(ts.solve_cache, js.solve_cache)):
        np.testing.assert_array_equal(_np(g), _np(w), f"solve_cache[{i}]")
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(_np(getattr(ts.prev_constraints, f)),
                                      _np(getattr(js.prev_constraints, f)))
    # floats: poses at 1e-6; velocities at atol 5e-5 for the reason the
    # ladder tests state (XLA on the CPU contracts a*b+c into one rounding,
    # and the rhs rebuild scales one ulp of a world point by 1/dt)
    tb, jb = ts.bodies, js.bodies
    for got, want in ((tb.poses.translation, jb.poses.translation),
                      (tb.poses.rotation, jb.poses.rotation)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)
    for got, want in ((tb.vels.linear, jb.vels.linear),
                      (tb.vels.angular, jb.vels.angular)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=5e-5)
    for f in ("n_impulse", "t_impulse"):
        np.testing.assert_allclose(_np(getattr(ts.prev_constraints, f)),
                                   _np(getattr(js.prev_constraints, f)),
                                   rtol=1e-3, atol=1e-4)


def test_fused_step_matches_port_ladder(warmed, one_step):
    """Within the port, from one warmed state: the fused solver advances
    the pile as the ladder does (the JAX package's own wiring test)."""
    tstate, tcfg = _port(*warmed)
    lad = step(tstate, SimParams(), dataclasses.replace(tcfg,
                                                        gs_fused=False))
    fus = one_step[1]
    np.testing.assert_array_equal(_np(fus.pair_count)[:2],
                                  _np(lad.pair_count)[:2])
    np.testing.assert_allclose(_np(fus.bodies.vels.linear),
                               _np(lad.bodies.vels.linear), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(fus.bodies.poses.translation),
                               _np(lad.bodies.poses.translation), rtol=1e-5,
                               atol=1e-6)


def test_step_checked_regrows_rungs_as_jax(z, warmed):
    """Undersized windows: the first fused frame drops each colour's
    overflow, exports the TRUE class counts, and ``step_checked`` regrows
    the rungs and re-runs the frame; the configuration sequence and the
    counts equal the JAX package's (stored: two frames from the warmed
    state with every rung cut to 8)."""
    arrays, cfg = warmed
    small = dataclasses.replace(cfg, gs_windows=(8,) * MAX_COLORS,
                                gs_rung0=8)
    ts, tc = _port(arrays, small)
    for f in range(2):
        ts, tc = step_checked(ts, SimParams(), tc)
        assert dataclasses.asdict(tc) == dataclasses.asdict(
            _config(z[f"regrow.{f}.config_json"]))
        np.testing.assert_array_equal(_np(ts.pair_count),
                                      z[f"regrow.{f}.pair_count"])
    assert tc.gs_windows != small.gs_windows and tc.gs_rung0 > 8
    assert np.isfinite(_np(ts.bodies.poses.translation)).all()


def test_fused_takes_precedence_over_pair_slots(warmed, one_step):
    """``gs_fused`` with ``gs_pair_slots`` (and ``gs_chained``) runs the
    fused solver, as in the JAX package: the same bits as ``gs_fused``
    alone."""
    tstate, tcfg = _port(*warmed)
    both = step(tstate, SimParams(), dataclasses.replace(
        tcfg, gs_pair_slots=True, gs_chained=True, gs_rhs_in_rung=True))
    fus = one_step[1]
    np.testing.assert_array_equal(_np(both.pair_count), _np(fus.pair_count))
    assert len(both.solve_cache) == 8
    for got, want in ((both.bodies.poses.translation,
                       fus.bodies.poses.translation),
                      (both.bodies.vels.linear, fus.bodies.vels.linear),
                      (both.bodies.vels.angular, fus.bodies.vels.angular)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("pallas", [True, False])
def test_gs_fused_pallas_changes_nothing_on_the_cpu(warmed, one_step,
                                                    pallas):
    tstate, tcfg = _port(*warmed)
    got = step(tstate, SimParams(),
               dataclasses.replace(tcfg, gs_fused_pallas=pallas))
    fus = one_step[1]
    for a, b in ((got.bodies.poses.translation, fus.bodies.poses.translation),
                 (got.bodies.vels.linear, fus.bodies.vels.linear),
                 (got.prev_constraints.n_impulse,
                  fus.prev_constraints.n_impulse)):
        assert torch.equal(a, b)
