"""The port's whole slice against the JAX package: a 160-ball pit warmed by
the JAX package under a scaled-down ``chained_ps`` configuration (grid
broad phase with its slack cache, pair slots, the window ladder, chained
rhs-in-rung sweeps), carried across with ``state_from_arrays``, then
stepped by both — one frame (integers exact) and ten more frames including
a forced full refresh and a forced repair."""

import dataclasses

import numpy as np
import pytest
import torch

from wgmath_tpu.dynamics import SimParams as JaxSimParams
from wgmath_tpu.pipeline import PipelineConfig as JaxConfig
from wgmath_tpu.pipeline import step as jax_step
from wgmath_tpu.pipeline import step_checked as jax_step_checked
from wgmath_tpu.scenes.builders import ball_pit as jax_ball_pit
from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked

WARM_FRAMES = 30


@pytest.fixture(scope="module")
def warmed():
    """(JAX state, JAX config) after the warmup: balls landed, contacts
    formed, BP cache, colours and solve bundle populated. The warmup steps
    one fixed configuration whose budgets and rungs hold everything this
    scene needs (so ``step_checked`` would change nothing but prune empty
    rungs): two compiles instead of one per regrow."""
    cfg = JaxConfig(pair_capacity=2048, contact_capacity=1024,
                    max_colors=16, gs_cmax=512, bp_slack=0.03,
                    bp_algo="grid", manifold_points=1,
                    gs_windows=(256,) * 16, gs_chained=True,
                    gs_rhs_in_rung=True, gs_pair_slots=True)
    state, params = jax_ball_pit(160), JaxSimParams()
    for f in range(WARM_FRAMES):
        state = jax_step(state, params, cfg, warmstart=f > 0)
    counts = np.asarray(state.pair_count)
    assert counts[1] > 100 and counts[0] > 0
    assert counts[9:9 + 16].max() <= 256  # every class fits its rung
    return state, cfg


def _port(state, cfg):
    return (state_from_arrays(state_to_arrays(state), device="cpu"),
            PipelineConfig.from_dict(dataclasses.asdict(cfg)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_state_round_trip(warmed):
    arrays = state_to_arrays(warmed[0])
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


@pytest.fixture(scope="module")
def first_frame(warmed):
    """One checked frame of each package from the warmed state: (JAX state,
    JAX config, port state, port config). The one-step test checks it and
    the ten-frame run starts from it."""
    jstate, jcfg = warmed
    tstate, tcfg = _port(jstate, jcfg)
    return (*jax_step_checked(jstate, JaxSimParams(), jcfg),
            *step_checked(tstate, SimParams(), tcfg))


def test_one_step_matches_jax(first_frame):
    js, jc, ts, tc = first_frame
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    # integers exact: counts, cached pair list and colours, solve bundle,
    # constraint slots
    np.testing.assert_array_equal(_np(ts.pair_count), _np(js.pair_count))
    for f in ("body_a", "body_b", "valid", "count"):
        np.testing.assert_array_equal(_np(getattr(ts.bp_pairs, f)),
                                      _np(getattr(js.bp_pairs, f)), f)
    np.testing.assert_array_equal(_np(ts.bp_colors[0]),
                                  _np(js.bp_colors[0]))
    assert ts.bp_colors[1:] == tuple(int(x) for x in js.bp_colors[1:])
    assert len(ts.solve_cache) == len(js.solve_cache) == 8
    for i, (g, w) in enumerate(zip(ts.solve_cache, js.solve_cache)):
        np.testing.assert_array_equal(_np(g), _np(w), f"solve_cache[{i}]")
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(_np(getattr(ts.prev_constraints, f)),
                                      _np(getattr(js.prev_constraints, f)))
    # floats: poses at the chained sweep's tolerance in the JAX package's
    # own tests. Velocities get atol 5e-5, not 1e-5: XLA on the CPU fuses
    # a*b+c into one rounding where PyTorch (and the card kernel, built
    # without contraction) rounds the product, and the substep rhs rebuild
    # turns one ulp of a ~5 m world point into ~1e-4 m/s of bias velocity;
    # a pure reordering of the GS sums moves velocities by ~3e-5 after one
    # step (BENCH_NOTES.md)
    tb, jb = ts.bodies, js.bodies
    for got, want in ((tb.poses.translation, jb.poses.translation),
                      (tb.poses.rotation, jb.poses.rotation)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)
    for got, want in ((tb.vels.linear, jb.vels.linear),
                      (tb.vels.angular, jb.vels.angular)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=5e-5)


def test_ten_frames_track_jax(first_frame):
    """Caches, repairs, refreshes and regrows over ten frames; frame 3
    forces a full broad-phase refresh (slots permute: by-key warmstart and
    a fresh bundle), frame 6 forces a repair. Frame 0 is the module's first
    frame."""
    jp, tp = JaxSimParams(), SimParams()
    paths = []
    for f in range(10):
        force = {3: "miss", 6: "repair"}.get(f)
        if f == 0:
            jstate, jcfg, tstate, tcfg = first_frame
        else:
            jstate, jcfg = jax_step_checked(
                jstate, jp, dataclasses.replace(jcfg, bp_force=force))
            tstate, tcfg = step_checked(
                tstate, tp, dataclasses.replace(tcfg, bp_force=force))
        jcfg = dataclasses.replace(jcfg, bp_force=None)
        tcfg = dataclasses.replace(tcfg, bp_force=None)
        jpc, tpc = _np(jstate.pair_count), _np(tstate.pair_count)
        np.testing.assert_array_equal(tpc, jpc, f"frame {f}")
        paths.append(int(tpc[3]))
        for got, want in (
                (tstate.bodies.poses.translation,
                 jstate.bodies.poses.translation),
                (tstate.bodies.vels.linear, jstate.bodies.vels.linear),
                (tstate.bodies.vels.angular, jstate.bodies.vels.angular)):
            assert np.isfinite(_np(got)).all()
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-3,
                                       atol=1e-3, err_msg=f"frame {f}")
    assert paths[3] == 2 and paths[6] == 1, paths


@pytest.mark.parametrize("change", [
    dict(use_jacobi=True), dict(gs_static_slots=True),
    dict(gs_windows=()), dict(gs_windows=(), gs_tail_window=1536),
    dict(gs_cmax=0), dict(bp_slack=0.0),
    dict(bp_algo="lbvh"), dict(bp_min_color_sweeps=2)])
def test_step_refuses_flags_outside_the_slice(warmed, change):
    tstate, tcfg = _port(*warmed)
    with pytest.raises(NotImplementedError, match="refused"):
        step(tstate, SimParams(), dataclasses.replace(tcfg, **change))


def test_step_refuses_sharding(warmed):
    tstate, tcfg = _port(*warmed)
    with pytest.raises(NotImplementedError, match="shard"):
        step(tstate, SimParams(), tcfg, shard=("x", 4))
