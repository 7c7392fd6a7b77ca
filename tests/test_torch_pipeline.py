"""The port's whole slice against the JAX package: a 160-ball pit warmed by
the JAX package under a scaled-down ``chained_ps`` configuration (grid
broad phase with its slack cache, pair slots, the window ladder, chained
rhs-in-rung sweeps), carried across with ``state_from_arrays``, then
stepped by both — one frame (integers exact) and ten more frames including
a forced full refresh and a forced repair. The JAX package's warmup and
frames are stored by ``scripts/export_pit160_npz.py`` in
``artifacts/pit160_jax.npz`` (group ``chained_ps``), so this file makes no
JAX step of its own."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "pit160_jax.npz")


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return {k[len("chained_ps."):]: v for k, v in f.items()
                if k.startswith("chained_ps.")}


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _config(blob):
    return PipelineConfig.from_dict(json.loads(str(blob)))


@pytest.fixture(scope="module")
def warmed(z):
    """(state arrays, configuration) after the JAX package's warmup: balls
    landed, contacts formed, BP cache, colours and solve bundle populated.
    The warmup stepped one fixed configuration whose budgets and rungs hold
    everything this scene needs."""
    arrays = _sub(z, "warmed.")
    counts = arrays["pair_count"]
    assert counts[1] > 100 and counts[0] > 0
    assert counts[9:9 + 16].max() <= 256  # every class fits its rung
    return arrays, _config(z["config_json"])


def _port(arrays, cfg):
    return state_from_arrays(arrays, device="cpu"), cfg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_state_round_trip(warmed):
    arrays = warmed[0]
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


@pytest.fixture(scope="module")
def first_frame(z, warmed):
    """One checked frame of each package from the warmed state: (JAX state,
    JAX config, port state, port config), the JAX side as stored. The
    one-step test checks it and the ten-frame run starts from it."""
    tstate, tcfg = _port(*warmed)
    return (state_from_arrays(_sub(z, "frame.0."), device="cpu"),
            _config(z["frame.0.config_json"]),
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


def test_ten_frames_track_jax(z, first_frame):
    """Caches, repairs, refreshes and regrows over ten frames; frame 3
    forces a full broad-phase refresh (slots permute: by-key warmstart and
    a fresh bundle), frame 6 forces a repair. Frame 0 is the module's first
    frame; the JAX package's frames are the stored ones."""
    tp = SimParams()
    paths = []
    for f in range(10):
        force = {3: "miss", 6: "repair"}.get(f)
        if f == 0:
            tstate, tcfg = first_frame[2:]
        else:
            tstate, tcfg = step_checked(
                tstate, tp, dataclasses.replace(tcfg, bp_force=force))
        tcfg = dataclasses.replace(tcfg, bp_force=None)
        jf = _sub(z, f"frame.{f}.")
        jpc, tpc = jf["pair_count"], _np(tstate.pair_count)
        np.testing.assert_array_equal(tpc, jpc, f"frame {f}")
        paths.append(int(tpc[3]))
        for got, want in (
                (tstate.bodies.poses.translation, jf["translation"]),
                (tstate.bodies.vels.linear, jf["linear"]),
                (tstate.bodies.vels.angular, jf["angular"])):
            assert np.isfinite(_np(got)).all()
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-3,
                                       atol=1e-3, err_msg=f"frame {f}")
    assert paths[3] == 2 and paths[6] == 1, paths


def _contact_set(state):
    c = state.prev_constraints
    return set(zip(c.body_a[c.valid].tolist(), c.body_b[c.valid].tolist()))


# gs_static_slots is still refused, alone and beside the solve modes the
# port takes (Jacobi, no ladder, no class cap, no slack, colour
# minimization); bp_algo="lbvh" is taken beside them, and one checked frame
# with a full broad-phase refresh has the grid's contact set
@pytest.mark.parametrize("change", [
    dict(gs_static_slots=True), dict(gs_static_slots=True, use_jacobi=True),
    dict(gs_static_slots=True, gs_windows=()),
    dict(gs_static_slots=True, gs_windows=(), gs_tail_window=1536),
    dict(bp_algo="lbvh", gs_cmax=0), dict(bp_algo="lbvh", bp_slack=0.0),
    dict(bp_algo="lbvh"), dict(bp_algo="lbvh", bp_min_color_sweeps=2)])
def test_step_refuses_flags_outside_the_slice(warmed, change):
    tstate, tcfg = _port(*warmed)
    cfg = dataclasses.replace(tcfg, **change)
    if cfg.bp_algo != "lbvh":
        with pytest.raises(NotImplementedError, match="refused"):
            step(tstate, SimParams(), cfg)
        return
    cfg = dataclasses.replace(cfg, bp_force="miss")
    got, got_cfg = step_checked(tstate, SimParams(), cfg)
    want, _ = step_checked(tstate, SimParams(),
                           dataclasses.replace(cfg, bp_algo="grid"))
    assert got_cfg.bp_algo == "lbvh" and int(got.pair_count[3]) == 2
    assert _contact_set(got) == _contact_set(want)
    assert len(_contact_set(got)) > 100
    assert torch.isfinite(got.bodies.poses.translation).all()


def test_step_refuses_sharding(warmed):
    """The step takes a shard of an initialised ``torch.distributed``
    group (``tests/test_torch_parallel.py`` runs it on gloo ranks) and
    refuses one that names no group."""
    tstate, tcfg = _port(*warmed)
    with pytest.raises(ValueError, match="shard"):
        step(tstate, SimParams(), tcfg, shard=("x", 4))
