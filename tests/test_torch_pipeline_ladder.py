"""The port's ladder, chained and chained_rr steps against the JAX package:
a 160-ball pit warmed by the JAX package under a scaled-down ``ladder``
configuration (grid broad phase with its slack cache, cached pair colours,
colour-major contact compaction, the window ladder), carried across with
``state_from_arrays``, then stepped once by both packages under each
configuration — integers exact, floats at the stated tolerances. The JAX
package's warmup and steps are stored by ``scripts/export_pit160_npz.py``
in ``artifacts/pit160_jax.npz`` (group ``ladder``), so this file makes no
JAX step of its own."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
from wgmath_tpu_torch.core.dispatch import capacity_bucket
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "pit160_jax.npz")
# the bench's candidates on top of the ladder; the last is the ladder with
# no contact compaction (the solve sorts the fields itself)
CONFIGS = {
    "ladder": {},
    "chained": dict(gs_chained=True),
    "chained_rr": dict(gs_chained=True, gs_rhs_in_rung=True),
    "ladder_cc0": dict(contact_capacity=0),
}


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return {k[len("ladder."):]: v for k, v in f.items()
                if k.startswith("ladder.")}


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


@pytest.fixture(scope="module")
def warmed(z):
    """(state arrays, configuration) after the JAX package's warmup under
    the ladder: balls landed, contacts formed, BP cache, colours and the
    6-part solve bundle populated. One fixed configuration whose budgets
    and rungs hold everything this scene needs."""
    arrays = _sub(z, "warmed.")
    counts = arrays["pair_count"]
    assert 100 < counts[1] <= 1024 and 0 < counts[0] <= 2048
    assert counts[9:9 + 16].max() <= 256  # every class fits its rung
    assert sum(k.startswith("solve_cache.") for k in arrays) == 6
    return arrays, PipelineConfig.from_dict(json.loads(str(
        z["config_json"])))


def _port(arrays, cfg):
    return state_from_arrays(arrays, device="cpu"), cfg


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_ladder_state_round_trip(warmed):
    """The 6-part bundle, the unsorted-slot colour tag and a
    ``prev_constraints`` of ``contact_capacity`` rows carry across."""
    arrays = warmed[0]
    assert arrays["prev_constraints.body_a"].shape == (1024,)
    assert int(arrays["bp_colors.slot_flag"]) == 0
    assert sum(k.startswith("solve_cache.") for k in arrays) == 6
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_one_step_matches_jax(z, warmed, name):
    arrays, cfg = warmed
    tstate, tcfg = _port(arrays, dataclasses.replace(cfg, **CONFIGS[name]))
    # the JAX package's step from the same state under the same
    # configuration (warmstart=True, as the warmup's later frames)
    js = state_from_arrays(_sub(z, f"step.{name}."), device="cpu")
    ts = step(tstate, SimParams(), tcfg)
    # integers exact: counts, cached pair list and colours, the contact
    # colours handed on, solve bundle, constraint slots
    np.testing.assert_array_equal(_np(ts.pair_count), _np(js.pair_count))
    for f in ("body_a", "body_b", "valid", "count"):
        np.testing.assert_array_equal(_np(getattr(ts.bp_pairs, f)),
                                      _np(getattr(js.bp_pairs, f)), f)
    np.testing.assert_array_equal(_np(ts.bp_colors[0]),
                                  _np(js.bp_colors[0]))
    assert ts.bp_colors[1:] == tuple(int(x) for x in js.bp_colors[1:])
    np.testing.assert_array_equal(_np(ts.prev_colors), _np(js.prev_colors))
    assert len(ts.solve_cache) == len(js.solve_cache) == (
        8 if "gs_chained" in CONFIGS[name] else 6)
    for i, (g, w) in enumerate(zip(ts.solve_cache, js.solve_cache)):
        np.testing.assert_array_equal(_np(g), _np(w), f"solve_cache[{i}]")
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(_np(getattr(ts.prev_constraints, f)),
                                      _np(getattr(js.prev_constraints, f)))
    # floats: poses at 1e-6. Velocities get atol 5e-5, not 1e-5: XLA on
    # the CPU fuses a*b+c into one rounding where PyTorch rounds the
    # product, and the substep rhs rebuild turns one ulp of a ~5 m world
    # point into ~1e-4 m/s of bias velocity
    tb, jb = ts.bodies, js.bodies
    for got, want in ((tb.poses.translation, jb.poses.translation),
                      (tb.poses.rotation, jb.poses.rotation)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-6)
    for got, want in ((tb.vels.linear, jb.vels.linear),
                      (tb.vels.angular, jb.vels.angular)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                   atol=5e-5)
    np.testing.assert_allclose(_np(ts.prev_constraints.n_impulse),
                               _np(js.prev_constraints.n_impulse),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("name", ["chained", "chained_rr", "ladder_cc0"])
def test_port_candidates_match_port_ladder(warmed, name):
    """Within the port, from one warmed state: the chained sweep, the
    in-kernel rhs and the solve's own colour sort advance the pile as the
    ladder does (the JAX package's own wiring tests of these paths)."""
    tstate, tcfg = _port(*warmed)
    lad = step(tstate, SimParams(), tcfg)
    cand = step(tstate, SimParams(),
                dataclasses.replace(tcfg, **CONFIGS[name]))
    np.testing.assert_array_equal(_np(cand.pair_count)[:4],
                                  _np(lad.pair_count)[:4])
    np.testing.assert_allclose(_np(cand.bodies.vels.linear),
                               _np(lad.bodies.vels.linear), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(_np(cand.bodies.poses.translation),
                               _np(lad.bodies.poses.translation), rtol=1e-5,
                               atol=1e-6)


def test_step_checked_regrows_contact_capacity(warmed):
    """A contact buffer smaller than the live contacts signals through the
    count; ``step_checked`` re-buckets it and re-runs the frame."""
    tstate, tcfg = _port(*warmed)
    want = step(tstate, SimParams(), tcfg)
    n_contacts = int(want.pair_count[1])
    small = dataclasses.replace(tcfg, contact_capacity=128)
    assert n_contacts > 128
    clipped = step(tstate, SimParams(), small)
    assert int(clipped.pair_count[1]) == n_contacts  # the true count
    assert int(clipped.prev_constraints.valid.sum()) == 128
    got, cfg = step_checked(tstate, SimParams(), small)
    assert cfg.contact_capacity == capacity_bucket(n_contacts)
    np.testing.assert_array_equal(_np(got.pair_count), _np(want.pair_count))
    # the pair-slot layout ignores the knob
    ps = dataclasses.replace(small, gs_chained=True, gs_rhs_in_rung=True,
                             gs_pair_slots=True)
    assert step_checked(tstate, SimParams(), ps)[1].contact_capacity == 128
