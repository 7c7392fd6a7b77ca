"""The port's whole step under the fused solver with impulse joints, and
under the LBVH broad phase, against the JAX package's frames stored in
``artifacts/lbvh_fused_joints_jax.npz.xz`` (``JAX_PLATFORMS=cpu python
scripts/export_lbvh_fused_joints_npz.py`` rewrites it), so this file makes
no JAX step: one checked frame from JAX's state each (``ball_net3(16,
16)``, whose rungs start cut to 8, three frames on: the pair capacity
regrows on the first, the rungs and the residue rung on the next two),
the counts and the configuration after the regrows exactly, translations
within 1e-5 m and velocities within
``tests/test_torch_pipeline_joints.py``'s limits.

Under ``gs_fused`` with joints each substep runs the sweep kernel's
wrapper alone twice (biased, then unbiased) and the substep kernel's
never, as the JAX package's ``substep_gs`` with the fused sweep does;
under ``bp_algo="lbvh"`` the frame has the contact set of the brute force
and of the grid (``tests/test_lbvh.py``'s pipeline case)."""

import dataclasses
import os

import numpy as np
import pytest

from tests.test_torch_pipeline_joints import (
    TR_TOL,
    VEL_TOL,
    case_config,
    case_params,
    case_state,
)
from wgmath_tpu_torch.convert import load_arrays
from wgmath_tpu_torch.dynamics import solver
from wgmath_tpu_torch.pipeline import step, step_checked

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "lbvh_fused_joints_jax.npz.xz")
FUSED_CASES = ("drape_fused", "chain_fused", "net16_fused")


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def _matches_ref(z, case, got, got_cfg, frame=0):
    ref = f"{case}.ref.{frame}."
    np.testing.assert_array_equal(got.pair_count.numpy(),
                                  z[ref + "pair_count"])
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(
        case_config(z, ref + "config_json"))
    np.testing.assert_allclose(got.bodies.poses.translation.numpy(),
                               z[ref + "translation"], rtol=0, atol=TR_TOL)
    for field, tol in VEL_TOL.items():
        np.testing.assert_allclose(getattr(got.bodies.vels, field).numpy(),
                                   z[ref + field], rtol=0, atol=tol,
                                   err_msg=field)


@pytest.mark.parametrize("case", FUSED_CASES)
def test_fused_joint_step_matches_jax(z, case, monkeypatch):
    state = case_state(z, case, "warmed")
    assert state.joints is not None
    cfg = case_config(z, f"{case}.config_json")
    params = case_params(z, case)
    calls = {"fused_sweep": 0, "fused_substep1": 0}
    for name in calls:
        def counted(*a, _fn=getattr(solver, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(solver, name, counted)
    runs, got, got_cfg = 0, state, cfg
    for f in range(3 if case == "net16_fused" else 1):
        prev_cfg = got_cfg
        got, got_cfg = step_checked(got, params, got_cfg)
        _matches_ref(z, case, got, got_cfg, f)
        runs += 1 + (got_cfg != prev_cfg)  # a regrow runs the frame again
    assert len(got.solve_cache) == 8  # the fused solve's bundle
    assert calls == {"fused_sweep": 2 * params.num_solver_iterations
                     * runs, "fused_substep1": 0}
    if case == "net16_fused":
        # the pair capacity, the rungs and the residue rung regrew
        assert (got_cfg.gs_windows != cfg.gs_windows
                and got_cfg.gs_rung0 > cfg.gs_rung0
                and got_cfg.pair_capacity > cfg.pair_capacity)
    assert (int(got.pair_count[1]) == 0) == (case == "chain_fused")


def _contact_set(state):
    c = state.prev_constraints
    return set(zip(c.body_a[c.valid].tolist(), c.body_b[c.valid].tolist()))


def test_lbvh_step_matches_jax_and_the_grids_contacts(z):
    state = case_state(z, "lbvh_balls", "warmed")
    cfg = case_config(z, "lbvh_balls.config_json")
    params = case_params(z, "lbvh_balls")
    assert cfg.bp_algo == "lbvh"
    got, got_cfg = step_checked(state, params, cfg)
    _matches_ref(z, "lbvh_balls", got, got_cfg)
    sets = {algo: _contact_set(step(state, params, dataclasses.replace(
        cfg, bp_algo=algo))) for algo in ("brute", "grid")}
    assert _contact_set(got) == sets["brute"] == sets["grid"]
    assert len(sets["grid"]) > 50
