"""One jointed ``step_checked`` of the port from each small JAX state
stored in ``artifacts/joints_jax.npz`` (``scripts/export_joints_npz.py``),
against JAX's next frame: the four chains of ``SCENES`` (no contacts: the
joint passes run around empty sweeps), the drape scene of
``tests/test_joints.py`` under ``ladder``, ``chained_rr`` and
``chained_ps`` (a chain resting on the ground: joints and contacts in
one solve), and ``ball_net3(16, 16)`` on the dome under the windowless
default (colouring in the solve, uniform windows); and ``ball_net3(100,
100)`` (10,002 bodies, 19,800 joints) from JAX's state after the drape,
one frame under each of ``ladder`` and ``chained_ps`` (its reference
keeps translations and counts only). This file imports no JAX.

Counts (``pair_count``: pairs, contacts, classes, broad-phase path,
demands, class counts) exactly. Translations within 1e-5 m; linear
velocities within 5e-5 m/s, angular within 5e-4 rad/s: the joint and
contact passes run in JAX's order, and what is left is XLA's CPU
contraction of ``a*b+c`` into one rounding (ROADMAP C4: 2.3e-5 m/s on the
ball pit). A friction impulse at a ball's surface turns a linear gap into
an angular one 1/(0.4·r) times as large: 10x for the nets' balls of
r = 0.25.
``_check_slice`` takes the fused solver with joints and refuses 2D
joints."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import joints_from_arrays, state_from_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "joints_jax.npz")
SMALL = ("joint_ball3", "joint_revolute3", "joint_fixed3",
         "joint_prismatic3", "drape_ladder", "drape_chained_rr",
         "drape_chained_ps", "net16")
TR_TOL = 1e-5
VEL_TOL = {"linear": 5e-5, "angular": 5e-4}


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return {k: f[k] for k in f.files if not k.startswith("unit.")}


def case_state(z, case: str, prefix: str, device="cpu"):
    """The stored state ``<case>.<prefix>.*`` with the case's joints."""
    d = {k[len(case) + 1:]: v for k, v in z.items()
         if k.startswith(f"{case}.joints.")}
    p = f"{case}.{prefix}."
    d.update({k[len(p):]: v for k, v in z.items() if k.startswith(p)})
    return state_from_arrays(d, device=device)


def case_params(z, case: str) -> SimParams:
    kw = json.loads(str(z[f"{case}.params_json"]))
    kw["gravity"] = tuple(kw["gravity"])
    return SimParams(**kw)


def case_config(z, key: str) -> PipelineConfig:
    return PipelineConfig.from_dict(json.loads(str(z[key])))


@pytest.mark.parametrize("case", SMALL)
def test_one_step_matches_jax(z, case):
    state = case_state(z, case, "warmed")
    assert state.joints is not None
    cfg = case_config(z, f"{case}.config_json")
    got, got_cfg = step_checked(state, case_params(z, case), cfg)
    ref = f"{case}.ref.0."
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
    assert got.joints is state.joints


@pytest.mark.parametrize("case", ["net100_ladder", "net100_chained_ps"])
def test_net100_step_matches_jax(z, case):
    state = case_state(z, "net100", "drape")
    cfg = case_config(z, f"{case}.config_json")
    got, got_cfg = step_checked(state, case_params(z, "net100"), cfg)
    ref = f"{case}.ref.0."
    np.testing.assert_array_equal(got.pair_count.numpy(),
                                  z[ref + "pair_count"])
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(
        case_config(z, ref + "config_json"))
    np.testing.assert_allclose(got.bodies.poses.translation.numpy(),
                               z[ref + "translation"], rtol=0, atol=TR_TOL)


def test_cases_exercise_contacts_and_colours(z):
    """The drape and the nets have contacts beside their joints; the
    chains have none; the 10k net's joints take four colours of 5,000,
    5,000, 4,998 and 4,802 joints, and only the linear locks."""
    for case in SMALL + ("net100_ladder", "net100_chained_ps"):
        contacts = int(z[f"{case}.ref.0.pair_count"][1])
        assert (contacts == 0) == case.startswith("joint_"), case
    net = case_state(z, "net100", "drape")
    assert net.bodies.num_bodies == 10_002
    assert net.joints.num_joints == 19_800 and net.joints.max_color == 4
    assert net.joints.slots == (9, 10, 11)
    np.testing.assert_array_equal(np.bincount(net.joints.colors.numpy()),
                                  [0, 5000, 5000, 4998, 4802])


def test_refuses_fused_and_2d_joints(z):
    """The fused solver with joints is taken (its frames against JAX's are
    ``tests/test_torch_pipeline_fused_joints.py``); 2D joints are still
    refused."""
    state = case_state(z, "drape_ladder", "warmed")
    cfg = case_config(z, "drape_ladder.config_json")
    fused = step(state, SimParams(), dataclasses.replace(cfg, gs_fused=True))
    assert len(fused.solve_cache) == 8  # the fused solve's bundle
    assert torch.isfinite(fused.bodies.poses.translation).all()
    assert int(fused.pair_count[1]) > 0
    flat = {k[len("drape_ladder.joints."):]: v for k, v in z.items()
            if k.startswith("drape_ladder.joints.")}
    for f in ("local_frame_a", "local_frame_b"):
        flat[f"{f}.translation"] = flat[f"{f}.translation"][:, :2]
        flat[f"{f}.rotation"] = flat[f"{f}.rotation"][:, :2]
    state2d = dataclasses.replace(state, joints=joints_from_arrays(
        flat, device="cpu"))
    with pytest.raises(NotImplementedError, match="2D joints"):
        step(state2d, SimParams(), cfg)
