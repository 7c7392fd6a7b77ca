"""The port's step on the primitive rain against JAX frames stored by
``scripts/export_primitives_npz.py`` in ``artifacts/primitives3_small.npz``:
``primitives3(40)`` (200 balls, cuboids, capsules, cylinders and cones and
the ground) warmed 60 frames by the JAX package under the 4-point
``ladder`` and ``fused`` configurations of ``primitive_configs``, then
three reference frames. Each frame starts from JAX's state before it (the
warmed state, then the stored state after each reference frame) and is
stepped by ``step_checked``. Also: the regrow of ``pfm_pair_capacity``,
``convert``'s round trip with the new kinds, the builder and the three new
mass properties against the JAX package's (no step).

Tolerances, and why: the configuration, the pair count, the broad-phase
path and the compaction demands exactly. GJK and EPA iterate in f32, and
an ulp of difference (XLA contracts ``a*b+c`` into one rounding, ROADMAP
C4) can send a near-degenerate pair into another simplex
(``tests/test_torch_gjk.py`` counts such pairs: up to 7 % of EPA's). In a
frame of this pile such a pair can gain or lose its contact, so the
contact count and its class's count may differ by one (measured: one
frame in three), and a pair's normal can turn, which moves its two
bodies: at least 85 % of the bodies within 1e-4 m of JAX's translation
(measured 91.0-100 %), the median within 1e-6 m (measured 0), every body
within 5e-2 m (measured 2.6e-2 m, a cylinder pair 2 cm deep); velocities
at the 90th percentile within 1e-2 m/s and 5e-2 rad/s (measured 5.3e-3
and 1.9e-2)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from wgmath_tpu.dynamics import body as jbody
from wgmath_tpu.scenes import builders as jax_builders
from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
from wgmath_tpu_torch.dynamics import body as tbody
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked
from wgmath_tpu_torch.scenes import builders
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "primitives3_small.npz")
REF_FRAMES = 3
SCENE = "primitives3"
NEAR_SHARE, NEAR_ATOL = 0.85, 1e-4
MEDIAN_ATOL, FAR_ATOL = 1e-6, 5e-2
LINEAR_P90, ANGULAR_P90 = 1e-2, 5e-2


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return dict(f)


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _config(z, key):
    return PipelineConfig.from_dict(json.loads(str(z[key])))


def _counts_match(got, want):
    """Every count exactly but the contacts' and their classes', which may
    differ by one contact."""
    got, want = np.asarray(got), np.asarray(want)
    exact = np.ones(len(got), bool)
    exact[1] = False
    exact[8:] = False
    np.testing.assert_array_equal(got[exact], want[exact])
    assert abs(int(got[1]) - int(want[1])) <= 1, (got[1], want[1])
    assert np.abs(got[8:] - want[8:]).sum() <= 2 * abs(int(got[1])
                                                        - int(want[1]))


def _frame_matches(state, z, ref):
    tr = state.bodies.poses.translation.numpy()
    dx = np.abs(tr - z[ref + "translation"]).max(-1)
    assert (dx <= NEAR_ATOL).mean() >= NEAR_SHARE, np.sort(dx)[-20:]
    assert np.median(dx) <= MEDIAN_ATOL and dx.max() <= FAR_ATOL, dx.max()
    for got, key, p90 in ((state.bodies.vels.linear, "linear", LINEAR_P90),
                          (state.bodies.vels.angular, "angular",
                           ANGULAR_P90)):
        d = np.abs(got.numpy() - z[ref + key]).max(-1)
        assert np.quantile(d, 0.9) <= p90, (key, np.quantile(d, 0.9))
    assert np.isfinite(tr).all()


@pytest.mark.parametrize("name", ["ladder", "fused"])
def test_frames_match_jax(z, name):
    """Three frames, each from JAX's state before it: the configuration,
    the counts and the bodies as JAX's (see the tolerances above)."""
    for f in range(REF_FRAMES):
        start = (f"{SCENE}.{name}." if f == 0
                 else f"{SCENE}.{name}.ref.{f - 1}.")
        state = state_from_arrays(_sub(z, start + "state."), device="cpu")
        cfg = _config(z, start + "config_json")
        assert state.prev_constraints.n_impulse.shape[1] == 4
        ref = f"{SCENE}.{name}.ref.{f}."
        state, cfg = step_checked(state, SimParams(), cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            _config(z, ref + "config_json"))
        _counts_match(state.pair_count.numpy(), z[ref + "pair_count"])
        _frame_matches(state, z, ref)
    # the frames hold support-mapped pairs and contacts
    pc = z[f"{SCENE}.{name}.ref.0.pair_count"]
    assert pc[7] > 300 and pc[1] > 100


def test_step_checked_regrows_pfm_capacity_as_jax(z):
    """``pfm_pair_capacity`` 32 below the warmed pile's support-mapped
    pairs: the frame drops the pairs past it, returns their true count,
    and ``step_checked`` regrows the capacity and re-runs the frame, as
    the JAX package does."""
    state = state_from_arrays(_sub(z, f"{SCENE}.ladder.state."),
                              device="cpu")
    small = _config(z, f"{SCENE}.regrow.config_json")
    assert small.pfm_pair_capacity == 32
    got, cfg = step_checked(state, SimParams(), small)
    want = _config(z, f"{SCENE}.regrow.0.config_json")
    assert cfg.pfm_pair_capacity > 32
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    _counts_match(got.pair_count.numpy(), z[f"{SCENE}.regrow.0.pair_count"])
    assert int(got.pair_count[7]) > 32


def test_convert_round_trip_with_the_new_kinds(z):
    """A state of the five kinds carries across both ways: JAX's warmed
    fused state, and the port's own after a ladder frame."""
    arrays = _sub(z, f"{SCENE}.fused.state.")
    assert set(arrays["shapes.kind"].tolist()) == {0, 1, 2, 3, 4}
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    ladder = _sub(z, f"{SCENE}.ladder.state.")
    state, _ = step_checked(state_from_arrays(ladder, device="cpu"),
                            SimParams(),
                            _config(z, f"{SCENE}.ladder.config_json"))
    mine = state_to_arrays(state)
    assert mine.keys() == ladder.keys()
    again = state_to_arrays(state_from_arrays(mine, device="cpu"))
    for k in mine:
        assert mine[k].shape == ladder[k].shape, k
        np.testing.assert_array_equal(again[k], mine[k], err_msg=k)


def test_builder_matches_jax():
    want = state_to_arrays(jax_builders.primitives3(4))
    got = state_to_arrays(builders.primitives3(4, device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", ["capsule", "cylinder", "cone"])
def test_mass_properties_match_jax(kind):
    """Each new shape's mass properties, dynamic and static rows, bit for
    bit."""
    rng = np.random.default_rng(3)
    hh = rng.uniform(0.1, 1.0, 16).astype(np.float32)
    r = rng.uniform(0.1, 1.0, 16).astype(np.float32)
    dyn = rng.random(16) < 0.7
    fn = f"{kind}_local_mprops"
    want = getattr(jbody, fn)(hh, r, 1.3, dynamic=dyn)
    got = getattr(tbody, fn)(torch.from_numpy(hh), torch.from_numpy(r), 1.3,
                             dynamic=torch.from_numpy(dyn))
    for f in ("inv_mass", "com", "inertia_ref_frame",
              "inv_principal_inertia"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_scenes_and_configs():
    assert set(builders.SCENES) <= set(jax_builders.SCENES)
    st = builders.SCENES["primitives3"](device="cpu")
    assert st.bodies.poses.translation.shape[0] == 201
    assert st.shapes.kinds == frozenset({0, 1, 2, 3, 4})
    for n in (201, 10_001):
        prim, box = builders.primitive_configs(n), builders.box_configs(n)
        for name in ("ladder", "fused"):
            assert prim[name] == dict(box[name],
                                      pfm_pair_capacity=prim[name][
                                          "pfm_pair_capacity"])
            assert "pfm_pair_capacity" not in box[name]
    assert builders.primitive_configs(10_001)["ladder"][
        "pfm_pair_capacity"] == 65536
    assert builders.primitive_configs(4)["fused"]["pfm_pair_capacity"] == 256
