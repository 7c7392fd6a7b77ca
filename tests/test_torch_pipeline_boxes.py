"""The port's step on the box scenes against JAX frames stored by
``scripts/export_box_npz.py`` in ``artifacts/boxes_small.npz``:
``pyramid(6)`` and ``boxes_and_balls(64)``, each warmed by the JAX package
under the ``ladder`` and ``fused`` 4-point configurations, then three
reference frames. The port starts from JAX's warmed state (cuboid-cuboid
SAT manifolds, 4-wide constraints, the broad-phase cache, the colours and
the solve bundle) and steps the same three frames with ``step_checked``.
Also: the regrow of ``sat_pair_capacity``, ``convert``'s round trip at
width 4, and the six box builders and ``balls`` against the JAX
package's (no step)."""

import dataclasses
import json
import os

import numpy as np
import pytest

from wgmath_tpu.scenes import builders as jax_builders
from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked
from wgmath_tpu_torch.scenes import builders
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "boxes_small.npz")
REF_FRAMES = 3
# counts and configurations exactly. Reals: the pit tests' one-step
# tolerances (translations atol 1e-6, velocities rtol 1e-4, atol 5e-5),
# loosened by 2x for frames 2 and 3: XLA on the CPU contracts a*b+c into
# one rounding where PyTorch rounds the product (ROADMAP C4), so an ulp of
# a composed rotation or a world point seeds each frame, and the sweeps
# carry it on. Measured on the four cases: translations 2.4e-7 after one
# frame and 4.8e-7 after three, linear velocities 1.1e-5 / 3.0e-5,
# angular 2.8e-5 / 4.6e-5.
TRANSLATION_ATOL = (1e-6, 2e-6, 2e-6)
VELOCITY_ATOL = (5e-5, 1e-4, 1e-4)


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return dict(f)


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _config(z, key):
    return PipelineConfig.from_dict(json.loads(str(z[key])))


@pytest.mark.parametrize("scene", ["pyramid6", "bab64"])
@pytest.mark.parametrize("name", ["ladder", "fused"])
def test_three_frames_match_jax(z, scene, name):
    state = state_from_arrays(_sub(z, f"{scene}.{name}.state."),
                              device="cpu")
    cfg = _config(z, f"{scene}.{name}.config_json")
    assert state.prev_constraints.n_impulse.shape[1] == 4
    for f in range(REF_FRAMES):
        ref = f"{scene}.{name}.ref.{f}."
        state, cfg = step_checked(state, SimParams(), cfg)
        # the configuration (no regrow from a warmed state) and the counts
        # exactly: pairs, contacts, classes, bp path, compaction demands
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            _config(z, ref + "config_json"))
        np.testing.assert_array_equal(state.pair_count.numpy(),
                                      z[ref + "pair_count"])
        np.testing.assert_allclose(state.bodies.poses.translation.numpy(),
                                   z[ref + "translation"], rtol=0,
                                   atol=TRANSLATION_ATOL[f])
        for got, key in ((state.bodies.vels.linear, "linear"),
                         (state.bodies.vels.angular, "angular")):
            np.testing.assert_allclose(got.numpy(), z[ref + key], rtol=1e-4,
                                       atol=VELOCITY_ATOL[f], err_msg=key)
    assert int(z[f"{scene}.{name}.ref.0.pair_count"][1]) > 0


def test_step_checked_regrows_sat_capacity_as_jax(z):
    """``sat_pair_capacity`` 256 below the warmed pyramid's cuboid pairs:
    the frame drops the pairs past it, returns their true count, and
    ``step_checked`` regrows the capacity and re-runs the frame, as the
    JAX package does."""
    state = state_from_arrays(_sub(z, "pyramid6.ladder.state."),
                              device="cpu")
    small = _config(z, "pyramid6.regrow.config_json")
    assert small.sat_pair_capacity == 256
    got, cfg = step_checked(state, SimParams(), small)
    want = _config(z, "pyramid6.regrow.0.config_json")
    assert cfg.sat_pair_capacity > 256
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    np.testing.assert_array_equal(got.pair_count.numpy(),
                                  z["pyramid6.regrow.0.pair_count"])
    assert int(got.pair_count[6]) > 256


def test_convert_round_trip_at_width_4(z):
    """A state whose ``prev_constraints`` are 4 wide carries across both
    ways: JAX's warmed fused state (its 8-part bundle), and the port's own
    after a ladder frame."""
    arrays = _sub(z, "pyramid6.fused.state.")
    assert arrays["prev_constraints.n_impulse"].shape[1] == 4
    assert arrays["prev_constraints.t_impulse"].shape[1:] == (4, 2)
    back = state_to_arrays(state_from_arrays(arrays, device="cpu"))
    assert back.keys() == arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k], err_msg=k)
    ladder = _sub(z, "pyramid6.ladder.state.")
    state, _ = step_checked(state_from_arrays(ladder, device="cpu"),
                            SimParams(),
                            _config(z, "pyramid6.ladder.config_json"))
    mine = state_to_arrays(state)
    assert mine.keys() == ladder.keys()
    assert mine["prev_constraints.n_impulse"].shape[1] == 4
    again = state_to_arrays(state_from_arrays(mine, device="cpu"))
    for k in mine:
        assert mine[k].shape == ladder[k].shape, k
        np.testing.assert_array_equal(again[k], mine[k], err_msg=k)


BUILDERS = {
    "boxes": dict(n=20),
    "pyramid": dict(levels=3),
    "pyramid_balls": dict(levels=2, use_balls=True),
    "keva_tower": dict(levels=3, per_level=2),
    "many_pyramids": dict(count=3, levels=2),
    "boxes_and_balls": dict(n=10),
    "balls": dict(n=30),
    "pendulum_chain": dict(links=3),
    "pendulum_chain_revolute": dict(links=3, joint="revolute"),
    "joint_chain": dict(links=3),
    "joint_chain_prismatic": dict(links=3, joint="prismatic"),
    "ball_net3": dict(nk=4, ni=3),
}
# cases that call another builder than their name
BUILDER_FN = {"pyramid_balls": "pyramid",
              "pendulum_chain_revolute": "pendulum_chain",
              "joint_chain_prismatic": "joint_chain"}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builders_match_jax(name):
    fn = BUILDER_FN.get(name, name)
    want = state_to_arrays(getattr(jax_builders, fn)(**BUILDERS[name]))
    got = state_to_arrays(getattr(builders, fn)(**BUILDERS[name],
                                                device="cpu"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_scenes_table_and_levels():
    assert set(builders.SCENES) <= set(jax_builders.SCENES)
    assert builders.SCENES["pyramid3"](device="cpu").bodies.poses \
        .translation.shape[0] == 2871
    for target in (1, 91, 9455, 42925, 42926):
        assert builders.pyramid_levels_for_bodies(target) == \
            jax_builders.pyramid_levels_for_bodies(target)
    # 2D builds (the 2D scenes are tests/test_torch_pipeline_planar.py's)
    got = state_to_arrays(builders.boxes(8, dim=2, device="cpu"))
    want = state_to_arrays(jax_builders.boxes(8, dim=2))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
