"""The port's 2D step against the JAX package's frames, on the CPU.

- The eight 2D ``SCENES`` builders equal the JAX package's built states
  bit for bit (a SHA-1 of ``convert.state_to_arrays``, joints included,
  against the export's digest of JAX's), and ``auto_manifold_points``
  gives JAX's width for each.
- Three ``step_checked`` frames of every stored case of
  ``artifacts/planar_jax.npz.xz`` (``scripts/export_planar_npz.py``: the
  eight scenes under the testbed's configuration after 60 warm frames,
  ``pyramid2`` under ``--solver jacobi``, ``boxes_and_balls2`` under the
  chained ladder and under ``gs_fused`` with the broad-phase cache), each
  from JAX's state before it: pair and contact counts exact, translations
  within 1e-5 m. ``capsules2``: JAX's float32 GJK on the 2D embedding
  leaves the exact contact on 5-7 rows a frame (ROADMAP C14; the stored
  rows against a float64 witness, ``tests.planar_inputs.support_rows``),
  which the port's float64 kernel does not; so the bodies its solve joins
  to those rows through contacts are held to 2e-2 m (1.63e-2 measured),
  the contacts count JAX's rows with the witness's validity on those
  rows, and every other body and count as above.
- ``gs_fused=True`` gives a 2D step the unfused solve's bits, as the JAX
  package does (its fused solver is 3D only).
- ``convert`` carries a 2D state with joints across and back.
- ``_check_slice`` refuses only ``gs_static_slots`` and an unknown broad
  phase; a shard that names no initialised process group is refused by
  the step.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.planar_inputs import (
    case_mode,
    config_of,
    frame_errors,
    frame_ok,
    params_of,
    planar_arrays,
    planar_state,
    small_cases,
    state_digest,
)
from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
from wgmath_tpu_torch.pipeline import (
    PipelineConfig,
    auto_manifold_points,
    step,
    step_checked,
)
from wgmath_tpu_torch.scenes.builders import PLANAR_SCENES, SCENES
from tests.torch_threads import one_torch_thread  # noqa: F401

CASES = small_cases()


@pytest.mark.parametrize("name", PLANAR_SCENES)
def test_builders_equal_jax(name):
    """The built state's SHA-1 (every array's key, dtype, shape and bytes)
    is the JAX package's, as the export stored it."""
    z = planar_arrays()
    got = SCENES[name](device="cpu")
    assert state_digest(state_to_arrays(got)) == str(
        z[f"built.{name}.digest"])
    assert auto_manifold_points(got.shapes, 2) == int(
        z[f"built.{name}.manifold_points"])


def _frame(case: str, f: int):
    st = planar_state(case, f)
    cfg = config_of(f"{case}.config_json" if f == 0
                    else f"{case}.ref.{f - 1}.config_json")
    return st, cfg, step_checked(st, params_of(case_mode(case)), cfg)


@pytest.mark.parametrize("case", CASES)
def test_three_frames_against_jax(case):
    for f in range(3):
        st, _, (new, _) = _frame(case, f)
        m = frame_errors(case, f, st, new)
        assert frame_ok(m), (case, f, m)


def test_gs_fused_in_2d_is_the_unfused_solve():
    case = "boxes_and_balls2_fused"
    st, cfg, (fused, _) = _frame(case, 0)
    assert cfg.gs_fused and cfg.bp_slack > 0
    plain, _ = step_checked(st, params_of("fused"),
                            dataclasses.replace(cfg, gs_fused=False))
    for a, b in ((fused.bodies.poses.translation,
                  plain.bodies.poses.translation),
                 (fused.bodies.vels.angular, plain.bodies.vels.angular),
                 (fused.pair_count, plain.pair_count)):
        assert torch.equal(a, b)


def test_convert_round_trip_2d_with_joints():
    st = SCENES["joint_prismatic2"](device="cpu")
    st, _ = step_checked(st, params_of("default"),
                         PipelineConfig(pair_capacity=256))
    a = state_to_arrays(st)
    back = state_to_arrays(state_from_arrays(a, "cpu"))
    assert sorted(a) == sorted(back)
    for k in a:
        np.testing.assert_array_equal(back[k], a[k], err_msg=k)
    assert state_from_arrays(a, "cpu").joints.slots == st.joints.slots


@pytest.mark.parametrize("bad", ["shard", "gs_static_slots", "bp_algo",
                                 None])
def test_check_slice_refuses_only_the_listed(bad):
    st = SCENES["boxes_and_balls2"](device="cpu")
    cfg = PipelineConfig(pair_capacity=1024, manifold_points=2)
    kw = {}
    if bad == "shard":
        kw["shard"] = ("x", 4)
    elif bad == "gs_static_slots":
        cfg = dataclasses.replace(cfg, gs_static_slots=True)
    elif bad == "bp_algo":
        cfg = dataclasses.replace(cfg, bp_algo="sap")
    if bad is None:
        new = step(st, params_of("default"), cfg, warmstart=False)
        assert new.bodies.dim == 2
    elif bad == "shard":
        with pytest.raises(ValueError, match="no torch.distributed"):
            step(st, params_of("default"), cfg, warmstart=False, **kw)
    else:
        with pytest.raises(NotImplementedError, match="refused"):
            step(st, params_of("default"), cfg, warmstart=False, **kw)
