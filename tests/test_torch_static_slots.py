"""Static pair slots (``PipelineConfig.gs_static_slots``) in the port
against the JAX package's results stored by
``scripts/export_static_slots_npz.py`` in
``artifacts/static_slots_jax.npz.xz``, so this file makes no JAX step.

``tests/test_gs_chained.py``'s ``balls(256)`` configuration: six checked
frames from the JAX package's warmed state (natural, a full refresh, a
repair, a forced hit), a narrow ladder whose classes overflow into the
tail and a ladder whose tail outgrows the capacity. Integers (counts, the
cached pairs' slots and colours, the layout flag, the regrown
configuration) exactly; translations within 1e-5 m. Then the port alone:
static against dynamic pair slots over 30 frames from the built scene
(``test_gs_chained.py``'s A/B), the static layout's invariant, and the
cache's refresh when the layout or the ladder changes."""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import load_arrays, state_from_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked
from wgmath_tpu_torch.scenes.builders import balls
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "static_slots_jax.npz.xz")
N_FRAMES = 6
FORCED = {2: 2, 4: 1, 5: 0}  # frame -> the broad-phase path it forces
TRANSLATION_ATOL = 1e-5


@pytest.fixture(scope="module")
def z():
    return {k[len("balls."):]: v for k, v in load_arrays(NPZ).items()
            if k.startswith("balls.")}


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _config(blob) -> PipelineConfig:
    return PipelineConfig.from_dict(json.loads(str(blob)))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flag(cfg: PipelineConfig) -> int:
    return 2 + zlib.crc32(repr(tuple(
        cfg.gs_windows[:cfg.max_colors])).encode()) % 2000000000


def _warmed(z):
    return state_from_arrays(_sub(z, "warmed."), device="cpu")


def _layout_equal(state, want: dict, what: str) -> None:
    p = state.bp_pairs
    for k, got in (("body_a", p.body_a), ("body_b", p.body_b),
                   ("valid", p.valid), ("colors", state.bp_colors[0])):
        np.testing.assert_array_equal(_np(got), want[k], f"{what}: {k}")
    assert state.bp_colors[3] == int(want["slot_flag"]), what


def _assert_static_layout(state, cfg: PipelineConfig) -> None:
    """Every valid pair of colour c in ``[W[c-1], W[c])`` or in the tail
    past ``W[-1]``; the flag names the ladder; the capacity holds the
    ladder and a tail of 256."""
    cols = _np(state.bp_colors[0])
    valid = _np(state.bp_pairs.valid)
    w = np.concatenate([[0], np.cumsum(cfg.gs_windows[:cfg.max_colors])])
    assert cfg.pair_capacity >= w[-1] + 256
    slots = np.nonzero(valid[:w[-1]])[0]
    c = cols[slots]
    assert ((c >= 1) & (c <= cfg.max_colors)).all()
    assert ((w[c - 1] <= slots) & (slots < w[c])).all()
    assert state.bp_colors[3] == _flag(cfg) != 1


@pytest.fixture(scope="module")
def frames(z):
    """The port's six checked frames from the JAX package's warmed state,
    each under the configuration the JAX package was given for it."""
    s, out = _warmed(z), []
    for f in range(N_FRAMES):
        c_in = _config(z[f"frame.{f}.config_in"])
        s, c = step_checked(s, SimParams(), c_in)
        out.append((s, dataclasses.replace(c, bp_force=None)))
    return out


@pytest.mark.parametrize("f", range(N_FRAMES))
def test_frames_match_jax(z, frames, f):
    s, c = frames[f]
    jf = _sub(z, f"frame.{f}.")
    assert dataclasses.asdict(c) == dataclasses.asdict(
        _config(jf["config_json"]))
    np.testing.assert_array_equal(_np(s.pair_count), jf["pair_count"])
    if f in FORCED:
        assert int(s.pair_count[3]) == FORCED[f]
    _layout_equal(s, jf, f"frame {f}")
    np.testing.assert_allclose(_np(s.bodies.poses.translation),
                               jf["translation"], rtol=0,
                               atol=TRANSLATION_ATOL)
    _assert_static_layout(s, c)


@pytest.mark.parametrize("case", ["narrow", "overflow"])
def test_tail_cases_match_jax(z, case):
    """``narrow``: classes past their rungs go to the tail. ``overflow``:
    the tail outgrows its segment, so the pair count turns negative with
    magnitude at least ΣW + tail + 256, and the checked frame regrows the
    capacity (and the broad phase's budgets, as for any negative count)."""
    jc = _sub(z, f"{case}.")
    c_in = _config(jc["config_in"])
    s = step(_warmed(z), SimParams(), c_in)
    np.testing.assert_array_equal(_np(s.pair_count), jc["pair_count"])
    _layout_equal(s, jc, case)
    w = sum(c_in.gs_windows[:c_in.max_colors])
    tail = int(_np(s.bp_pairs.valid)[w:].sum())
    assert tail > 0
    count = int(s.pair_count[0])
    if case == "overflow":
        assert tail == c_in.pair_capacity - w
        assert count < 0 and -count >= w + tail + 256
    else:
        assert count > 0
    s2, c2 = step_checked(_warmed(z), SimParams(), c_in)
    assert dataclasses.asdict(c2) == dataclasses.asdict(
        _config(jc["checked.config_json"]))
    np.testing.assert_array_equal(_np(s2.pair_count),
                                  jc["checked.pair_count"])
    _assert_static_layout(s2, c2)


def test_static_matches_dynamic_pair_slots():
    """``test_gs_chained.py``'s A/B on the port: 30 checked frames of
    ``balls(256)`` from the built scene with static and with dynamic pair
    slots (no residue at 16 colours) agree within 1e-5 m."""
    params = SimParams()
    base = PipelineConfig(pair_capacity=4096, contact_capacity=2048,
                          max_colors=16, manifold_points=1, bp_algo="grid",
                          bp_slack=0.03, gs_cmax=2048,
                          gs_windows=(128,) * 16, gs_chained=True,
                          gs_rhs_in_rung=True, gs_pair_slots=True)
    sa, ca = balls(256, device="cpu"), base
    sb, cb = balls(256, device="cpu"), dataclasses.replace(
        base, gs_static_slots=True)
    for _ in range(30):
        sa, ca = step_checked(sa, params, ca)
        sb, cb = step_checked(sb, params, cb)
    err = float((sa.bodies.poses.translation
                 - sb.bodies.poses.translation).abs().max())
    assert err < TRANSLATION_ATOL, err
    _assert_static_layout(sb, cb)
    assert sa.bp_colors[3] == 1
    # forced refresh stays healthy
    sb, _ = step_checked(sb, params, dataclasses.replace(cb, bp_force="miss"))
    for _ in range(3):
        sb, cb = step_checked(sb, params, cb)
    assert torch.isfinite(sb.bodies.poses.translation).all()
    _assert_static_layout(sb, cb)


def test_cache_refreshes_on_another_layout(z):
    """A cache written under dynamic pair slots, or under static slots on
    another ladder, refreshes (broad-phase path 2); under the same ladder
    the next frame may hit."""
    s0 = _warmed(z)
    cfg = _config(z["config_json"])
    assert s0.bp_colors[3] == _flag(cfg)
    params = SimParams()
    same = step(s0, params, cfg)
    assert int(same.pair_count[3]) in (0, 1)
    dyn = step(s0, params, dataclasses.replace(cfg, gs_static_slots=False))
    assert int(dyn.pair_count[3]) == 2 and dyn.bp_colors[3] == 1
    back = step(dyn, params, cfg)
    assert int(back.pair_count[3]) == 2 and back.bp_colors[3] == _flag(cfg)
    # the same sum (so static placement stays on), another ladder
    w = cfg.gs_windows
    assert w[0] != w[1]
    other = dataclasses.replace(cfg, gs_windows=(w[1], w[0]) + w[2:])
    moved = step(s0, params, other)
    assert int(moved.pair_count[3]) == 2
    assert moved.bp_colors[3] == _flag(other) != _flag(cfg)


def test_regrow_keeps_room_for_the_ladder(z):
    """``step_checked`` grows ``pair_capacity`` to the bucket of ΣW + 256
    under the flag with a ladder, after this frame's rung regrow; a
    capacity below it runs the dynamic layout for that frame."""
    cfg = dataclasses.replace(_config(z["config_json"]), pair_capacity=1024)
    s = _warmed(z)
    got = step(s, SimParams(), cfg)
    assert got.bp_colors[3] == 1
    s2, c2 = step_checked(s, SimParams(), cfg)
    w = sum(c2.gs_windows[:c2.max_colors])
    assert c2.pair_capacity >= w + 256
    _assert_static_layout(s2, c2)


def test_pit_reference_has_static_placement_on():
    """The settled 10k pit's stored ``chained_ss`` configuration and
    frames: static placement on (capacity, flag), the tail rows counted."""
    zp = {k[len("pit."):]: v for k, v in load_arrays(NPZ).items()
          if k.startswith("pit.")}
    cfg = _config(zp["config_json"])
    assert cfg.gs_static_slots and cfg.gs_pair_slots and cfg.gs_chained
    for f in range(3):
        c = _config(zp[f"ref.{f}.config_json"])
        assert c.pair_capacity >= sum(c.gs_windows[:c.max_colors]) + 256
        assert int(zp[f"ref.{f}.slot_flag"]) == _flag(c) != 1
        assert int(zp[f"ref.{f}.tail_rows"]) >= 0
        assert zp[f"ref.{f}.offset"].shape == (10_005, 3)
