"""``pipeline.multi_step`` in the port against the JAX package's, one case a
branch of its burn-in gate, from the results that
``scripts/export_multi_step_npz.py`` stores in
``artifacts/multi_step_jax.npz.xz`` (so this file makes no JAX step).

A state that does not fit the configuration's carry takes one burn-in
frame first, so ``multi_step(state, params, config, n)`` advances n or
n + 1 frames; a gate that fires where JAX's does not (or the reverse) is
a frame more (or fewer). Each case holds the port to the number of frames
JAX ran (stored beside its result): the port's ``multi_step`` equals its
own loop of that many ``step`` calls bit for bit (``torch.equal``), and
JAX's result within 1e-5 m on the translations (XLA on the CPU contracts
``a*b+c`` into one rounding where PyTorch rounds the product, ROADMAP C4)
with every count exact.

Scenes: ``balls(27)`` as built (``cold``) and after 20 frames under each
configuration (the one with cached colours also without them), and
``trimesh_scene(16)`` after 60 frames under a slack and a class cap (a
mesh keeps the colours off the cache, so no burn-in)."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from wgmath_tpu_torch import pipeline
from wgmath_tpu_torch.convert import load_arrays, state_from_arrays
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, multi_step, step
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "multi_step_jax.npz.xz")
# case -> frames JAX ran for its n_steps (also stored; here so that a
# rewritten file that changes them fails)
CASES = {
    "cold": 4,
    "warm": 3,
    "warm_cmax": 3,
    "warm_windows": 3,
    "no_bp_colors": 4,
    "other_capacity": 4,
    "windows_on_8_counts": 4,
    "ladder_counts_plain": 4,
    "slack0_with_cache": 4,
    "mesh_slack": 3,
    "n0_cold": 1,
    "n0_warm": 0,
}
TR_ATOL = 1e-5


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def _sub(z, prefix):
    return {k[len(prefix):]: v for k, v in z.items() if k.startswith(prefix)}


def _case(z, case):
    """(a fresh copy of the input state, the configuration, n_steps). A
    state name ending in ``-`` is the stored state without its cached
    colours."""
    p = f"case.{case}."
    name = str(z[p + "state"])
    state = state_from_arrays(_sub(z, f"state.{name.rstrip('-')}."),
                              device="cpu")
    if name.endswith("-"):
        state = dataclasses.replace(state, bp_colors=None)
    cfg = PipelineConfig.from_dict(json.loads(str(
        z[f"config.{z[p + 'config']}"])))
    return state, cfg, int(z[p + "n_steps"])


def _loop(state, cfg, frames: int, n_steps: int):
    """``frames`` frames of ``step``: the first one a burn-in where
    ``frames`` is ``n_steps + 1``."""
    params = SimParams()
    if frames > n_steps:
        state = step(state, params, cfg,
                     warmstart=state.prev_constraints is not None)
    for _ in range(n_steps):
        state = step(state, params, cfg, warmstart=True)
    return state


def _tensors(state):
    b = state.bodies
    return (b.poses.translation, b.poses.rotation, b.vels.linear,
            b.vels.angular, state.pair_count)


@pytest.mark.parametrize("case", list(CASES))
def test_multi_step_matches_jax(z, case):
    p = f"case.{case}."
    frames = int(z[p + "frames"])
    state, cfg, n = _case(z, case)
    assert frames == CASES[case]
    assert frames in (n, n + 1)
    got = multi_step(state, SimParams(), cfg, n)
    np.testing.assert_array_equal(got.pair_count.numpy(),
                                  z[p + "pair_count"])
    np.testing.assert_allclose(got.bodies.poses.translation.numpy(),
                               z[p + "translation"], rtol=0, atol=TR_ATOL)
    want = _loop(_case(z, case)[0], cfg, frames, n)
    for g, w in zip(_tensors(got), _tensors(want)):
        assert torch.equal(g, w)
    # the other frame count lands elsewhere: the case tells them apart
    other = _loop(_case(z, case)[0], cfg, 2 * n + 1 - frames, n)
    assert not torch.equal(other.bodies.poses.translation,
                           got.bodies.poses.translation)


def test_step_and_multi_step_share_the_colour_gate(z, monkeypatch):
    """Both read ``pipeline._color_gate``: a warmed state that fits runs
    one gate in ``multi_step`` and one in each ``step``."""
    calls = []
    gate = pipeline._color_gate

    def counted(shapes, config):
        calls.append(config)
        return gate(shapes, config)

    monkeypatch.setattr(pipeline, "_color_gate", counted)
    state, cfg, _ = _case(z, "warm_cmax")
    multi_step(state, SimParams(), cfg, 2)
    assert len(calls) == 3 and all(c is cfg for c in calls)


def test_multi_step_raises_where_step_raises(z):
    state, cfg, _ = _case(z, "warm")
    bad = PipelineConfig.from_dict(dict(json.loads(str(z["config.plain"])),
                                        bp_algo="sap"))
    with pytest.raises(NotImplementedError, match="bp_algo=sap"):
        step(state, SimParams(), bad)
    with pytest.raises(NotImplementedError, match="bp_algo=sap"):
        multi_step(state, SimParams(), bad, 2)
