"""Export the JAX package's steps of the 160-ball pit that the port's
whole-step CPU tests compare against, as a JAX-free ``.npz``:
``artifacts/pit160_jax.npz``.

Three groups, one per test file, each warmed from ``ball_pit(160)`` by 30
JAX frames under one fixed scaled-down configuration (budgets and rungs
that hold the whole scene, so the warmup never regrows):

- ``chained_ps`` (``tests/test_torch_pipeline.py``): the warmed state, then
  ten ``step_checked`` frames, frame 3 forcing a full broad-phase refresh
  and frame 6 a repair. Frame 0 is kept whole (``frame.0.*``, with its
  configuration); frames 1-9 keep counts, translations and velocities.
- ``ladder`` (``tests/test_torch_pipeline_ladder.py``): the warmed state,
  then one step of each of ``ladder``, ``chained``, ``chained_rr`` and
  ``ladder_cc0`` from it (``step.<name>.*``, whole states).
- ``fused`` (``tests/test_torch_pipeline_fused.py``): the warmed state
  (``gs_cmax`` 48, so a residue class), one step from it (``step.*``), and
  two ``step_checked`` frames from it with every rung cut to 8
  (``regrow.<f>.{pair_count,config_json}``).

Each group's warmed state is ``<group>.warmed.*`` (``state_to_arrays``
names) and its configuration ``<group>.config_json``. A step from the
warmed state passes ``warmstart=True``, as the warmup's later frames do.
Runs on the CPU (a few minutes)::

    JAX_PLATFORMS=cpu python scripts/export_pit160_npz.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import numpy as np  # noqa: E402

from wgmath_tpu.dynamics import SimParams  # noqa: E402
from wgmath_tpu.pipeline import PipelineConfig, step, step_checked  # noqa: E402
from wgmath_tpu.scenes.builders import ball_pit  # noqa: E402
from wgmath_tpu_torch.convert import state_to_arrays  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "pit160_jax.npz")
WARM_FRAMES = 30
BASE = dict(pair_capacity=2048, contact_capacity=1024, bp_slack=0.03,
            bp_algo="grid", manifold_points=1)
CONFIGS = {
    "chained_ps": dict(BASE, max_colors=16, gs_cmax=512,
                       gs_windows=(256,) * 16, gs_chained=True,
                       gs_rhs_in_rung=True, gs_pair_slots=True),
    "ladder": dict(BASE, max_colors=16, gs_cmax=512, gs_windows=(256,) * 16),
    "fused": dict(BASE, max_colors=12, gs_cmax=48, gs_rung_quantum=32,
                  gs_windows=(32,) * 12, gs_fused=True, gs_rung0=256),
}
# the ladder file's candidates on top of its configuration
LADDER_STEPS = {"ladder": {}, "chained": dict(gs_chained=True),
                "chained_rr": dict(gs_chained=True, gs_rhs_in_rung=True),
                "ladder_cc0": dict(contact_capacity=0)}


def _json(cfg) -> np.ndarray:
    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def _put(arrays: dict, prefix: str, state) -> None:
    for k, v in state_to_arrays(state).items():
        arrays[f"{prefix}.{k}"] = v


def warm(name: str, arrays: dict):
    cfg = PipelineConfig(**CONFIGS[name])
    state, params = ball_pit(160), SimParams()
    for f in range(WARM_FRAMES):
        state = step(state, params, cfg, warmstart=f > 0)
    _put(arrays, f"{name}.warmed", state)
    arrays[f"{name}.config_json"] = _json(cfg)
    return state, cfg, params


def main():
    t0 = time.time()
    arrays = {}
    state, cfg, params = warm("chained_ps", arrays)
    for f in range(10):
        force = {3: "miss", 6: "repair"}.get(f)
        state, cfg = step_checked(state, params,
                                  dataclasses.replace(cfg, bp_force=force))
        cfg = dataclasses.replace(cfg, bp_force=None)
        if f == 0:
            _put(arrays, "chained_ps.frame.0", state)
            arrays["chained_ps.frame.0.config_json"] = _json(cfg)
        for k, v in (("pair_count", state.pair_count),
                     ("translation", state.bodies.poses.translation),
                     ("linear", state.bodies.vels.linear),
                     ("angular", state.bodies.vels.angular)):
            arrays[f"chained_ps.frame.{f}.{k}"] = np.asarray(v)
    print(f"chained_ps done ({time.time() - t0:.0f} s)", flush=True)

    state, cfg, params = warm("ladder", arrays)
    for name, change in LADDER_STEPS.items():
        _put(arrays, f"ladder.step.{name}",
             step(state, params, dataclasses.replace(cfg, **change),
                  warmstart=True))
    print(f"ladder done ({time.time() - t0:.0f} s)", flush=True)

    state, cfg, params = warm("fused", arrays)
    _put(arrays, "fused.step", step(state, params, cfg, warmstart=True))
    js, jc = state, dataclasses.replace(
        cfg, gs_windows=(8,) * cfg.max_colors, gs_rung0=8)
    for f in range(2):
        js, jc = step_checked(js, params, jc)
        arrays[f"fused.regrow.{f}.pair_count"] = np.asarray(js.pair_count)
        arrays[f"fused.regrow.{f}.config_json"] = _json(jc)
    print(f"fused done ({time.time() - t0:.0f} s)", flush=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
