"""Export the JAX package's ``pipeline.multi_step`` on small 3D scenes as a
JAX-free file, ``artifacts/multi_step_jax.npz.xz``
(``export_box_npz.savez_xz``), read by ``tests/test_torch_multi_step.py``.

``multi_step(state, params, config, n)`` runs one burn-in ``step`` when
the state does not fit the configuration's carry, then ``n`` frames. One
case a branch of that gate (``CASES``): the input state, the
configuration, ``n``, JAX's result and the number of frames JAX ran.

- ``state.<s>.*``: the input states (``convert.state_to_arrays``):
  ``cold`` is ``balls(20)`` as built; ``plain``, ``cmax``, ``windows``
  are it after ``WARM_FRAMES`` frames of ``step_checked`` under the
  configuration of that name; ``mesh`` is ``trimesh_scene(9)`` after
  ``MESH_WARM_FRAMES`` frames under ``mesh``. A case whose state is
  ``cmax-`` is ``cmax`` without its cached colours (``bp_colors`` None,
  the state a slack without a class cap leaves).
- ``config.<c>``: the configurations as JSON (warmed ones as
  ``step_checked`` left them).
- ``case.<name>.{state,config,n_steps,frames,translation,pair_count}``:
  ``frames`` is n or n + 1, found by holding JAX's ``multi_step`` against
  JAX's own loops of ``step`` with and without the burn-in frame (the one
  within ``MATCH`` m, the other at least ``APART`` m away);
  ``translation`` / ``pair_count`` are JAX's ``multi_step`` result.

Runs on the CPU (~5 min, most of it JAX compiles)::

    JAX_PLATFORMS=cpu python scripts/export_multi_step_npz.py
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
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import numpy as np  # noqa: E402

from export_box_npz import savez_xz  # noqa: E402
from wgmath_tpu.dynamics import SimParams  # noqa: E402
from wgmath_tpu.pipeline import (  # noqa: E402
    PipelineConfig,
    multi_step,
    new_state,
    step,
    step_checked,
)
from wgmath_tpu_torch.convert import state_to_arrays  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "multi_step_jax.npz.xz")
N_BALLS = 20
N_MESH_BALLS = 9
WARM_FRAMES = 20
MESH_WARM_FRAMES = 60
N = 3
MATCH = 1e-5
APART = 1e-3
BASE = dict(pair_capacity=256, max_colors=8, manifold_points=1)
CONFIGS = {
    "plain": BASE,
    "cmax": dict(BASE, bp_slack=0.05, gs_cmax=256),
    "capacity": dict(BASE, bp_slack=0.05, gs_cmax=256, pair_capacity=512),
    "windows": dict(BASE, gs_cmax=256, gs_windows=(64,) * 8),
    "mesh": dict(BASE, pair_capacity=128, bp_slack=0.05, gs_cmax=256,
                 mesh_pair_capacity=16),
}
# name -> (input state, configuration, n_steps, the gate's branch)
CASES = {
    "cold": ("cold", "plain", N, "no prev_constraints: burn-in"),
    "warm": ("plain", "plain", N, "fits: no burn-in"),
    "warm_cmax": ("cmax", "cmax", N, "coloured cache fits: no burn-in"),
    "warm_windows": ("windows", "windows", N, "ladder counts fit"),
    "no_bp_colors": ("cmax-", "cmax", N,
                     "colours ride the cache, bp_colors None: burn-in"),
    "other_capacity": ("cmax", "capacity", N,
                       "cache at another pair_capacity: burn-in"),
    "windows_on_8_counts": ("plain", "windows", N,
                            "8 counts under gs_windows: burn-in"),
    "ladder_counts_plain": ("windows", "plain", N,
                            "ladder counts without gs_windows: burn-in"),
    "slack0_with_cache": ("cmax", "plain", N,
                          "bp_slack 0 with a cache: burn-in"),
    "mesh_slack": ("mesh", "mesh", N,
                   "mesh under bp_slack and gs_cmax: no colours, "
                   "no burn-in"),
    "n0_cold": ("cold", "plain", 0, "n_steps 0 on a cold state"),
    "n0_warm": ("plain", "plain", 0, "n_steps 0 on a warmed state"),
}


def _config(name: str) -> PipelineConfig:
    return PipelineConfig(**CONFIGS[name])


def _json(cfg: PipelineConfig) -> np.ndarray:
    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def _tr(state) -> np.ndarray:
    return np.asarray(state.bodies.poses.translation)


def _loop(state, params, cfg, n: int, burn_in: bool):
    s = state
    if burn_in:
        s = step(s, params, cfg, warmstart=s.prev_constraints is not None)
    for _ in range(n):
        s = step(s, params, cfg, warmstart=True)
    return s


def main() -> None:
    from wgmath_tpu.scenes.builders import balls, trimesh_scene

    t0 = time.time()
    params = SimParams()
    arrays: dict = {}
    built = balls(N_BALLS)
    states = {"cold": new_state(built.bodies, built.shapes)}
    configs = {}
    for name in ("plain", "cmax", "windows"):
        s, c = states["cold"], _config(name)
        for _ in range(WARM_FRAMES):
            s, c = step_checked(s, params, c)
        states[name], configs[name] = s, c
        print(f"warmed {name}: pair_count {np.asarray(s.pair_count)[:5]} "
              f"({time.time() - t0:.0f} s)", flush=True)
    mesh = trimesh_scene(N_MESH_BALLS)
    s, c = new_state(mesh.bodies, mesh.shapes), _config("mesh")
    for _ in range(MESH_WARM_FRAMES):
        s, c = step_checked(s, params, c)
    states["mesh"], configs["mesh"] = s, c
    assert s.bp_pairs is not None and s.bp_colors is None
    print(f"warmed mesh: pair_count {np.asarray(s.pair_count)[:5]} "
          f"({time.time() - t0:.0f} s)", flush=True)
    configs.setdefault("capacity", _config("capacity"))
    for name, cfg in configs.items():
        arrays[f"config.{name}"] = _json(cfg)
    for name, st in states.items():
        for k, v in state_to_arrays(st).items():
            arrays[f"state.{name}.{k}"] = v

    states["cmax-"] = dataclasses.replace(states["cmax"], bp_colors=None)
    for case, (sname, cname, n, what) in CASES.items():
        st, cfg = states[sname], configs[cname]
        out = multi_step(st, params, cfg, n)
        got = _tr(out)
        d = {b: float(np.abs(got - _tr(_loop(st, params, cfg, n, b))).max())
             for b in (False, True)}
        burn = d[True] < d[False]
        assert d[burn] <= MATCH and d[not burn] >= APART, (case, d)
        p = f"case.{case}"
        arrays[f"{p}.state"] = np.asarray(sname)
        arrays[f"{p}.config"] = np.asarray(cname)
        arrays[f"{p}.n_steps"] = np.asarray(n)
        arrays[f"{p}.frames"] = np.asarray(n + int(burn))
        arrays[f"{p}.translation"] = got
        arrays[f"{p}.pair_count"] = np.asarray(out.pair_count, np.int32)
        print(f"{case} ({what}): {n + int(burn)} frames for n = {n}; "
              f"|dp| to the loop with burn-in {d[True]:.3e}, without "
              f"{d[False]:.3e} ({time.time() - t0:.0f} s)", flush=True)
    savez_xz(OUT, arrays)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes, {len(arrays)} arrays "
          f"({time.time() - t0:.0f} s)")


if __name__ == "__main__":
    main()
