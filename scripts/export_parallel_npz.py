"""Export the JAX package's sharded steps and the conveyor scene as a
JAX-free file: ``artifacts/parallel_jax.npz.xz``
(``export_box_npz.savez_xz``), read by ``tests/test_torch_parallel.py``,
``tests/test_torch_testbed.py`` and ``chip_smoke.py``.

The JAX runs are ``tests/test_parallel.py``'s, on the virtual 8-device CPU
mesh (``xla_force_host_platform_device_count=8``):

- ``full``: ``balls(192)`` warmed by 25 ``step`` frames under the full
  pipeline's configuration (grid broad phase, ``bp_slack`` 0.03,
  ``gs_cmax`` 256, uniform windows), then 6 frames of
  ``parallel.sharded_pipeline.make_sharded_step`` on the 8-device mesh;
- ``ladder``: the same with the window ladder ``(128,) * 12``, 5 frames;
- ``joints``: ``pendulum_chain(6, "spherical")`` warmed by 5 frames, then
  5 sharded frames;
- ``round1``: ``balls(63)`` (the built state), one frame of the round-1
  body-sharded step (``parallel.sharded``) on the 8-device mesh;
- ``conveyor3``: ``SCENES["conveyor3"]`` as built, and 3 ``step_checked``
  frames under the testbed's configuration
  (``testbed.runner.BackendConfig().pipeline_config``).

Each case stores its warmed state (``<case>.state.*``, as
``convert.state_to_arrays`` lays it out, with the ``prev_constraints``
fields a step does not read zeroed), its configuration as JSON and each
frame's translations and pair counts (``<case>.frame<f>.*``); ``full``
and ``ladder`` also the broad-phase cache pairs after their last frame.
About two minutes on the CPU::

    python scripts/export_parallel_npz.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import numpy as np  # noqa: E402

from export_box_npz import savez_xz, slim  # noqa: E402
from wgmath_tpu.dynamics import SimParams  # noqa: E402
from wgmath_tpu.parallel import body_mesh, shard_state  # noqa: E402
from wgmath_tpu.parallel import sharded  # noqa: E402
from wgmath_tpu.parallel.sharded_pipeline import (  # noqa: E402
    make_sharded_step,
    replicate_state,
)
from wgmath_tpu.pipeline import (  # noqa: E402
    PipelineConfig,
    auto_manifold_points,
    step,
    step_checked,
)
from wgmath_tpu.scenes import builders  # noqa: E402
from wgmath_tpu.testbed.runner import BackendConfig  # noqa: E402
from wgmath_tpu_torch.convert import state_to_arrays  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "parallel_jax.npz.xz")
N_DEV = 8
FULL = dict(pair_capacity=2048, contact_capacity=1024, max_colors=12,
            gs_cmax=256, bp_slack=0.03, bp_algo="grid", manifold_points=1)
LADDER = dict(FULL, gs_windows=(128,) * 12)
JOINTS = dict(pair_capacity=256, max_colors=8, manifold_points=1)
ROUND1 = dict(pair_capacity=2048, max_colors=8, max_per_body=16,
              broad_phase_block=64)
CASES = {"full": (FULL, 25, 6), "ladder": (LADDER, 25, 5),
         "joints": (JOINTS, 5, 5)}


def _cfg_json(cfg: PipelineConfig) -> np.ndarray:
    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def _state(prefix: str, st, arrays: dict) -> None:
    for k, v in slim(state_to_arrays(st)).items():
        arrays[f"{prefix}.state.{k}"] = v


def _frame(prefix: str, f: int, st, arrays: dict) -> None:
    arrays[f"{prefix}.frame{f}.translation"] = np.asarray(
        st.bodies.poses.translation, np.float32)
    arrays[f"{prefix}.frame{f}.pair_count"] = np.asarray(st.pair_count,
                                                         np.int32)


def export_sharded(name: str, arrays: dict) -> None:
    kw, warm, frames = CASES[name]
    params = SimParams()
    cfg = PipelineConfig(**kw)
    st = (builders.pendulum_chain(6, joint="spherical") if name == "joints"
          else builders.balls(192, dim=3))
    for f in range(warm):
        st = step(st, params, cfg, warmstart=f > 0)
    _state(name, st, arrays)
    arrays[f"{name}.config_json"] = _cfg_json(cfg)
    mesh = body_mesh(N_DEV)
    sstep = make_sharded_step(mesh, params, cfg, n_steps=1)
    sh = replicate_state(st, mesh)
    for f in range(frames):
        sh = sstep(sh)
        _frame(name, f, sh, arrays)
    if sh.bp_pairs is not None:
        arrays[f"{name}.bp_pairs"] = np.stack([
            np.asarray(sh.bp_pairs.body_a), np.asarray(sh.bp_pairs.body_b),
            np.asarray(sh.bp_pairs.valid).astype(np.int32)]).astype(np.int32)


def export_round1(arrays: dict) -> None:
    params = SimParams()
    cfg = PipelineConfig(**ROUND1)
    st = builders.balls(63, dim=3)
    _state("round1", st, arrays)
    arrays["round1.config_json"] = _cfg_json(cfg)
    mesh = body_mesh(N_DEV)
    bodies, shapes = shard_state(st, mesh)
    out, count = sharded.make_sharded_step(mesh, params, cfg)(bodies,
                                                              shapes)
    n = st.bodies.num_bodies
    arrays["round1.frame0.translation"] = np.asarray(
        out.poses.translation, np.float32)[:n]
    arrays["round1.frame0.linear"] = np.asarray(out.vels.linear,
                                                np.float32)[:n]
    arrays["round1.frame0.pair_count"] = np.asarray(int(count), np.int32)


def export_conveyor(arrays: dict) -> None:
    params = SimParams.tgs_soft()
    st = builders.SCENES["conveyor3"]()
    cfg = BackendConfig().pipeline_config(
        manifold_points=auto_manifold_points(st.shapes, 3))
    _state("conveyor3", st, arrays)
    arrays["conveyor3.config_json"] = _cfg_json(cfg)
    for f in range(3):
        st, cfg = step_checked(st, params, cfg)
        _frame("conveyor3", f, st, arrays)
    arrays["conveyor3.final_config_json"] = _cfg_json(cfg)


def main():
    t0 = time.time()
    assert len(jax.devices()) >= N_DEV
    arrays = {}
    for name in CASES:
        export_sharded(name, arrays)
        print(f"{name}: {time.time() - t0:.0f} s", flush=True)
    export_round1(arrays)
    export_conveyor(arrays)
    savez_xz(OUT, arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e3:.1f} kB, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
