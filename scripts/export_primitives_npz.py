"""Export JAX reference frames of the primitive rain as a JAX-free
``.npz`` file for the PyTorch port.

``primitives3(40)`` (200 bodies, 40 of each of balls, cuboids, capsules,
cylinders and cones, and the ground: the JAX package's default size) is
stepped by the JAX package on the CPU under the two configurations of
``wgmath_tpu_torch.scenes.builders.primitive_configs``: the box scenes'
4-point ``ladder`` and ``fused`` recipes (``box_configs``) with the
support-mapped pairs compacted into ``pfm_pair_capacity`` (6 a body, at
least 256). For each configuration ``step_checked`` steps the scene from
its first state for ``WARM_FRAMES`` frames (the two lowest layers have
landed and the third lands on them: ~400 support-mapped pairs, ~65 of
them with overlapping cores, so EPA runs); the warmed state is kept as
``primitives3.<config>.state.*`` (``state_to_arrays`` names) with the
warmed configuration as ``primitives3.<config>.config_json``. Then
``REF_FRAMES`` reference frames from the warmed state:
``primitives3.<config>.ref.<f>.{translation,linear,angular,pair_count,
config_json}``, and the whole state after each but the last as
``primitives3.<config>.ref.<f>.state.*``: GJK and EPA in f32 can send a
pair an ulp apart into another simplex (ROADMAP C4), so a comparison may
start each frame from JAX's state before it. The file also holds one ``step_checked`` frame of the
ladder from its warmed state with ``pfm_pair_capacity`` at
``REGROW_CAPACITY``, below the scene's support-mapped pairs:
``primitives3.regrow.config_json`` (the configuration it starts from) and
``primitives3.regrow.0.*`` (the regrown configuration and the counts).

``artifacts/primitives3_small.npz`` is what the CPU tests
(``tests/test_torch_pipeline_primitives.py``) and ``chip_smoke.py``'s
primitives phase read. Reals are float32, counts int32. Runs on the CPU,
the two configurations in two processes at once::

    JAX_PLATFORMS=cpu python scripts/export_primitives_npz.py
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
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
from wgmath_tpu.pipeline import PipelineConfig, step_checked  # noqa: E402
from wgmath_tpu.scenes import builders  # noqa: E402
from wgmath_tpu_torch.convert import state_to_arrays  # noqa: E402
from wgmath_tpu_torch.scenes.builders import primitive_configs  # noqa: E402

SCENE = "primitives3"
PER_KIND = 40
WARM_FRAMES = 60
REF_FRAMES = 3
REGROW_CAPACITY = 32
OUT = os.path.join(ROOT, "artifacts", "primitives3_small.npz")


def _config_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def _frame(prefix: str, st, cfg, arrays: dict) -> None:
    arrays[f"{prefix}.translation"] = np.asarray(
        st.bodies.poses.translation, np.float32)
    arrays[f"{prefix}.linear"] = np.asarray(st.bodies.vels.linear, np.float32)
    arrays[f"{prefix}.angular"] = np.asarray(st.bodies.vels.angular,
                                             np.float32)
    arrays[f"{prefix}.pair_count"] = np.asarray(st.pair_count, np.int32)
    arrays[f"{prefix}.config_json"] = np.asarray(_config_json(cfg))


def export_config(name: str) -> dict:
    """One configuration: the warmed state, the regrow frame (under the
    ladder) and the reference frames."""
    t0 = time.time()
    arrays = {}
    st = builders.primitives3(PER_KIND)
    n = int(st.bodies.poses.translation.shape[0])
    params = SimParams()
    cfg = PipelineConfig(**primitive_configs(n)[name])
    for f in range(WARM_FRAMES):
        st, cfg = step_checked(st, params, cfg)
    print(f"{SCENE} {name} after {WARM_FRAMES} warm frames: pair_count[:8]="
          f"{np.asarray(st.pair_count)[:8].tolist()} "
          f"({time.time() - t0:.0f} s)", flush=True)
    for k, v in state_to_arrays(st).items():
        arrays[f"{SCENE}.{name}.state.{k}"] = v
    arrays[f"{SCENE}.{name}.config_json"] = np.asarray(_config_json(cfg))
    if name == "ladder":
        small = dataclasses.replace(cfg, pfm_pair_capacity=REGROW_CAPACITY)
        arrays[f"{SCENE}.regrow.config_json"] = np.asarray(
            _config_json(small))
        st1, c1 = step_checked(st, params, small)
        _frame(f"{SCENE}.regrow.0", st1, c1, arrays)
        print(f"{SCENE} regrow: pfm_pair_capacity {REGROW_CAPACITY} -> "
              f"{c1.pfm_pair_capacity}", flush=True)
    for f in range(REF_FRAMES):
        st, cfg = step_checked(st, params, cfg)
        _frame(f"{SCENE}.{name}.ref.{f}", st, cfg, arrays)
        if f < REF_FRAMES - 1:
            for k, v in state_to_arrays(st).items():
                arrays[f"{SCENE}.{name}.ref.{f}.state.{k}"] = v
        print(f"{SCENE} {name} reference frame {f}: pair_count[:8]="
              f"{np.asarray(st.pair_count)[:8].tolist()} "
              f"({time.time() - t0:.0f} s)", flush=True)
    return arrays


def main():
    t0 = time.time()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2) as pool:
        jobs = [pool.apply_async(export_config, (name,))
                for name in ("ladder", "fused")]
        arrays = {f"{SCENE}.builder": np.asarray(json.dumps(
            ["primitives3", {"per_kind": PER_KIND}]))}
        for job in jobs:
            arrays.update(job.get())
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
