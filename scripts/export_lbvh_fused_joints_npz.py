"""Export the JAX package's frames for the LBVH broad phase and the fused
solver with joints as a JAX-free file:
``artifacts/lbvh_fused_joints_jax.npz.xz`` (``export_box_npz.savez_xz``),
read by ``tests/test_torch_pipeline_fused_joints.py``, ``chip_smoke.py``
and ``tests/test_torch_cuda.py``.

Cases (``<case>.*``, laid out as ``scripts/export_joints_npz.py`` lays out
its small cases: the warmed state, the joints, the configuration, the
``SimParams``, the next 3 ``step_checked`` frames and, for the drape and
the chain, the whole states after frames 0 and 1):

- ``drape_fused``: ``tests/test_joints.py``'s drape scene (a five-ball
  chain anchored 1.2 m up over a ground slab) under that test's ladder
  configuration with ``gs_fused=True`` and a residue rung of 64, warmed
  by 40 frames (``step``, no warmstart on the first);
- ``chain_fused``: ``SCENES["joint_ball3"]`` (a chain of spherical
  joints, no contacts) under the same fused configuration, warmed by 20
  ``step_checked`` frames;
- ``net16_fused``: ``SCENES["ball_net3"]`` (``ball_net3(16, 16)``, 256
  balls in 480 joints over a dome) warmed by 40 ``step_checked`` frames
  under ``PipelineConfig()``, then stepped under the drape's fused
  configuration with every rung cut to 8: the first checked frame
  regrows the pair capacity, the next two the rungs and the residue
  rung;
- ``lbvh_balls``: ``balls(128)`` dropped for 60 frames under the brute
  force (``tests/test_lbvh.py``'s pipeline test), then stepped one frame
  under ``PipelineConfig(pair_capacity=2048, max_colors=8,
  bp_algo="lbvh")``.

Runs on the CPU in about six minutes, mostly JAX compiles::

    JAX_PLATFORMS=cpu python scripts/export_lbvh_fused_joints_npz.py
"""

from __future__ import annotations

import dataclasses
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

from export_box_npz import savez_xz, slim  # noqa: E402
from export_joints_npz import (  # noqa: E402
    CHAIN_WARM,
    DRAPE_BASE,
    DRAPE_WARM,
    NET16_WARM,
    drape_scene,
    export_case,
)
from wgmath_tpu.dynamics import SimParams  # noqa: E402
from wgmath_tpu.pipeline import PipelineConfig, step, step_checked  # noqa: E402
from wgmath_tpu.scenes import builders  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "lbvh_fused_joints_jax.npz.xz")
FUSED_JOINTS = dict(DRAPE_BASE, gs_fused=True, gs_rung0=64)
# every rung cut to 8: the first checked frame regrows them
FUSED_JOINTS_SMALL = dict(FUSED_JOINTS, gs_windows=(8,) * 4, gs_rung0=8)
LBVH_DROP = 60
LBVH_CFG = dict(pair_capacity=2048, max_colors=8)


def main():
    t0 = time.time()
    arrays = {}
    params = SimParams()
    cfg = PipelineConfig(**FUSED_JOINTS)
    st = drape_scene()
    for f in range(DRAPE_WARM):
        st = step(st, params, cfg, warmstart=f > 0)
    export_case("drape_fused", st, params, cfg, arrays, t0)

    st = builders.SCENES["joint_ball3"]()
    for _ in range(CHAIN_WARM):
        st, cfg = step_checked(st, params, cfg)
    export_case("chain_fused", st, params, cfg, arrays, t0)

    st, cfg = builders.SCENES["ball_net3"](), PipelineConfig()
    for _ in range(NET16_WARM):
        st, cfg = step_checked(st, params, cfg)
    export_case("net16_fused", st, params,
                PipelineConfig(**FUSED_JOINTS_SMALL), arrays, t0,
                keep_states=False)

    st = builders.balls(128, dim=3)
    brute = PipelineConfig(bp_algo="brute", **LBVH_CFG)
    for f in range(LBVH_DROP):
        st = step(st, params, brute, warmstart=f > 0)
    export_case("lbvh_balls", st, params,
                dataclasses.replace(brute, bp_algo="lbvh"), arrays, t0,
                keep_states=False, frames=1)
    savez_xz(OUT, slim(arrays))
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e3:.1f} kB, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
