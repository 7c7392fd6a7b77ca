"""Export JAX reference frames of the box scenes as JAX-free ``.npz`` files
for the PyTorch port.

Each scene is stepped by the JAX package on the CPU under two
configurations (``wgmath_tpu_torch.scenes.builders.box_configs``), the JAX
package's own 4-point recipe of
``tests/test_gs_fused.py::test_pipeline_gs_fused_boxes_p4`` with the
budgets of ``scripts/run_pyramid43k.py``:

- ``ladder``: grid broad phase with its slack cache (``bp_slack`` 0.03),
  cached pair colours (``max_colors`` 24, ``gs_cmax`` 8192), colour-major
  contact compaction, SAT pairs compacted (``sat_pair_capacity``),
  ball-cuboid pairs compacted (``bc_pair_capacity`` 256), the grid budgets
  216 / 16 / 32 / 128, ``manifold_points`` 4 and 24 windows of 256;
- ``fused``: the same with ``gs_fused`` and a residue rung of 256.

``pair_capacity``, ``contact_capacity`` and ``sat_pair_capacity`` are
seeded from the body count (6, 3 and 6 a body, as the 43k script's
262,144 / 131,072 / 131,072 are), with ``sat_pair_capacity`` at least 256.
For each configuration, ``step_checked`` steps the scene from its first
state for the scene's warm frames (the pyramids' 0.01 m gaps between
levels close in ~11 frames, the lattice of ``boxes_and_balls`` lands in
~20), which also grows the capacities; the warmed state is kept as
``<scene>.<config>.state.*`` (``state_to_arrays`` names: 4-wide
``prev_constraints``, the broad-phase cache, the colours and the solve
bundle) with the warmed configuration as ``<scene>.<config>.config_json``.
Then ``REF_FRAMES`` reference frames from the warmed state:
``<scene>.<config>.ref.<f>.{translation,linear,angular,pair_count,
config_json}``. For ``pyramid6`` the file also holds one ``step_checked``
frame of the ladder from its warmed state with ``sat_pair_capacity`` at
its floor of 256, below the scene's cuboid pairs:
``pyramid6.regrow.config_json`` (the configuration it starts from) and
``pyramid6.regrow.0.*`` (the regrown configuration and the counts).
``<scene>.builder`` names the builder call. In the card file the fields
of ``prev_constraints`` that a step does not read (all but the warmstart's
keys and impulses, ``READ_CONSTRAINT_FIELDS``) are zeros, so it stays
small.

``artifacts/boxes_small.npz`` (``pyramid(6)``, ``boxes_and_balls(64)``) is
what the CPU tests read; ``artifacts/pyramid20.npz`` (``pyramid(20)``,
2,871 bodies, the README's ``pyramid3``) is what ``chip_smoke.py`` holds
the card against. Reals are float32, counts int32. Runs on the CPU, the
two configurations of a scene in two processes at once (the small file
took 26 min one configuration after the other, the card file 64 min, on
an 8-core CPU)::

    JAX_PLATFORMS=cpu python scripts/export_box_npz.py [--only small|card]
"""

from __future__ import annotations

import argparse
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
from wgmath_tpu_torch.scenes.builders import box_configs  # noqa: E402

REF_FRAMES = 3
OUT = {"small": os.path.join(ROOT, "artifacts", "boxes_small.npz"),
       "card": os.path.join(ROOT, "artifacts", "pyramid20.npz")}
# scene name -> builder, its arguments and the warm frames
SCENES = {
    "small": {"pyramid6": ("pyramid", {"levels": 6}, 12),
              "bab64": ("boxes_and_balls", {"n": 64}, 30)},
    "card": {"pyramid20": ("pyramid", {"levels": 20}, 12)},
}


# the fields of ``prev_constraints`` a step reads (the warmstart's keys and
# impulses); the card file keeps the others as zeros of their shape
READ_CONSTRAINT_FIELDS = ("body_a", "body_b", "valid", "num_points",
                          "n_impulse", "n_impulse_jacobi", "t_impulse",
                          "t_impulse_jacobi")


def slim(arrays: dict) -> dict:
    """``arrays`` with every ``prev_constraints`` field a step does not read
    zeroed, so the file compresses to what the comparison needs."""
    out = {}
    for k, v in arrays.items():
        field = k.rsplit("prev_constraints.", 1)[-1]
        if "prev_constraints." in k and field not in READ_CONSTRAINT_FIELDS:
            v = np.zeros_like(v)
        out[k] = v
    return out


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


def export_config(scene: str, builder: str, kw: dict, warm: int,
                  name: str) -> dict:
    """One configuration of one scene: the warmed state, the regrow frame
    (``pyramid6`` under the ladder) and the reference frames."""
    t0 = time.time()
    arrays = {}
    state0 = getattr(builders, builder)(**kw)
    n = int(state0.bodies.poses.translation.shape[0])
    params = SimParams()
    st, cfg = state0, PipelineConfig(**box_configs(n)[name])
    for f in range(warm):
        st, cfg = step_checked(st, params, cfg)
    print(f"{scene} {name} after {warm} warm frames: pair_count[:8]="
          f"{np.asarray(st.pair_count)[:8].tolist()} "
          f"({time.time() - t0:.0f} s)", flush=True)
    for k, v in state_to_arrays(st).items():
        arrays[f"{scene}.{name}.state.{k}"] = v
    arrays[f"{scene}.{name}.config_json"] = np.asarray(_config_json(cfg))
    if scene == "pyramid6" and name == "ladder":
        small = dataclasses.replace(cfg, sat_pair_capacity=256)
        arrays[f"{scene}.regrow.config_json"] = np.asarray(
            _config_json(small))
        st1, c1 = step_checked(st, params, small)
        _frame(f"{scene}.regrow.0", st1, c1, arrays)
        print(f"{scene} regrow: sat_pair_capacity 256 -> "
              f"{c1.sat_pair_capacity}", flush=True)
    for f in range(REF_FRAMES):
        st, cfg = step_checked(st, params, cfg)
        _frame(f"{scene}.{name}.ref.{f}", st, cfg, arrays)
        drop = (np.asarray(state0.bodies.poses.translation)
                - np.asarray(st.bodies.poses.translation))[1:, 1]
        print(f"{scene} {name} reference frame {f}: pair_count[:8]="
              f"{np.asarray(st.pair_count)[:8].tolist()} drop from the "
              f"start {drop.min():.5f}..{drop.max():.5f} m "
              f"({time.time() - t0:.0f} s)", flush=True)
    return arrays


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(OUT), default=None,
                    help="write this file only (default: both)")
    only = ap.parse_args().only
    t0 = time.time()
    # each configuration in a process of its own, the two at once
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2) as pool:
        for which, path in OUT.items():
            if only not in (None, which):
                continue
            jobs = [pool.apply_async(export_config, (scene, builder, kw,
                                                     warm, name))
                    for scene, (builder, kw, warm) in SCENES[which].items()
                    for name in ("ladder", "fused")]
            arrays = {}
            for scene, (builder, kw, _) in SCENES[which].items():
                arrays[f"{scene}.builder"] = np.asarray(json.dumps([builder,
                                                                    kw]))
            for job in jobs:
                arrays.update(job.get())
            if which == "card":
                arrays = slim(arrays)
            np.savez_compressed(path, **arrays)
            print(f"wrote {path} ({os.path.getsize(path) / 1e6:.2f} MB, "
                  f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
