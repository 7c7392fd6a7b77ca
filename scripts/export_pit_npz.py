"""Export the settled 10k ball pit as JAX-free ``.npz`` files for the PyTorch
port.

Loads the committed settled checkpoint through ``bench.physics_steady_setup
(10_000)`` (caches dropped as the bench drops them). For each exported
configuration of the bench it warms the configuration with six JAX
``step_checked`` frames, then runs three reference frames from the
checkpoint state under the warmed configuration.

``artifacts/ball_pit10k_settled.npz`` (the bench's ``chained_ps``) holds

- the checkpoint state as ``wgmath_tpu_torch.convert.state_to_arrays``
  named arrays,
- ``config_json``: the warmed configuration,
- ``ref.<f>.{translation,rotation,linear,angular,pair_count,config_json}``
  for reference frames f = 0, 1, 2.

``artifacts/ball_pit10k_ladder.npz`` (the bench's ``ladder``) holds the same
``config_json`` and ``ref.<f>.*`` entries and no state: the state is read
from the settled file.

``artifacts/ball_pit10k_fused.npz`` (the bench's ``fused``: the ladder with
``gs_fused=True, gs_rung0=256, gs_fused_pallas=True``; on the CPU JAX runs
the fused formulation through XLA, which ``tests/test_gs_fused.py`` holds
against the Pallas kernels in interpret mode) holds the same entries as the
ladder file, plus ``ladder_dp.<f>``: JAX's own max |dp| between its fused
and its ladder reference frame f, from the same state.

Runs on the CPU (several minutes at 10k bodies for each file)::

    JAX_PLATFORMS=cpu python scripts/export_pit_npz.py \
        [--only settled|ladder|fused]
"""

from __future__ import annotations

import argparse
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

import numpy as np  # noqa: E402

import bench  # noqa: E402
from wgmath_tpu.pipeline import step_checked  # noqa: E402
from wgmath_tpu_torch.convert import state_to_arrays  # noqa: E402

WARM_FRAMES = 6
REF_FRAMES = 3
OUT = {name: os.path.join(ROOT, "artifacts", f"ball_pit10k_{name}.npz")
       for name in ("settled", "ladder", "fused")}


def _config_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def export(name: str, state0, params, cfg, with_state: bool, t0: float,
           against=None):
    """Warm ``cfg`` from ``state0``, record the reference frames, write the
    file. ``against``: reference translations per frame of another
    configuration from the same state; the max |dp| to each is stored as
    ``ladder_dp.<f>``."""
    st = state0
    for f in range(WARM_FRAMES):
        st, cfg = step_checked(st, params, cfg)
        print(f"{name} warm frame {f}: pair_count[:5]="
              f"{np.asarray(st.pair_count)[:5].tolist()} "
              f"({time.time() - t0:.0f} s)", flush=True)
    arrays = state_to_arrays(state0) if with_state else {}
    arrays["config_json"] = np.asarray(_config_json(cfg))
    ref, c = state0, cfg
    for f in range(REF_FRAMES):
        ref, c = step_checked(ref, params, c)
        arrays[f"ref.{f}.translation"] = np.asarray(
            ref.bodies.poses.translation)
        arrays[f"ref.{f}.rotation"] = np.asarray(ref.bodies.poses.rotation)
        arrays[f"ref.{f}.linear"] = np.asarray(ref.bodies.vels.linear)
        arrays[f"ref.{f}.angular"] = np.asarray(ref.bodies.vels.angular)
        arrays[f"ref.{f}.pair_count"] = np.asarray(ref.pair_count, np.int32)
        arrays[f"ref.{f}.config_json"] = np.asarray(_config_json(c))
        if against is not None:
            dp = float(np.max(np.abs(arrays[f"ref.{f}.translation"]
                                     - against[f])))
            arrays[f"ladder_dp.{f}"] = np.asarray(dp)
            print(f"{name} frame {f}: max |dp| to the ladder {dp:.6e}",
                  flush=True)
        print(f"{name} reference frame {f}: pair_count[:5]="
              f"{np.asarray(ref.pair_count)[:5].tolist()} "
              f"({time.time() - t0:.0f} s)", flush=True)
    np.savez_compressed(OUT[name], **arrays)
    print(f"wrote {OUT[name]} ({os.path.getsize(OUT[name]) / 1e6:.2f} MB)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(OUT), default=None,
                    help="write this file only (default: all three)")
    only = ap.parse_args().only
    t0 = time.time()
    state0, params, _, ladder = bench.physics_steady_setup(10_000)
    if only in (None, "settled"):
        chained_ps = dataclasses.replace(
            ladder, gs_chained=True, gs_rhs_in_rung=True, gs_pair_slots=True)
        export("settled", state0, params, chained_ps, True, t0)
    if only in (None, "ladder"):
        export("ladder", state0, params, ladder, False, t0)
    if only in (None, "fused"):
        lad = np.load(OUT["ladder"])
        fused = dataclasses.replace(ladder, gs_fused=True, gs_rung0=256,
                                    gs_fused_pallas=True)
        export("fused", state0, params, fused, False, t0,
               against=[lad[f"ref.{f}.translation"]
                        for f in range(REF_FRAMES)])


if __name__ == "__main__":
    main()
