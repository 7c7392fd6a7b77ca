"""Time ``step_checked`` on the settled 10k ball pit under its stored
``chained_ps`` configuration, for the source tree given as the argument.

Six warm frames, then 50 frames timed one by one on the host clock with a
device synchronise after each; prints the mean, and the median and minimum
of the cache-hit frames and the median of the repair frames, with the final
kinetic-energy proxy (equal bits mean equal physics). To compare two
commits on one card, unpack the other commit beside this one
(``git archive``) and run both in turns within one command::

    python3 scripts/time_pit10k_step.py .            # this tree
    python3 scripts/time_pit10k_step.py path/to/other/tree
"""

from __future__ import annotations

import json
import os
import sys
import time

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else ".")
sys.path.insert(0, TREE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wgmath_tpu_torch.convert import state_from_arrays  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import (  # noqa: E402
    PipelineConfig,
    step_checked,
)

WARM_FRAMES, TIMED_FRAMES = 6, 50


def main() -> int:
    if not torch.cuda.is_available():
        print("time_pit10k_step: needs a CUDA device", file=sys.stderr)
        return 1
    z = dict(np.load(os.path.join(TREE, "artifacts",
                                  "ball_pit10k_settled.npz")))
    cfg = PipelineConfig.from_dict(json.loads(str(z["config_json"])))
    state, params = state_from_arrays(z, device="cuda"), SimParams()
    for _ in range(WARM_FRAMES):
        state, cfg = step_checked(state, params, cfg)
    torch.cuda.synchronize()
    frames = []
    for _ in range(TIMED_FRAMES):
        t0 = time.perf_counter()
        state, cfg = step_checked(state, params, cfg)
        torch.cuda.synchronize()
        frames.append((1e3 * (time.perf_counter() - t0),
                       int(state.pair_count[3])))
    hit = sorted(t for t, path in frames if path == 0)
    repair = sorted(t for t, path in frames if path == 1)
    ke = float((state.bodies.vels.linear ** 2).sum())
    print(f"{TREE}: {torch.cuda.get_device_name(0)}; mean "
          f"{sum(t for t, _ in frames) / TIMED_FRAMES:.2f} ms/step; "
          f"{len(hit)} hit frames median {hit[len(hit) // 2]:.2f} min "
          f"{hit[0]:.2f}; {len(repair)} repair frames median "
          f"{repair[len(repair) // 2] if repair else float('nan'):.2f}; "
          f"KE proxy {ke:.6f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
