"""Phase timing and readback with the PyTorch port (counterpart of
``examples/core_profiling.py``): step the ``balls2`` scene with
``step_checked`` under ``PhaseTimer`` (which synchronises the device
before it reads the clock), read the positions back to the host and
print the per-phase summary. On the card by default; ``--device cpu``
runs on the CPU::

    python examples/torch_core_profiling.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from wgmath_tpu_torch.core.dispatch import resolve_device  # noqa: E402
from wgmath_tpu_torch.core.profiling import PhaseTimer, RunStats  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked  # noqa: E402
from wgmath_tpu_torch.scenes.builders import SCENES  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args().device)
    stats = RunStats()
    timer = PhaseTimer(stats)
    state = SCENES["balls2"](device=dev)
    params, config = SimParams(), PipelineConfig(pair_capacity=2048)
    with timer.phase("first frame") as held:
        state, config = step_checked(state, params, config, stats)
        held.append(state.bodies.poses.translation)
    for _ in range(5):
        with timer.phase("step") as held:
            state, config = step_checked(state, params, config, stats)
            held.append(state.bodies.poses.translation)
    pos = state.bodies.poses.translation.cpu().numpy()  # readback
    print("device:", dev)
    print("readback: first body at", pos[1].round(3))
    print(stats.summary())


if __name__ == "__main__":
    main()
