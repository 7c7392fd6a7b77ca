"""Time the 10,000-body primitive rain with the support-mapped kernel
replayed as a CUDA graph (the port's default) and run eagerly, in one
process on one card: ``primitives3(2000)`` warmed once under each
configuration (``WARM`` frames, graphs on), then ``FRAMES`` timed frames
from that state with graphs on, off, on, off (CUDA events over the frames;
each side also reports its host syncs). Run from the repository root on a
machine with the card::

    python3 scripts/exp_pfm_graph.py
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from wgmath_tpu_torch.core import dispatch  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked  # noqa: E402
narrow_phase = importlib.import_module(
    "wgmath_tpu_torch.queries.narrow_phase")
from wgmath_tpu_torch.scenes.builders import (  # noqa: E402
    primitive_configs,
    primitives3,
)

WARM = 90
FRAMES = 10
GRAPHED = narrow_phase._pfm_call  # the port's default; ``_pfm`` is eager


def timed(state, cfg, params, graphs: bool) -> tuple[float, float]:
    """ms/step and host syncs/step of ``FRAMES`` frames from ``state``."""
    narrow_phase._pfm_call = GRAPHED if graphs else narrow_phase._pfm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    syncs = dispatch.HOST_SYNCS
    start.record()
    for _ in range(FRAMES):
        state, cfg = step_checked(state, params, cfg)
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / FRAMES,
            (dispatch.HOST_SYNCS - syncs) / FRAMES)


def main() -> None:
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    params = SimParams()
    for name in ("ladder", "fused"):
        state = primitives3(2000, device="cuda")
        n = int(state.bodies.poses.translation.shape[0])
        cfg = PipelineConfig(**primitive_configs(n)[name])
        narrow_phase._pfm_call = GRAPHED
        for _ in range(WARM):
            state, cfg = step_checked(state, params, cfg)
        for graphs in (True, False, True, False):
            ms, syncs = timed(state, cfg, params, graphs)
            print(f"{name} after {WARM} frames, {FRAMES} frames, PFM graph "
                  f"{'on ' if graphs else 'off'}: {ms:.2f} ms/step, "
                  f"{syncs:.2f} host syncs/step", flush=True)
    narrow_phase._pfm_call = GRAPHED


if __name__ == "__main__":
    main()
