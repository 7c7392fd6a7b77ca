"""How far the card's jointed frames sit from the CPU's, and how far a
broken joint pass would move them: the readings behind the limits of
``tests/test_torch_cuda.py::test_jointed_frames_on_card_match_cpu``.

For each of that test's cases of ``artifacts/joints_jax.npz`` it runs the
same two ``step`` frames from the warmed state on the CPU and on the card
and prints the largest |dx| (translations) and |dv| (linear velocities)
between them. Then, on the CPU, it runs the same frames with the joint
pass broken in one place at a time (each slot the set activates skipped,
each colour skipped) and prints the smallest |dx| and |dv| any of those
moves the CPU's frames by: a limit must sit below that.

    python3 scripts/exp_joint_card_gap.py            # card and CPU
    python3 scripts/exp_joint_card_gap.py --card-only

Needs a CUDA card for the card half; ``--cpu-only`` runs the broken passes
alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import (  # noqa: E402
    joints_case_config,
    joints_case_params,
    joints_case_state,
)
from wgmath_tpu_torch.dynamics import solver  # noqa: E402
from wgmath_tpu_torch.pipeline import step  # noqa: E402

CASES = ("drape_ladder", "drape_chained_ps", "net16", "joint_revolute3")
FRAMES = 2


def frames(case: str, device: str):
    params = joints_case_params(case)
    cfg = joints_case_config(f"{case}.config_json")
    state = joints_case_state(case, "warmed", device=device)
    for _ in range(FRAMES):
        state = step(state, params, cfg)
    return (state.bodies.poses.translation.cpu().numpy(),
            state.bodies.vels.linear.cpu().numpy())


def gap(a, b) -> dict:
    return {"dx": float(np.abs(a[0] - b[0]).max()),
            "dv": float(np.abs(a[1] - b[1]).max())}


def broken(case: str, how: str, which: int):
    """The CPU frames with the joint pass skipping slot ``which`` of the
    set's (``how="slot"``) or colour ``which`` (``how="colour"``)."""
    orig = solver.joint_gs_pass

    def skipping(cons, vels, colors, *, max_colors):
        if how == "slot":
            cut = dataclasses.replace(cons, slots=tuple(
                s for s in cons.slots if s != which))
            cols = colors
        else:
            cut = cons
            cols = torch.where(colors == which, torch.zeros_like(colors),
                               colors)
        vels, out = orig(cut, vels, cols, max_colors=max_colors)
        return vels, dataclasses.replace(out, slots=cons.slots)

    solver.joint_gs_pass = skipping
    try:
        return frames(case, "cpu")
    finally:
        solver.joint_gs_pass = orig


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--card-only", action="store_true")
    ap.add_argument("--cpu-only", action="store_true")
    a = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for case in CASES:
        ref = frames(case, "cpu")
        row = {}
        if not a.cpu_only:
            row["card"] = gap(frames(case, "cuda"), ref)
        if not a.card_only:
            jset = joints_case_state(case, "warmed", device="cpu").joints
            moves = {f"slot {s}": gap(broken(case, "slot", s), ref)
                     for s in jset.slots}
            moves.update({f"colour {c}": gap(broken(case, "colour", c), ref)
                          for c in range(1, jset.max_color + 1)})
            row["broken_min"] = {k: min(m[k] for m in moves.values())
                                 for k in ("dx", "dv")}
            row["broken"] = moves
        out[case] = row
        print(case, json.dumps({k: v for k, v in row.items()
                                if k != "broken"}), flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
