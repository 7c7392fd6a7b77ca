"""Where does a one-launch sweep of B1 / B2 spend its time, rung by rung?

Builds ``csrc/gs_math.cu`` and ``csrc/gs_math_block.cu`` with
``-DWG_SWEEP_TRACE=1`` (``csrc/gs_sweep.cuh``: every row a sweep runs
records the global timer when its block has its chunk, after the staging
barrier, after its wait, after its update and after its release), runs
the first substep's two sweeps of the settled 10k pit's first frame under
``chained_ps`` (B1) and the ladder (B2), checks that the traced build
gives the untraced build's bits, and prints per rung the median and the
last of each mark (µs from the sweep's first mark), the rows that waited,
and the step from one rung's last release to the next rung's last.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_sweep_trace.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    NPZ,
    NPZ_LADDER,
    TRACE_MARKS,
    nvidia_smi_line,
    pit_sweeps,
    run_recorded,
    sweep_trace,
    traced_sweep_kernels,
)


def _report(name, call, marks) -> None:
    plan = call.plan
    waits = plan.sides.cpu().numpy()[:, 2]
    rows = [(r, 2 * r.w_off + np.arange(r.rows)) for r in plan.rungs
            if r.rows]
    t0 = min(int(marks[a, 0].min()) for _, a in rows)
    print(f"{name}: {len(rows)} rungs, marks in us from the first "
          "(median / last)")
    print("  rung  rows  waited  " + "  ".join(f"{m:>15s}" for m in TRACE_MARKS)
          + "  last release - previous last")
    prev = None
    for r, a in rows:
        m = (marks[a].astype(np.int64) - t0) / 1e3
        b = a + r.window
        waited = int(((waits[a] >= 0) | (waits[b] >= 0)).sum())
        cols = "  ".join(f"{np.median(m[:, k]):7.2f}/{m[:, k].max():7.2f}"
                         for k in range(len(TRACE_MARKS)))
        last = m[:, 4].max()
        step = "" if prev is None else f"{last - prev:7.2f}"
        print(f"  {r.colour:4d} {r.rows:5d} {waited:7d}  {cols}  {step}")
        prev = last


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_sweep_trace: needs a CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    calls = {f"{tag} sweep {k + 1}": c
             for path, tag in ((NPZ, "chained_ps"), (NPZ_LADDER, "ladder"))
             for k, c in enumerate(pit_sweeps(path, "cuda"))}
    want = {name: run_recorded(c, "kernel") for name, c in calls.items()}
    with traced_sweep_kernels():
        for name, call in calls.items():
            for _ in range(3):  # warm, then trace the last
                got = run_recorded(call, "kernel")
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want[name]))
            print(f"{name}: traced build {'gives' if same else 'DIFFERS'} "
                  "from the untraced build's bits")
            _report(name, call, sweep_trace(call))
    return 0


if __name__ == "__main__":
    sys.exit(main())
