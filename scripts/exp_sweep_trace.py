"""Where does a one-launch sweep spend its time, level by level?

Builds the sweep kernels with ``-DWG_SWEEP_TRACE=1`` (``csrc/gs_sweep.cuh``:
every row a sweep runs records the global timer when its block has its
chunk, after the staging barrier, after its wait, after its update and
after its release), checks that each traced build gives the untraced
build's bits, and prints per level the median and the last of each mark
(µs from the launch's first mark), the rows that waited, and the step from
one level's last release to the next level's last.

- ladder: B1 / B2 (``csrc/gs_math.cu``, ``csrc/gs_math_block.cu``) over
  the first substep's two sweeps of the settled 10k pit's first frame
  under ``chained_ps`` (B1) and the ladder (B2); a level is a rung.
- fused: B11 and B10 (``csrc/gs_fused.cu``) on the first substep of the
  same frame under the stored ``fused`` configuration (P = 1), and on
  ``chip_smoke.py``'s P = 4 layout (a residue rung, two empty colours); a
  level is an occupied colour, over its active rows; the opening's lanes
  (B11's warmstart) are reported first (marks 0 and 4).

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_sweep_trace.py [--only ladder|fused]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    NPZ,
    NPZ_LADDER,
    P4_BODIES,
    P4_WINDOWS,
    TRACE_MARKS,
    fused_calls,
    fused_inputs,
    fused_operands,
    fused_trace,
    nvidia_smi_line,
    pit_fused_calls,
    pit_sweeps,
    run_fused,
    run_recorded,
    sweep_trace,
    traced_sweep_kernels,
)
from wgmath_tpu_torch.dynamics import build_fused, gs_fused  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402


def _levels(name, levels, t0) -> None:
    """Print one row per level: (label, rows, rows that waited, [n, 5]
    marks in ns); the level labelled "open" has marks 0 and 4 only."""
    print(f"{name}: {len(levels)} levels, marks in us from the first "
          "(median / last)")
    print("  level  rows  waited  "
          + "  ".join(f"{m:>15s}" for m in TRACE_MARKS)
          + "  last release - previous last")
    prev = None
    for label, rows, waited, marks in levels:
        marked = (0, 4) if label == "open" else range(len(TRACE_MARKS))
        m = (marks.astype(np.int64) - t0) / 1e3
        cols = "  ".join(f"{np.median(m[:, k]):7.2f}/{m[:, k].max():7.2f}"
                         if k in marked else f"{'-':>15s}"
                         for k in range(len(TRACE_MARKS)))
        last = m[:, 4].max()
        step = "" if prev is None else f"{last - prev:7.2f}"
        print(f"  {label:>5} {rows:5d} {waited:7d}  {cols}  {step}")
        prev = last


def _report(name, call, marks) -> None:
    plan = call.plan
    waits = plan.sides.cpu().numpy()[:, 2]
    levels = []
    for r in plan.rungs:
        if not r.rows:
            continue
        a = 2 * r.w_off + np.arange(r.rows)
        b = a + r.window
        waited = int(((waits[a] >= 0) | (waits[b] >= 0)).sum())
        levels.append((str(r.colour), r.rows, waited, marks[a]))
    t0 = min(int(m[:, 0].min()) for *_, m in levels)
    _levels(name, levels, t0)


def _report_fused(name, call, marks) -> None:
    """Per occupied colour, over its active rows (the padding neither
    waits nor writes); a row waited when its velocities matter and a side
    has a previous writer (B11: always, at least the lane's warmstart)."""
    kw = call.kw
    windows, rung0 = kw["windows"], kw["rung0"]
    _, offsets, ctot = gs_fused.fused_layout(windows, rung0)
    substep = call.name == "fused_substep1"
    act = call.args[6 if substep else 4][0].cpu().numpy() > 0.5
    idx, inv = (x.cpu().numpy() for x in call.args[-3:-1])
    counts = call.args[-1].cpu()
    prev = gs_fused.prev_writers(torch.from_numpy(inv), counts,
                                 windows).numpy()
    w_g = inv.shape[1]
    lanes = ctot + np.arange(w_g)
    levels = [("open", w_g, 0, marks[lanes])]
    for c, rung in enumerate(windows):
        if int(counts[c + 1]) <= 0:
            continue
        j = np.arange(rung)
        ba, bb = idx[c, j], idx[c, rung + j]
        need = act[offsets[c + 1] + j] | (inv[c, ba] == j) | (
            inv[c, bb] == rung + j)
        wait = need & ((prev[c, ba] >= 0) | (prev[c, bb] >= 0) | substep)
        rows = offsets[c + 1] + j[act[offsets[c + 1] + j]]
        if len(rows):
            levels.append((str(c + 1), len(rows), int(wait.sum()),
                           marks[rows]))
    t0 = min(int(m[:, 0].min()) for *_, m in levels)
    _levels(name, levels, t0)


def _p4_calls(dev) -> list:
    """B10 and B11 on chip_smoke's P = 4 layout (the B9 matrix from its
    plain version)."""
    rng = np.random.default_rng(20266)
    c4 = [64] + [int(x) for x in rng.integers(0, 257, len(P4_WINDOWS))]
    c4[-2:] = [0, 0]
    z = fused_inputs(rng, P4_BODIES, P4_WINDOWS, 256, c4, 4, dev)
    meta, k_all = build_fused.field_meta(4, 2)
    p = SimParams()
    big = build_fused._build_torch(
        build_fused._packed_bodies(z["poses"], z["vels"], z["mprops"]),
        z["contacts"], (p.restitution, p.inv_dt, p.friction,
                        p.contact_cfm_factor), meta, k_all, 4)
    return fused_calls(z, fused_operands(z, big, rng))[::-1]


def _traced(calls, run, trace, report) -> None:
    want = {name: run(c) for name, c in calls.items()}
    with traced_sweep_kernels():
        for name, call in calls.items():
            for _ in range(3):  # warm, then trace the last
                got = run(call)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want[name]))
            print(f"{name}: traced build {'gives' if same else 'DIFFERS'} "
                  "from the untraced build's bits")
            report(name, call, trace(call))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=("ladder", "fused"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("exp_sweep_trace: needs a CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    if args.only != "fused":
        calls = {f"{tag} sweep {k + 1}": c
                 for path, tag in ((NPZ, "chained_ps"),
                                   (NPZ_LADDER, "ladder"))
                 for k, c in enumerate(pit_sweeps(path, "cuda"))}
        _traced(calls, lambda c: run_recorded(c, "kernel"), sweep_trace,
                _report)
    if args.only != "ladder":
        calls = {f"{c.name} fused pit frame 1": c
                 for c in pit_fused_calls("cuda")}
        calls.update({f"{c.name} P=4": c for c in _p4_calls("cuda")})
        _traced(calls, lambda c: run_fused(c, "kernel"),
                lambda c: fused_trace(), _report_fused)
    return 0


if __name__ == "__main__":
    sys.exit(main())
