"""``capsules2``'s support-mapped rows and frames against a float64
witness (ROADMAP C14): the exact contact of each pair by a search over
directions (``tests.planar_inputs.witness_2d``, no GJK), beside JAX's
stored float32 rows (``artifacts/planar_jax.npz.xz``) and the port's
rows, with the port's 2D support-mapped kernel run as it ships (float64)
and, for comparison, in float32 as the JAX package runs it. For each of
the three stored frames it prints the rows that leave the witness by
more than 1e-5 (distance, normal or an only point) and the frame's
figures (``tests.planar_inputs.frame_errors``): the counts, the largest
translation error of the bodies the solve joins to JAX's C14 rows and of
the others.

Runs on the CPU, no JAX, ~20 s::

    python scripts/check_planar_c14.py
"""

from __future__ import annotations

import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tests.planar_inputs import (  # noqa: E402
    WITNESS_TOL,
    case_mode,
    config_of,
    frame_errors,
    params_of,
    planar_state,
    support_rows,
)
from wgmath_tpu_torch.broad_phase.brute_force import find_pairs  # noqa: E402
from wgmath_tpu_torch.pipeline import step_checked  # noqa: E402
tnp = importlib.import_module("wgmath_tpu_torch.queries.narrow_phase")
from wgmath_tpu_torch.shapes.shape import (  # noqa: E402
    ball_radii_or_nan,
    world_aabbs,
)

CASE = "capsules2"


def port_rows(state, cfg, rows):
    """The port's narrow phase on ``state`` (the step's brute force) at
    the pair slots ``rows``: (dist, normal, point on A)."""
    b, sh = state.bodies, state.shapes
    pred = params_of("default").prediction_distance
    mins, maxs = world_aabbs(sh, b.poses, margin=pred)
    p = find_pairs(mins, maxs, capacity=cfg.pair_capacity,
                   block=cfg.broad_phase_block,
                   max_per_row=cfg.broad_phase_max_per_row,
                   ball_radius=ball_radii_or_nan(sh, b.poses), margin=pred,
                   dynamic=b.is_dynamic())
    c, _ = tnp.narrow_phase(b.poses, sh, p, pred, p_max=2, with_overflow=True)
    r = torch.from_numpy(rows)
    return (c.dist[r, 0].numpy(), c.normal_a[r].numpy(),
            c.points_a[r, 0].numpy())


def off_witness(sr, dist, normal, point) -> np.ndarray:
    return ((np.abs(dist - sr["dist"]) > WITNESS_TOL)
            | (np.abs(normal - sr["normal"]).max(1) > WITNESS_TOL)
            | (sr["only"] & (np.abs(point - sr["point"]).max(1)
                             > WITNESS_TOL)))


def main() -> None:
    torch.set_num_threads(1)
    f64 = tnp._f64
    for f in range(3):
        st = planar_state(CASE, f)
        cfg = config_of(f"{CASE}.config_json" if f == 0
                        else f"{CASE}.ref.{f - 1}.config_json")
        sr = support_rows(CASE, f, st)
        jax = sr["jax"]
        print(f"frame {f}: {sr['rows'].size} support-mapped rows; JAX's "
              f"off the witness at slots {sr['rows'][sr['c14']].tolist()}"
              f" (distance by up to "
              f"{np.abs(jax['dist'] - sr['dist']).max():.3e} m)")
        for name, cast in (("float64", f64), ("float32", None)):
            tnp._f64 = cast or (lambda pose, par: (pose, par))
            try:
                d, n, pt = port_rows(st, cfg, sr["rows"])
                new, _ = step_checked(st, params_of(case_mode(CASE)), cfg)
            finally:
                tnp._f64 = f64
            off = off_witness(sr, d, n, pt)
            print(f"  port {name}: off the witness at slots "
                  f"{sr['rows'][off].tolist()} (distance by up to "
                  f"{np.abs(d - sr['dist']).max():.3e} m); frame "
                  f"{frame_errors(CASE, f, st, new)}")


if __name__ == "__main__":
    main()
