"""Show the JAX package's LBVH per-leaf window on a resting layer of balls
(ROADMAP C11), on the CPU.

``wgmath_tpu.broad_phase.lbvh.find_pairs_lbvh`` gives each leaf a window
of ``_PER_LEAF_CAP`` (64) pairs with later-ranked leaves. A body that
overlaps more of them than that, such as a ground slab under a layer of
balls, keeps the first 64 of its pairs; the rest are dropped and the
overflow is reported as ``count = max(total, capacity + 1)``. In the
pipeline, ``step_checked`` then regrows ``pair_capacity`` on every frame,
which does not bring the pairs back, and the balls that lost their ground
pair sink. The port's ``find_pairs_lbvh`` does the same
(``tests/test_torch_lbvh.py``'s ``per_leaf_cap`` case holds the two
equal).

The scene: a static ground slab (half extents 10 x 0.5 x 10, top at
y = 0) under a 16 x 16 layer of balls of radius 0.5 resting on it. Prints
the LBVH's pairs against the brute force's, then four ``step_checked``
frames under ``bp_algo="lbvh"`` and under ``"grid"``: the pair capacity,
the contact count and the lowest ball centre after each. About a minute,
mostly JAX compiles::

    JAX_PLATFORMS=cpu python scripts/check_lbvh_window.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from wgmath_tpu.broad_phase.brute_force import find_pairs  # noqa: E402
from wgmath_tpu.broad_phase.lbvh import find_pairs_lbvh  # noqa: E402
from wgmath_tpu.dynamics import (  # noqa: E402
    Bodies,
    SimParams,
    Velocity,
    ball_local_mprops,
    cuboid_local_mprops,
)
from wgmath_tpu.dynamics.body import LocalMassProperties  # noqa: E402
from wgmath_tpu.geometry import sim as sim_ops  # noqa: E402
from wgmath_tpu.pipeline import (  # noqa: E402
    PipelineConfig,
    new_state,
    step_checked,
)
from wgmath_tpu.shapes import ShapeSet  # noqa: E402
from wgmath_tpu.shapes.shape import world_aabbs  # noqa: E402

SIDE, RADIUS, FRAMES = 16, 0.5, 4


def layer_scene():
    """A static ground slab, then SIDE x SIDE balls resting on it."""
    n = SIDE * SIDE + 1
    g = np.arange(SIDE, dtype=np.float32) - SIDE / 2
    xx, zz = np.meshgrid(g, g)
    trans = np.zeros((n, 3), np.float32)
    trans[0] = (0.0, -0.5, 0.0)
    trans[1:] = np.stack([xx.ravel(), np.full(SIDE * SIDE, RADIUS),
                          zz.ravel()], -1)
    shapes = ShapeSet.concat(
        ShapeSet.cuboids(jnp.asarray([[10.0, 0.5, 10.0]])),
        ShapeSet.balls(jnp.full((n - 1,), RADIUS)))
    poses = sim_ops.from_parts(jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (n, 1)),
                               jnp.asarray(trans))
    gm = cuboid_local_mprops(jnp.asarray([[10.0, 0.5, 10.0]]),
                             dynamic=jnp.asarray([False]))
    bm = ball_local_mprops(jnp.full((n - 1,), RADIUS))
    mp = LocalMassProperties(*(jnp.concatenate([getattr(gm, f),
                                                getattr(bm, f)])
                               for f in ("inv_mass", "com",
                                         "inertia_ref_frame",
                                         "inv_principal_inertia")))
    return new_state(Bodies(poses, Velocity.zero(n, 3), mp), shapes)


def pair_set(p) -> set:
    a, b, v = (np.asarray(x) for x in (p.body_a, p.body_b, p.valid))
    return set(zip(a[v].tolist(), b[v].tolist()))


def main():
    params = SimParams()
    state = layer_scene()
    mn, mx = world_aabbs(state.shapes, state.bodies.poses,
                         margin=params.prediction_distance)
    cap = 4096
    lb = find_pairs_lbvh(mn, mx, capacity=cap)
    bf = find_pairs(mn, mx, capacity=cap, max_per_row=512)
    missed = pair_set(bf) - pair_set(lb)
    print(f"find_pairs_lbvh: {len(pair_set(lb))} pairs, count "
          f"{int(lb.count)} (capacity {cap}); brute force "
          f"{len(pair_set(bf))}; {len(missed)} missed, all with the ground: "
          f"{all(0 in pr for pr in missed)}")
    base = PipelineConfig(pair_capacity=1024, max_colors=8)
    for algo in ("lbvh", "grid"):
        st, cfg = state, dataclasses.replace(base, bp_algo=algo)
        for f in range(FRAMES):
            st, cfg = step_checked(st, params, cfg)
            pc = np.asarray(st.pair_count)
            low = float(np.asarray(st.bodies.poses.translation)[1:, 1].min())
            print(f"{algo} frame {f}: pair_capacity {cfg.pair_capacity}, "
                  f"pair count {int(pc[0])}, contacts {int(pc[1])}, lowest "
                  f"ball centre y {low:.4f}", flush=True)


if __name__ == "__main__":
    main()
