"""The deepest contact of the JAX package's narrow phase and of the port's
on the JAX package's own stored states of ``primitives3(40)``
(``artifacts/primitives3_small.npz``: the warmed state and the states after
the first two reference frames, under ``ladder`` and ``fused``), with the
count of contact points deeper than 0.1 m: f32 GJK sends a touching pair
into a flat simplex now and then, in either package, and EPA then gives a
deep contact (ROADMAP C9). Runs on the CPU (~1 min)::

    JAX_PLATFORMS=cpu python scripts/check_pfm_depths.py
"""

from __future__ import annotations

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from wgmath_tpu.broad_phase.brute_force import PairList  # noqa: E402
from wgmath_tpu.geometry.sim import Sim  # noqa: E402
from wgmath_tpu.queries.narrow_phase import narrow_phase as jax_narrow  # noqa: E402
from wgmath_tpu.shapes.shape import ShapeSet  # noqa: E402
from wgmath_tpu_torch.convert import state_from_arrays  # noqa: E402
from wgmath_tpu_torch.queries.narrow_phase import narrow_phase  # noqa: E402

NPZ = os.path.join(ROOT, "artifacts", "primitives3_small.npz")
PRED, DEEP = 0.002, 0.1
CAPS = dict(p_max=4, sat_capacity=2048, pfm_capacity=2048, bc_capacity=256)


def _depths(valid, num, dist):
    live = valid[:, None] & (np.arange(4)[None, :] < num[:, None])
    return np.where(live, -dist, 0.0).max(-1)


def main():
    with np.load(NPZ) as f:
        z = dict(f)
    run = None
    for name in ("ladder", "fused"):
        for which in ("state", "ref.0.state", "ref.1.state"):
            pre = f"primitives3.{name}.{which}."
            st = state_from_arrays({k[len(pre):]: v for k, v in z.items()
                                    if k.startswith(pre)}, device="cpu")
            c, _ = narrow_phase(st.bodies.poses, st.shapes, st.bp_pairs,
                                PRED, **CAPS, with_overflow=True)
            port = _depths(c.valid.numpy(), c.num_points.numpy(),
                           c.dist.numpy())
            if run is None:
                shapes = ShapeSet(
                    jnp.asarray(st.shapes.tag.numpy().astype(np.int32)),
                    jnp.asarray(st.shapes.params.numpy()),
                    jnp.zeros((0, 3)), jnp.zeros((0, 3), jnp.int32),
                    kinds=st.shapes.kinds)
                run = jax.jit(lambda q, t, s, a, b, v, n: jax_narrow(
                    Sim(q, t, s), shapes, PairList(a, b, v, n), PRED,
                    **CAPS))
            p, pairs = st.bodies.poses, st.bp_pairs
            jc = run(*(jnp.asarray(x.numpy()) for x in (
                p.rotation, p.translation, p.scale)),
                jnp.asarray(pairs.body_a.numpy().astype(np.int32)),
                jnp.asarray(pairs.body_b.numpy().astype(np.int32)),
                jnp.asarray(pairs.valid.numpy()), jnp.int32(int(pairs.count)))
            ref = _depths(np.asarray(jc.valid), np.asarray(jc.num_points),
                          np.asarray(jc.dist))
            print(f"{name} {which}: deepest contact JAX {ref.max():.4f} m "
                  f"({int((ref > DEEP).sum())} deeper than {DEEP}), port "
                  f"{port.max():.4f} m ({int((port > DEEP).sum())})",
                  flush=True)


if __name__ == "__main__":
    torch.set_num_threads(4)
    main()
