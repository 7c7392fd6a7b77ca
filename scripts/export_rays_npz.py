"""Store the JAX package's first ray cast of the bench's raycast section as
a JAX-free ``.npz`` for the PyTorch port.

Rebuilds the bench's inputs (``bench.py`` ``bench_rays``: 100,000 rays
against balls, cuboids and capsules drawn from ``default_rng(3)``) with
``chip_smoke.ray_bench_arrays``, the same numpy calls ``chip_smoke.py``
makes on the card, builds the JAX ``ShapeSet`` (default ``kinds``, as the
bench builds it) and ``Sim`` from them, and runs ``wgmath_tpu.queries.ray.
cast`` once. ``artifacts/rays100k_jax.npz`` holds

- ``t``: float32 [100000], the time of impact of each ray (+inf on a miss),
- ``n``, ``seed``: the input's size and seed,
- ``hits``: the number of finite times.

Runs on the CPU in a few seconds::

    JAX_PLATFORMS=cpu python scripts/export_rays_npz.py
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

from chip_smoke import RAY_N, ray_bench_arrays  # noqa: E402
from wgmath_tpu.geometry.sim import Sim  # noqa: E402
from wgmath_tpu.queries.ray import cast  # noqa: E402
from wgmath_tpu.shapes import ShapeSet  # noqa: E402

SEED = 3
OUT = os.path.join(ROOT, "artifacts", "rays100k_jax.npz")


def main() -> None:
    z = ray_bench_arrays(RAY_N, SEED)
    shapes = ShapeSet(jnp.asarray(z["tag"]), jnp.asarray(z["params"]),
                      jnp.zeros((0, 3), jnp.float32),
                      jnp.zeros((0, 3), jnp.int32))
    poses = Sim(*(jnp.asarray(z[k]) for k in ("rotation", "translation",
                                              "scale")))
    t = np.asarray(jax.jit(cast)(shapes, poses, jnp.asarray(z["origins"]),
                                 jnp.asarray(z["dirs"])), np.float32)
    hits = int(np.isfinite(t).sum())
    np.savez_compressed(OUT, t=t, n=np.int64(RAY_N), seed=np.int64(SEED),
                        hits=np.int64(hits))
    print(f"wrote {OUT}: {RAY_N} rays, {hits} hits, "
          f"{os.path.getsize(OUT)} bytes")


if __name__ == "__main__":
    main()
