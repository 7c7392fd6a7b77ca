"""Step once more the state that ``scripts/probe_prim_nan.py`` saved before
the primitive rain's first non-finite frame, on the device asked for, under
the same checks, and say which stage fails. With ``--jax`` (CPU only), a
narrow-phase failure's pairs also go through the JAX package's
``pfm_contact`` and ``pfm_manifold`` on the same poses. Run from the
repository root::

    JAX_PLATFORMS=cpu python3 scripts/replay_prim_nan.py \
        artifacts/prim_nan_300_ladder.npz --device cpu --jax
"""

from __future__ import annotations

import importlib
import argparse
import functools
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from probe_prim_nan import Checks  # noqa: E402
from wgmath_tpu_torch.convert import state_from_arrays  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked  # noqa: E402
from wgmath_tpu_torch.queries import gjk  # noqa: E402
narrow_mod = importlib.import_module(
    "wgmath_tpu_torch.queries.narrow_phase")


def jax_pairs(poses, shapes, bodies) -> None:
    """The JAX package's contact and manifold of each (body_a, body_b)."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp

    from wgmath_tpu.geometry.sim import Sim as JaxSim
    from wgmath_tpu.queries import gjk as jax_gjk
    from wgmath_tpu.queries import pfm_manifold as jax_pm

    pred = SimParams().prediction_distance
    for a, b in bodies:
        idx = {"a": [a], "b": [b]}
        args = []
        for side in ("a", "b"):
            i = idx[side]
            pose = poses.take(torch.tensor(i))
            args += [jnp.asarray(shapes.tag[i].numpy()),
                     jnp.asarray(shapes.params[i].numpy()),
                     JaxSim(jnp.asarray(pose.rotation.numpy()),
                            jnp.asarray(pose.translation.numpy()),
                            jnp.asarray(pose.scale.numpy()))]
        n, p, d = jax_gjk.pfm_contact(*args)
        pts, dist, num = jax_pm.pfm_manifold(*args, n, p, d, pred)
        print(f"  JAX, bodies {a}/{b}: normal {np.asarray(n)[0].tolist()}, "
              f"dist {float(d[0])}, witness {np.asarray(p)[0].tolist()}; "
              f"manifold {int(num[0])} points "
              f"{np.asarray(pts)[0, :int(num[0])].tolist()}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    with np.load(args.path) as z:
        arrays = {k: z[k] for k in z.files}
    cap = int(arrays.pop("epa_cap", 256))
    if cap != 256:
        narrow_mod.pfm_contact = functools.partial(gjk.pfm_contact,
                                                   epa_cap=cap)
    cfg = PipelineConfig.from_dict(json.loads(str(arrays.pop("config_json"))))
    frame = int(arrays.pop("frame"))
    state = state_from_arrays(arrays, device=args.device)
    with Checks() as checks:
        for f in range(args.frames):
            state, cfg = step_checked(state, SimParams(), cfg)
            if checks.failure is not None:
                stage, count, rows = checks.failure
                print(f"frame {frame + f} on {args.device}: {stage}, {count} "
                      "bad")
                for r in rows:
                    print(f"  {r}")
                if args.jax and checks.context is not None:
                    jax_pairs(*checks.context)
                return
    print(f"frames {frame}..{frame + args.frames - 1} on {args.device}: "
          "clean")


if __name__ == "__main__":
    main()
