"""The JAX package's EPA and the port's on the core-overlapping pairs of
the 10,000-body primitive rain that ``scripts/probe_epa_10k.py`` saves on
the card (``epa10k_pairs.npz``: one frame's EPA batch under the reference's
cap; ``epa10k_nonfinite.npz``: the batch with the first non-finite output
under a raised cap, when there is one). On the CPU, in float32 and, for the
port, float64 as the referee: the non-finite outputs of each, and where
both are finite the largest difference of depth and normal against the
referee, and the witnesses (``point_a``) farther than ``WILD`` from A's
origin: a degenerate best face sends EPA's barycentric denominator to its
clamp of 1e-30 (ROADMAP C8). Run from the repository root::

    JAX_PLATFORMS=cpu python scripts/check_epa_10k.py [dir]

``dir`` defaults to ``chiprun_out``.
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

from wgmath_tpu.queries import epa as jax_epa  # noqa: E402
from wgmath_tpu_torch.queries import epa as port_epa  # noqa: E402

KEYS = ("tag_a", "par_a", "tag_b", "par_b", "r_ab", "t_ab")
SETTLED = 1e-3  # both within this of the float64 referee
WILD = 1e3  # m; every shape of the scene lies within 100 m of its origin


def _bad(n, d, p) -> np.ndarray:
    return ~(np.isfinite(n).all(-1) & np.isfinite(d) & np.isfinite(p).all(-1))


def compare(name: str, args: dict) -> None:
    m = args["t_ab"].shape[0]
    if not m:
        print(f"{name}: no pairs")
        return
    j = [np.asarray(x) for x in jax.jit(jax_epa.epa_penetration)(
        *(jnp.asarray(args[k]) for k in KEYS))]
    t32 = [x.numpy() for x in port_epa.epa_penetration(
        *(torch.from_numpy(args[k]) for k in KEYS))]
    t64 = [x.numpy() for x in port_epa.epa_penetration(*(
        torch.from_numpy(args[k].astype(np.float64)
                         if args[k].dtype == np.float32 else args[k])
        for k in KEYS))]
    bad_j, bad_t, bad_64 = _bad(*j), _bad(*t32), _bad(*t64)
    print(f"{name}: {m} pairs; non-finite JAX {int(bad_j.sum())}, port f32 "
          f"{int(bad_t.sum())}, port f64 {int(bad_64.sum())}")
    if "depth" in args:  # the port's outputs on the card
        card = [args["normal"], args["depth"], args["point_a"]]
        bad_c = _bad(*card)
        same = all(np.array_equal(a, b, equal_nan=True)
                   for a, b in zip(card, t32))
        print(f"  card: non-finite {int(bad_c.sum())}; the port's CPU "
              f"float32 outputs {'equal' if same else 'differ from'} the "
              "card's bits")
    wild = [np.abs(x[2]).max(-1) > WILD for x in (j, t32, t64)]
    print(f"  witnesses beyond {WILD:g} m: JAX {int(wild[0].sum())}, port "
          f"f32 {int(wild[1].sum())}, port f64 {int(wild[2].sum())}; at the "
          f"same pairs {bool(np.array_equal(wild[0], wild[1]))}")
    ok = ~(bad_j | bad_t | bad_64)
    dj = np.abs(j[1] - t64[1])
    dt = np.abs(t32[1] - t64[1])
    settled = ok & (dj <= SETTLED) & (dt <= SETTLED)
    print(f"  depth |JAX - port f32| on the {int(settled.sum())} pairs both "
          f"settle (within {SETTLED} of f64): "
          f"{float(np.abs(j[1] - t32[1])[settled].max(initial=0)):.3e}; "
          f"unsettled JAX {int((ok & (dj > SETTLED)).sum())}, port "
          f"{int((ok & (dt > SETTLED)).sum())}")
    nd = np.abs(j[0] - t32[0]).max(-1)
    print(f"  normal |JAX - port f32| on those pairs: "
          f"{float(nd[settled].max(initial=0)):.3e}; depth range JAX "
          f"{float(j[1][ok].min(initial=0)):.4f}..{float(j[1][ok].max(initial=0)):.4f}")
    for label, bad in (("JAX", bad_j), ("port f32", bad_t)):
        for i in np.nonzero(bad)[0][:5]:
            print(f"  {label} non-finite at {i}: tags {int(args['tag_a'][i])}"
                  f"/{int(args['tag_b'][i])}, par_a {args['par_a'][i][:3]}, "
                  f"par_b {args['par_b'][i][:3]}, t_ab {args['t_ab'][i]}, "
                  f"JAX depth {j[1][i]}, port f32 depth {t32[1][i]}, "
                  f"f64 depth {t64[1][i]}")


def main() -> None:
    d = sys.argv[1] if len(sys.argv) > 1 else os.path.join(ROOT,
                                                            "chiprun_out")
    path = os.path.join(d, "epa10k_pairs.npz")
    with np.load(path) as z:
        compare("epa10k_pairs (cap 256)", dict(z))
    path = os.path.join(d, "epa10k_nonfinite.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            args = {k: z[f"epa.{k}"] for k in KEYS}
            args.update(normal=z["epa.normal"], depth=z["epa.depth"],
                        point_a=z["epa.point_a"])
            compare("epa10k_nonfinite (cap 16384)", args)


if __name__ == "__main__":
    main()
