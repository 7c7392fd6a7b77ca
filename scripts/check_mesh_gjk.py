"""The JAX package's float32 GJK on mesh triangles against the port's and
a brute-force distance (ROADMAP C13): the convex rows of ``mesh10k``'s
first frame (``chip_smoke.mesh10k_scene``: 5,000 cuboids 1 mm over the
225 x 225 field), a chunk of cuboid pairs at a time through both packages'
``mesh_convex_contacts``. For every row where the two packages' distances
part by more than 1e-4 m it prints JAX's distance, the port's in float32
and in float64, and the distance between the cuboid and the triangle by
dense sampling of the triangle (161 x 161 points, exact point-to-box
distances): which package left the true distance.

Runs on the CPU (JAX and the port), ~3 min for all 5,000 cuboids::

    JAX_PLATFORMS=cpu python scripts/check_mesh_gjk.py [--cuboids N]
"""

from __future__ import annotations

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import export_mesh_npz  # noqa: E402
from chip_smoke import mesh10k_scene  # noqa: E402
from wgmath_tpu.broad_phase.brute_force import PairList as JPairList  # noqa: E402
from wgmath_tpu.queries import mesh_contact as jmc  # noqa: E402
from wgmath_tpu_torch.broad_phase.brute_force import PairList  # noqa: E402
from wgmath_tpu_torch.geometry.sim import Sim  # noqa: E402
from wgmath_tpu_torch.queries import gjk  # noqa: E402
from wgmath_tpu_torch.queries import mesh_contact as tmc  # noqa: E402
from wgmath_tpu_torch.shapes import shape as shp  # noqa: E402

CHUNK = 500
PRED, MARGIN, K = 0.002, 0.02, 4


def brute_distance(tri: np.ndarray, center: np.ndarray, he: np.ndarray):
    """Least distance from an axis-aligned box to a triangle, by 161 x 161
    samples of the triangle (float64)."""
    u = np.linspace(0.0, 1.0, 161)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    m = (uu + vv) <= 1.0
    p = tri[0] + uu[m, None] * (tri[1] - tri[0]) + vv[m, None] * (
        tri[2] - tri[0])
    q = np.maximum(np.abs(p - center) - he, 0.0)
    return float(np.sqrt((q * q).sum(-1)).min())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cuboids", type=int, default=5000)
    args = ap.parse_args()
    ours, theirs = mesh10k_scene(device="cpu"), export_mesh_npz.mesh10k_scene()
    first = int((ours.shapes.tag == shp.BALL).sum()) + 1
    run = jax.jit(lambda poses, b: tuple(getattr(jmc.mesh_convex_contacts(
        poses, theirs.shapes, JPairList(jnp.zeros(CHUNK, jnp.int32), b,
                                        jnp.ones(CHUNK, bool),
                                        jnp.int32(CHUNK)), PRED,
        pair_cap=CHUNK, k_best=K), f) for f in ("valid", "dist")))
    totals = {"rows": 0, "off": 0, "jax_overlaps": 0, "jax_off_true": 0,
              "port_off_true": 0}
    poses = ours.bodies.poses
    for s0 in range(first, first + args.cuboids, CHUNK):
        bodies = np.arange(s0, s0 + CHUNK)
        pairs = PairList(torch.zeros(CHUNK, dtype=torch.int64),
                         torch.from_numpy(bodies),
                         torch.ones(CHUNK, dtype=torch.bool),
                         torch.tensor(CHUNK))
        c = tmc.mesh_convex_contacts(poses, ours.shapes, pairs, PRED,
                                     pair_cap=CHUNK, k_best=K)
        jv, jd = run(theirs.bodies.poses, jnp.asarray(bodies, jnp.int32))
        d_port = c.dist[:, 0].numpy()
        d_jax = np.asarray(jd)[:, 0]
        off = np.nonzero(np.abs(d_port - d_jax) > 1e-4)[0]
        # the rows' triangles, as the contacts chose them
        c_local = poses.translation[bodies] - poses.translation[0]
        he = shp.local_aabb_half_extents(ours.shapes, 3)[bodies]
        reach = gjk.norm_fma(he) + MARGIN + PRED
        best, _ = tmc._topk_by_score(
            ours.shapes, torch.zeros(CHUNK, dtype=torch.int64),
            torch.full((CHUNK,), int(ours.shapes.params[0, 3])), c_local,
            torch.ones(CHUNK, dtype=torch.bool), K, tmc._tri_dist, 0.0,
            reach)
        for r in off:
            b = bodies[r // K]
            tri = ours.shapes.vertices[ours.shapes.indices[
                best[r // K, r % K]]].double()
            one = torch.ones(1, dtype=torch.float64)
            rot = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float64)
            d64 = gjk.gjk_distance(
                torch.tensor([shp.TRIANGLE]),
                torch.zeros((1, 8), dtype=torch.float64),
                Sim(rot, torch.zeros((1, 3), dtype=torch.float64), one),
                torch.tensor([shp.CUBOID]),
                ours.shapes.params[b:b + 1].double(),
                Sim(rot, c_local[r // K:r // K + 1].double(), one),
                tri_verts_a=tri[None], window=0).distance
            true = brute_distance(tri.numpy(), c_local[r // K].double()
                                  .numpy(), he[r // K].double().numpy())
            totals["jax_overlaps"] += int(d_jax[r] == -MARGIN)
            totals["jax_off_true"] += int(abs(d_jax[r] + MARGIN - true)
                                          > 1e-3)
            totals["port_off_true"] += int(abs(d_port[r] + MARGIN - true)
                                           > 1e-4)
            if totals["off"] < 20:
                print(f"cuboid {b} row {r % K}: JAX {d_jax[r] + MARGIN:.6f}"
                      f", port f32 {d_port[r] + MARGIN:.6f}, port f64 "
                      f"{float(d64):.6f}, sampled {true:.6f} m")
            totals["off"] += 1
        totals["rows"] += len(d_port)
        print(f"cuboids {s0}-{s0 + CHUNK - 1}: {totals}", flush=True)
    print(f"rows {totals['rows']}: {totals['off']} part by more than 1e-4 "
          f"m; of those JAX reports {totals['jax_overlaps']} as "
          f"overlapping cores and leaves the sampled distance by more than "
          f"1e-3 m on {totals['jax_off_true']}, the port leaves it by more "
          f"than 1e-4 m on {totals['port_off_true']}")


if __name__ == "__main__":
    main()
