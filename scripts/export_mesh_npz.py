"""Export the JAX package's results for the meshes, the convex polyhedra
and the standalone segment / triangle colliders as a JAX-free file,
``artifacts/mesh_jax.npz.xz`` (``export_box_npz.savez_xz``), read by
``tests/test_torch_mesh.py``, ``tests/test_torch_pipeline_mesh.py``,
``tests/test_torch_cuda.py`` and ``chip_smoke.py``. Inputs are made from
seeds with numpy (``tests/mesh_inputs.py``), so the readers rebuild them.

Groups (``--only`` rewrites one, keeping the others' arrays):

- ``unit``: ``build_clusters`` on random triangles; the buffers of a
  ``trimesh``, two ``heightfield`` s (12 x 12: the dense route; 40 x 40,
  3,042 triangles: the clustered one), a ``convex_polyhedron`` and a
  ``concat`` of two clustered meshes, as SHA-1 digests of their bytes
  (``digest``); ``_topk_by_score`` ids and scores on both fields
  (``topk_points``: random points and points over shared edges and
  vertices); ``mesh_ball_contacts`` and ``mesh_convex_contacts`` on both
  fields (``contact_scene``: balls, cuboids, capsules and convex
  polyhedra near the surface); ``gjk_distance`` with ``tri_verts_a`` and
  ``pfm_contact`` with it and without EPA (``tri_pairs``);
  ``ray_trimesh`` on the 40 x 40 field, the CONVEX cast and ``project`` on trimesh, convex and field sets
  (``query_inputs``); ``build_bvh``;
- ``standalone``: ``tests/test_standalone_shapes.py``'s bare triangle and
  segment scenes and a convex polyhedron on the ground, 80 ``step``
  frames each, the dynamic body's translation after every frame;
- ``trimesh3``: ``SCENES["trimesh3"]`` under the testbed's configuration
  (``testbed_config``: ``PipelineConfig(pair_capacity=16384)`` with
  ``auto_manifold_points``), 90 ``step_checked`` frames (the balls land),
  then three frames, the states before each kept (``export_joints_npz.
  export_case``);
- ``mesh10k``: ``mesh10k_scene()`` (the 225 x 225 field of
  ``tests/test_mesh_accel.py``'s 100k-triangle test, 100,352 triangles,
  with 5,000 balls and 5,000 cuboids on a 100 x 100 lattice 0.4 m apart)
  under ``mesh10k_config``, three ``step_checked`` frames from the built
  state: each frame's ``pair_count`` and valid mesh rows (ball, convex),
  the translations after frames 1 and 3 as offsets from the built
  state's (``mesh10k.ref.<f>.offset``), and frame 1's distance and
  validity of the convex batch's 20,000 live rows.

Runs on the CPU::

    JAX_PLATFORMS=cpu python scripts/export_mesh_npz.py [--only GROUP]

``unit`` and ``standalone`` take ~2 min, ``trimesh3`` ~2 min and
``mesh10k`` ~15 min at ~15 GB of memory (the JAX package's GJK support
dots every convex lane with the field's 50,625 vertices).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from export_box_npz import savez_xz, slim  # noqa: E402
from tests.mesh_inputs import (  # noqa: E402
    LARGE_FIELD,
    MESH10K_BALL_R,
    MESH10K_BOX_HE,
    MESH10K_SPACING,
    SMALL_FIELD,
    bvh_boxes,
    contact_scene,
    cube_corners,
    cube_mesh,
    digest,
    field_heights,
    field_rays,
    mesh10k_config,
    mesh10k_layout,
    query_inputs,
    random_hull,
    topk_points,
    tri_pairs,
)

OUT = os.path.join(ROOT, "artifacts", "mesh_jax.npz.xz")
SHAPE_FIELDS = ("tag", "params", "vertices", "indices", "cluster_min",
                "cluster_max")
GROUPS = ("unit", "standalone", "trimesh3", "mesh10k")
TRIMESH3_LAND = 90  # frames before the stored ones: the balls have landed
STANDALONE_FRAMES = 80
MESH10K_FRAMES = 3


# --- the JAX side -----------------------------------------------------------


def mesh10k_scene():
    """The mesh10k state from the JAX package's public constructors."""
    from wgmath_tpu.dynamics.body import (
        Bodies,
        Velocity,
        ball_local_mprops,
        cuboid_local_mprops,
    )
    from wgmath_tpu.geometry.sim import Sim
    from wgmath_tpu.pipeline import new_state
    from wgmath_tpu.scenes.builders import _merge_mprops
    from wgmath_tpu.shapes import ShapeSet
    from wgmath_tpu.shapes.mesh import heightfield

    h, balls, boxes = mesh10k_layout()
    nb, nc = len(balls), len(boxes)
    r = jnp.full((nb,), MESH10K_BALL_R, jnp.float32)
    he = jnp.full((nc, 3), MESH10K_BOX_HE, jnp.float32)
    shapes = ShapeSet.concat(
        heightfield(h, MESH10K_SPACING, MESH10K_SPACING), ShapeSet.balls(r),
        ShapeSet.cuboids(he))
    trans = np.concatenate([np.zeros((1, 3), np.float32), balls, boxes])
    n = len(trans)
    poses = Sim(jnp.tile(jnp.asarray([0.0, 0, 0, 1], jnp.float32), (n, 1)),
                jnp.asarray(trans), jnp.ones((n,), jnp.float32))
    mp = _merge_mprops(
        cuboid_local_mprops(jnp.asarray([[25.0, 1.0, 25.0]], jnp.float32),
                            dynamic=jnp.asarray([False])),
        ball_local_mprops(r), cuboid_local_mprops(he))
    return new_state(Bodies(poses, Velocity.zero(n, 3), mp), shapes)


def testbed_config(shapes):
    """``BackendConfig().pipeline_config(manifold_points=
    auto_manifold_points(shapes, 3))`` (the testbed runner's)."""
    from wgmath_tpu.pipeline import auto_manifold_points
    from wgmath_tpu.testbed.runner import BackendConfig

    return BackendConfig().pipeline_config(
        manifold_points=auto_manifold_points(shapes, 3))


def _field(spec):
    from wgmath_tpu.shapes.mesh import heightfield

    h = field_heights(spec["n"], seed=spec["seed"])
    return h, heightfield(h, spec["spacing"], spec["spacing"])


def _np(x):
    a = np.asarray(x)
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _put_contacts(arrays, key, c):
    for f in ("body_a", "body_b", "normal_a", "valid", "num_points"):
        arrays[f"{key}.{f}"] = _np(getattr(c, f))
    arrays[f"{key}.point"] = _np(c.points_a[:, 0])
    arrays[f"{key}.dist"] = _np(c.dist[:, 0])


def _scene_shapes(field, trans, q, r, he, hh, cr):
    """The contact scene's shape set and poses (JAX)."""
    from wgmath_tpu.geometry.sim import Sim
    from wgmath_tpu.shapes import ShapeSet
    from wgmath_tpu.shapes.mesh import convex_polyhedron

    hulls = [convex_polyhedron(random_hull(5 + i)) for i in range(4)]
    shapes = ShapeSet.concat(
        field, ShapeSet.balls(jnp.full((4,), r, jnp.float32)),
        ShapeSet.cuboids(jnp.full((4, 3), he, jnp.float32)),
        ShapeSet.capsules(jnp.full((4,), hh, jnp.float32),
                          jnp.full((4,), cr, jnp.float32)), *hulls)
    return shapes, Sim(jnp.asarray(q), jnp.asarray(trans),
                       jnp.ones((17,), jnp.float32))


def export_unit(arrays: dict) -> None:
    from wgmath_tpu import native
    from wgmath_tpu.broad_phase.brute_force import PairList
    from wgmath_tpu.geometry.sim import Sim
    from wgmath_tpu.queries import gjk, mesh_accel, mesh_contact
    from wgmath_tpu.queries import projection as proj
    from wgmath_tpu.queries import ray
    from wgmath_tpu.shapes import ShapeSet
    from wgmath_tpu.shapes.mesh import convex_polyhedron, trimesh

    rng = np.random.default_rng(1)
    verts = rng.standard_normal((500, 3)).astype(np.float32)
    tris = rng.integers(0, 500, (301, 3)).astype(np.int32)
    out = mesh_accel.build_clusters(verts, tris, margin=0.02)
    for k, v in zip(("indices", "cmin", "cmax"), out):
        arrays[f"build.{k}"] = digest(v)

    v_cube, f_cube = cube_mesh()
    sets = {"cube_trimesh": trimesh(v_cube, f_cube),
            "hull": convex_polyhedron(random_hull()),
            "small_field": _field(SMALL_FIELD)[1],
            "large_field": _field(LARGE_FIELD)[1]}
    sets["concat"] = ShapeSet.concat(sets["small_field"],
                                     ShapeSet.balls(jnp.ones((2,))),
                                     sets["large_field"], sets["hull"])
    for name, s in sets.items():
        for f in SHAPE_FIELDS:
            arrays[f"sets.{name}.{f}"] = digest(getattr(s, f))
        arrays[f"sets.{name}.kinds"] = np.asarray(sorted(s.kinds), np.int32)

    for label, spec in (("dense", SMALL_FIELD), ("clustered", LARGE_FIELD)):
        h, field = _field(spec)
        assert mesh_accel.use_clusters(field) == (label == "clustered")
        pts = topk_points(h, spec["spacing"])
        n_q = len(pts)
        radius = jnp.asarray(np.random.default_rng(12).uniform(
            0.05, 0.3, n_q).astype(np.float32))
        first = jnp.zeros((n_q,), jnp.int32)
        num = jnp.full((n_q,), int(field.params[0, 3]), jnp.int32)
        active = jnp.asarray(np.arange(n_q) % 7 != 3)

        def score_fn(pt, va, vb, vc):
            p = proj.project_triangle(pt, va, vb, vc).point
            return jnp.linalg.norm(pt - p, axis=-1) - radius[:, None]

        for cut, max_score in (("far", 1e8), ("near", 0.05)):
            ids, s = jax.jit(lambda p: mesh_contact._topk_by_score(
                field, first, num, p, active, 4, score_fn, radius,
                max_score))(jnp.asarray(pts))
            arrays[f"topk.{label}.{cut}.ids"] = _np(ids)
            arrays[f"topk.{label}.{cut}.scores"] = _np(s)

        trans, q, r, he, hh, cr = contact_scene(h, spec["spacing"])
        shapes, poses = _scene_shapes(field, trans, q, r, he, hh, cr)
        pairs = PairList(jnp.zeros((20,), jnp.int32),
                         jnp.asarray(np.r_[np.arange(1, 17), 0, 0, 0, 0],
                                     jnp.int32),
                         jnp.asarray(np.arange(20) < 16), jnp.int32(16))
        c = jax.jit(lambda p: mesh_contact.mesh_ball_contacts(
            p, shapes, pairs, 0.05, pair_cap=8, k_best=4))(poses)
        _put_contacts(arrays, f"contacts.{label}.ball", c)
        c = jax.jit(lambda p: mesh_contact.mesh_convex_contacts(
            p, shapes, pairs, 0.05, pair_cap=16, k_best=4))(poses)
        _put_contacts(arrays, f"contacts.{label}.convex", c)

        o, d = field_rays(h, spec["spacing"])
        n = len(o)
        fs = ShapeSet(jnp.tile(field.tag, (n,)), jnp.tile(field.params,
                                                          (n, 1)),
                      field.vertices, field.indices, field.cluster_min,
                      field.cluster_max, kinds=field.kinds)
        ident = Sim(jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (n, 1)),
                    jnp.zeros((n, 3)), jnp.ones((n,)))
        arrays[f"ray.{label}"] = _np(jax.jit(ray.cast)(
            fs, ident, jnp.asarray(o), jnp.asarray(d)))
        arrays[f"project.{label}"] = _np(jax.jit(
            lambda s, p, x: proj.project(s, p, x, boundary=True).point)(
                fs, ident, jnp.asarray(o * 0.3)))

    tri, tb, qb = tri_pairs()
    n = len(tri)
    hull = convex_polyhedron(random_hull(13))
    tags = np.asarray([1, 2, 9] * n)[:n]  # cuboid, capsule, convex
    par_b = np.zeros((n, 8), np.float32)
    par_b[tags == 1, :3] = 0.2
    par_b[tags == 2, :2] = (0.2, 0.1)
    par_b[tags == 9] = np.asarray(hull.params[0])
    ident = Sim(jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (n, 1)),
                jnp.zeros((n, 3)), jnp.ones((n,)))
    pose_b = Sim(jnp.asarray(qb), jnp.asarray(tb), jnp.ones((n,)))
    args = (jnp.full((n,), 6, jnp.int32), jnp.zeros((n, 8)), ident,
            jnp.asarray(tags, jnp.int32), jnp.asarray(par_b), pose_b)
    fields = ("distance", "point_a", "point_b", "normal", "intersecting")
    res = jax.jit(lambda: tuple(getattr(gjk.gjk_distance(
        *args, vertices=hull.vertices, tri_verts_a=jnp.asarray(tri)), f)
        for f in fields))()
    for f, v in zip(fields, res):
        arrays[f"tri_gjk.{f}"] = _np(v)
    nrm, pt, dist = jax.jit(lambda: gjk.pfm_contact(
        *args, vertices=hull.vertices, tri_verts_a=jnp.asarray(tri),
        tri_margin=0.02, use_epa=False))()
    arrays["tri_pfm.normal"] = _np(nrm)
    arrays["tri_pfm.point"] = _np(pt)
    arrays["tri_pfm.dist"] = _np(dist)

    o, d, p = query_inputs()
    n = len(o)
    ident = Sim(jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (n, 1)),
                jnp.zeros((n, 3)), jnp.ones((n,)))
    for name in ("cube_trimesh", "hull"):
        s = sets[name]
        tiled = ShapeSet(jnp.tile(s.tag, (n,)), jnp.tile(s.params, (n, 1)),
                         s.vertices, s.indices, s.cluster_min, s.cluster_max,
                         kinds=s.kinds)
        arrays[f"ray.{name}"] = _np(jax.jit(ray.cast)(
            tiled, ident, jnp.asarray(o), jnp.asarray(d)))
        for boundary in (False, True):
            res = jax.jit(lambda s_, p_, x_, b=boundary: proj.project(
                s_, p_, x_, boundary=b))(tiled, ident, jnp.asarray(p))
            arrays[f"project.{name}.{boundary}.point"] = _np(res.point)
            arrays[f"project.{name}.{boundary}.inside"] = _np(res.is_inside)

    mn, mx = bvh_boxes()
    for k, v in zip(("left", "right", "node_min", "node_max", "order"),
                    native.build_bvh(mn, mx)):
        arrays[f"bvh.{k}"] = _np(v)


def standalone_scenes():
    """(name, shape set of body 0, dynamic body's shape, its start y) of
    the standalone cases: a ball of radius 0.4 over a bare triangle and
    over a wire (``tests/test_standalone_shapes.py``), and a convex
    polyhedron (a 0.3-cube's corners) 0.45 m over a ground slab whose
    top is at 0.1 m."""
    from wgmath_tpu.shapes import ShapeSet
    from wgmath_tpu.shapes.mesh import convex_polyhedron

    tri = ShapeSet.triangles([[[-2.0, 0.0, -2.0], [2.0, 0.0, -2.0],
                               [0.0, 0.0, 2.0]]])
    seg = ShapeSet.segments([[-2.0, 0.0, 0.0]], [[2.0, 0.0, 0.0]])
    ball = ShapeSet.balls(jnp.asarray([0.4], jnp.float32))
    ground = ShapeSet.cuboids(jnp.asarray([[3.0, 0.1, 3.0]], jnp.float32))
    return (("triangle", tri, ball, 0.55), ("segment", seg, ball, 0.5),
            ("convex", ground, convex_polyhedron(cube_corners(0.3)), 0.45))


def _drop_scene(base, body, y0):
    """``tests/test_standalone_shapes.py``'s two-body scene: ``base``
    static at the origin, ``body`` (a ball's or a polyhedron's mass
    properties) at (0, y0, 0)."""
    from wgmath_tpu.dynamics.body import (
        Bodies,
        Velocity,
        ball_local_mprops,
        cuboid_local_mprops,
    )
    from wgmath_tpu.geometry import sim as sim_ops
    from wgmath_tpu.pipeline import new_state
    from wgmath_tpu.scenes.builders import _merge_mprops
    from wgmath_tpu.shapes import ShapeSet
    from wgmath_tpu.shapes.shape import BALL

    shapes = ShapeSet.concat(base, body)
    trans = jnp.asarray([[0.0, 0.0, 0.0], [0.0, y0, 0.0]], jnp.float32)
    poses = sim_ops.from_parts(jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (2, 1)),
                               trans)
    mp_body = (ball_local_mprops(body.params[:, 0])
               if int(body.tag[0]) == BALL else
               cuboid_local_mprops(jnp.asarray([[0.3, 0.3, 0.3]],
                                               jnp.float32)))
    mp = _merge_mprops(
        cuboid_local_mprops(jnp.asarray([[1.0, 1.0, 1.0]], jnp.float32),
                            dynamic=jnp.asarray([False])), mp_body)
    return new_state(Bodies(poses, Velocity.zero(2, 3), mp), shapes)


STANDALONE_CFG = dict(pair_capacity=64, max_colors=4, manifold_points=1)


def export_standalone(arrays: dict) -> None:
    from wgmath_tpu.dynamics import SimParams
    from wgmath_tpu.pipeline import PipelineConfig, step

    params = SimParams()
    for name, base, body, y0 in standalone_scenes():
        mp = 4 if name == "convex" else 1
        cfg = PipelineConfig(**dict(STANDALONE_CFG, manifold_points=mp))
        st = _drop_scene(base, body, y0)
        trail = []
        for f in range(STANDALONE_FRAMES):
            st = step(st, params, cfg, warmstart=f > 0)
            trail.append(np.asarray(st.bodies.poses.translation[1]))
        arrays[f"standalone.{name}.trail"] = np.stack(trail)
        print(f"standalone {name}: end {trail[-1]}", flush=True)


def export_trimesh3(arrays: dict, t0: float) -> None:
    from export_joints_npz import export_case

    from wgmath_tpu.dynamics import SimParams
    from wgmath_tpu.pipeline import step_checked
    from wgmath_tpu.scenes.builders import SCENES

    st = SCENES["trimesh3"]()
    cfg = testbed_config(st.shapes)
    params = SimParams()
    for _ in range(TRIMESH3_LAND):
        st, cfg = step_checked(st, params, cfg)
    export_case("trimesh3", st, params, cfg, arrays, t0)


def _mesh_rows(state, cfg) -> np.ndarray:
    """The valid rows of the ball and the convex mesh batches in the
    (uncompacted) constraint buffer after a step."""
    valid = np.asarray(state.prev_constraints.valid)
    lo = cfg.pair_capacity
    mid = lo + cfg.mesh_pair_capacity * cfg.mesh_k_best
    return np.asarray([valid[lo:mid].sum(), valid[mid:].sum()], np.int32)


def export_mesh10k(arrays: dict, t0: float) -> None:
    from wgmath_tpu.dynamics import SimParams
    from wgmath_tpu.pipeline import PipelineConfig, step_checked

    st = mesh10k_scene()
    tr0 = np.asarray(st.bodies.poses.translation)
    cfg = dataclasses.replace(testbed_config(st.shapes),
                              **mesh10k_config())
    assert cfg.manifold_points == 4
    arrays["mesh10k.config_json"] = np.asarray(
        __import__("json").dumps(dataclasses.asdict(cfg)))
    params = SimParams()
    for f in range(MESH10K_FRAMES):
        st, cfg = step_checked(st, params, cfg)
        p = f"mesh10k.ref.{f}"
        arrays[f"{p}.pair_count"] = _np(st.pair_count)
        arrays[f"{p}.mesh_rows"] = _mesh_rows(st, cfg)
        if f in (0, MESH10K_FRAMES - 1):
            arrays[f"{p}.offset"] = (np.asarray(st.bodies.poses.translation)
                                     - tr0)
        if f == 0:
            # the convex batch's first 20,000 rows (the 5,000 cuboid pairs,
            # four triangles each): each row's distance and validity
            cons = st.prev_constraints
            mid = cfg.pair_capacity + cfg.mesh_pair_capacity * cfg.mesh_k_best
            rows = slice(mid, mid + 20_000)
            arrays[f"{p}.convex_dist"] = np.asarray(cons.info_dist[rows, 0])
            arrays[f"{p}.convex_valid"] = np.asarray(cons.valid[rows])
        print(f"mesh10k frame {f}: pair_count "
              f"{np.asarray(st.pair_count)[:8].tolist()} mesh rows "
              f"{arrays[f'{p}.mesh_rows'].tolist()} "
              f"({time.time() - t0:.0f} s)", flush=True)
    assert cfg == PipelineConfig(**{
        k: tuple(v) if k == "gs_windows" else v for k, v in __import__(
            "json").loads(str(arrays["mesh10k.config_json"])).items()})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=GROUPS)
    args = ap.parse_args()
    t0 = time.time()
    arrays = {}
    if args.only and os.path.exists(OUT):
        from wgmath_tpu_torch.convert import load_arrays

        arrays = {k: v for k, v in load_arrays(OUT).items()
                  if not k.startswith(f"{args.only}.")
                  and not (args.only == "unit" and k.split(".")[0] in (
                      "build", "sets", "topk", "contacts", "ray",
                      "project", "tri_gjk", "tri_pfm", "bvh"))}
    groups = (args.only,) if args.only else GROUPS
    if "unit" in groups:
        export_unit(arrays)
    if "standalone" in groups:
        export_standalone(arrays)
    if "trimesh3" in groups:
        export_trimesh3(arrays, t0)
    if "mesh10k" in groups:
        export_mesh10k(arrays, t0)
    savez_xz(OUT, slim(arrays))
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e3:.1f} kB, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
