"""The port's meshes, convex polyhedra and standalone segment / triangle
colliders (``shapes/mesh.py``, ``shapes/shape.py``,
``queries/mesh_accel.py``, ``queries/mesh_contact.py``, the mesh and
convex routes of ``queries/gjk.py``, ``ray.py`` and ``projection.py``,
``native.build_bvh``) against the JAX package's results stored in
``artifacts/mesh_jax.npz.xz`` (``JAX_PLATFORMS=cpu python
scripts/export_mesh_npz.py --only unit`` rewrites them) on the seeded
inputs of ``tests/mesh_inputs.py``; the cheap constructors are run live.

Tolerances, and why:

- every buffer a constructor builds, bit for bit (their SHA-1 digests);
- the triangle ids of ``_topk_by_score``, on the dense and on the
  clustered route, exactly, equal scores ordered as ``lax.top_k`` orders
  them; their scores within 1e-6 (the projections' arithmetic is JAX's,
  and XLA may contract an ``a*b+c``, ROADMAP C4);
- the ball contacts: ids and validity exactly, points, normals and
  distances within 1e-5;
- the convex contacts and the triangle GJK: ids and validity exactly;
  distances and points within ``tests/test_torch_gjk.py``'s GJK_ATOL
  (1e-4), normals within its NORMAL_ATOL (2e-3), on pairs whose cores
  do not touch (GJK in f32 may take another simplex on a touching pair,
  as that file states);
- ray times within rtol 1e-5, projections within 1e-5 (1e-3 for the EPA
  exits of the convex projection, EPA stopping at a 1e-4 gap)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from tests.test_torch_gjk import _settled_rule
from tests.mesh_inputs import (
    LARGE_FIELD,
    SMALL_FIELD,
    bvh_boxes,
    contact_scene,
    cube_mesh,
    digest,
    field_heights,
    field_rays,
    query_inputs,
    random_hull,
    topk_points,
    tri_pairs,
)
from wgmath_tpu_torch import native
from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.convert import load_arrays
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries import gjk, mesh_accel, mesh_contact
from wgmath_tpu_torch.queries import projection as proj
from wgmath_tpu_torch.queries import ray
from wgmath_tpu_torch.shapes import shape as shp
from wgmath_tpu_torch.shapes.mesh import (
    convex_polyhedron,
    heightfield,
    polyline,
    trimesh,
)
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "mesh_jax.npz.xz")
SHAPE_FIELDS = ("tag", "params", "vertices", "indices", "cluster_min",
                "cluster_max")
ROUTES = {"dense": SMALL_FIELD, "clustered": LARGE_FIELD}
GJK_ATOL, NORMAL_ATOL = 1e-4, 2e-3


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def _field(spec):
    h = field_heights(spec["n"], seed=spec["seed"])
    return h, heightfield(h, spec["spacing"], spec["spacing"], device="cpu")


def _ident(n):
    rot = torch.zeros((n, 4))
    rot[:, 3] = 1.0
    return Sim(rot, torch.zeros((n, 3)), torch.ones(n))


def _tiled(s: shp.ShapeSet, n: int) -> shp.ShapeSet:
    """``n`` colliders that are all ``s``'s one mesh."""
    return shp.ShapeSet(s.tag.repeat(n), s.params.repeat(n, 1), s.vertices,
                        s.indices, s.cluster_min, s.cluster_max,
                        kinds=s.kinds)


def _sets():
    v_cube, f_cube = cube_mesh()
    out = {"cube_trimesh": trimesh(v_cube, f_cube, device="cpu"),
           "hull": convex_polyhedron(random_hull(), device="cpu"),
           "small_field": _field(SMALL_FIELD)[1],
           "large_field": _field(LARGE_FIELD)[1]}
    out["concat"] = shp.ShapeSet.concat(
        out["small_field"], shp.ShapeSet.balls(torch.ones(2)),
        out["large_field"], out["hull"])
    return out


def test_build_clusters_matches_jax(z):
    rng = np.random.default_rng(1)
    verts = rng.standard_normal((500, 3)).astype(np.float32)
    tris = rng.integers(0, 500, (301, 3)).astype(np.int32)
    out = mesh_accel.build_clusters(verts, tris, margin=0.02)
    for k, v in zip(("indices", "cmin", "cmax"), out):
        assert str(digest(v)) == str(z[f"build.{k}"]), k
    assert len(out[0]) % mesh_accel.MESH_LEAF == 0
    assert len(out[1]) * mesh_accel.MESH_LEAF == len(out[0])


@pytest.mark.parametrize("name", ["cube_trimesh", "hull", "small_field",
                                  "large_field", "concat"])
def test_mesh_constructors_match_jax(z, name):
    s = _sets()[name]
    for f in SHAPE_FIELDS:
        assert str(digest(getattr(s, f).numpy())) == str(
            z[f"sets.{name}.{f}"]), f
    assert sorted(s.kinds) == z[f"sets.{name}.kinds"].tolist()


def test_standalone_constructors_and_vertex_map_match_jax():
    """Segments, triangles, a polyline and ``concat``'s rebasing, the
    per-vertex collider map and the world vertex buffer, against the JAX
    package's constructors run live (eager jnp, no compile)."""
    import jax.numpy as jnp

    from wgmath_tpu.geometry.sim import Sim as JSim
    from wgmath_tpu.shapes import shape as jshp
    from wgmath_tpu.shapes.mesh import polyline as jpolyline

    rng = np.random.default_rng(14)
    a, b = (rng.normal(size=(3, 3)).astype(np.float32) for _ in range(2))
    tv = rng.normal(size=(2, 3, 3)).astype(np.float32)
    pl = rng.normal(size=(5, 3)).astype(np.float32)
    for closed in (False, True):  # a 3D wire: its own index width
        ours, theirs = (polyline(pl, closed=closed, device="cpu"),
                        jpolyline(pl, closed=closed))
        for f in SHAPE_FIELDS:
            np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                          np.asarray(getattr(theirs, f)), f)
    ours = shp.ShapeSet.concat(
        shp.ShapeSet.segments(torch.from_numpy(a), torch.from_numpy(b)),
        shp.ShapeSet.triangles(torch.from_numpy(tv)),
        shp.ShapeSet.balls(torch.ones(2)),
        shp.ShapeSet.triangles(torch.from_numpy(tv[::-1].copy())))
    theirs = jshp.ShapeSet.concat(
        jshp.ShapeSet.segments(a, b), jshp.ShapeSet.triangles(tv),
        jshp.ShapeSet.balls(jnp.ones((2,))),
        jshp.ShapeSet.triangles(tv[::-1].copy()))
    for f in SHAPE_FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(),
                                      np.asarray(getattr(theirs, f)), f)
    assert ours.kinds == theirs.kinds
    np.testing.assert_array_equal(
        shp.local_aabb_half_extents(ours, 3).numpy(),
        np.asarray(jshp.local_aabb_half_extents(theirs, 3)))
    n = ours.num_shapes
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    ids = shp.vertex_collider_ids(ours)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jshp.vertex_collider_ids(theirs)))
    assert (ids >= 0).all()  # every row belongs to a triangle
    got = shp.world_vertex_buffer(ours, Sim(torch.from_numpy(q),
                                            torch.from_numpy(t),
                                            torch.ones(n)))
    want = jshp.world_vertex_buffer(theirs, JSim(jnp.asarray(q),
                                                 jnp.asarray(t),
                                                 jnp.ones((n,))))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert shp.vertex_window(ours) == 3


def test_concat_refuses_misaligned_clusters():
    hf = _field(SMALL_FIELD)[1]
    cut = dataclasses.replace(hf, indices=hf.indices[:-1])
    with pytest.raises(ValueError, match="one cluster per"):
        shp.ShapeSet.concat(cut, shp.ShapeSet.balls(torch.ones(1)))


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("cut", ["far", "near"])
def test_topk_ids_match_jax(z, route, cut):
    """``_topk_by_score`` with the ball score on both routes: the ids
    exactly (points over shared edges and vertices tie), the scores within
    1e-6; ``near`` stops the rounds at a 0.05 score as the contacts do."""
    spec = ROUTES[route]
    h, field = _field(spec)
    assert mesh_accel.use_clusters(field) == (route == "clustered")
    pts = torch.from_numpy(topk_points(h, spec["spacing"]))
    n_q = pts.shape[0]
    radius = torch.from_numpy(np.random.default_rng(12).uniform(
        0.05, 0.3, n_q).astype(np.float32))
    first = torch.zeros(n_q, dtype=torch.int64)
    num = torch.full((n_q,), int(field.params[0, 3]), dtype=torch.int64)
    active = torch.from_numpy(np.arange(n_q) % 7 != 3)

    def score_fn(pt, va, vb, vc):
        return mesh_contact._tri_dist(pt, va, vb, vc) - radius[:, None]

    rounds = []
    ids, s = mesh_contact._topk_by_score(
        field, first, num, pts, active, 4, score_fn, radius,
        1e8 if cut == "far" else 0.05, rounds=rounds)
    key = f"topk.{route}.{cut}"
    np.testing.assert_array_equal(ids.numpy(), z[f"{key}.ids"])
    np.testing.assert_allclose(s.numpy(), z[f"{key}.scores"], rtol=0,
                               atol=1e-6)
    if route == "clustered":
        assert len(rounds) == 1 and rounds[0] >= 1
        # a tie is there to be broken: some edge point scores two equal
        assert (s[48:56, 0] == s[48:56, 1]).any()


def _contact_case(route):
    spec = ROUTES[route]
    h, field = _field(spec)
    trans, q, r, he, hh, cr = contact_scene(h, spec["spacing"])
    hulls = [convex_polyhedron(random_hull(5 + i), device="cpu")
             for i in range(4)]
    shapes = shp.ShapeSet.concat(
        field, shp.ShapeSet.balls(torch.full((4,), r)),
        shp.ShapeSet.cuboids(torch.full((4, 3), he)),
        shp.ShapeSet.capsules(torch.full((4,), hh), torch.full((4,), cr)),
        *hulls)
    poses = Sim(torch.from_numpy(q), torch.from_numpy(trans),
                torch.ones(17))
    pairs = PairList(torch.zeros(20, dtype=torch.int64),
                     torch.from_numpy(np.r_[np.arange(1, 17), 0, 0, 0, 0]),
                     torch.arange(20) < 16, torch.tensor(16))
    return shapes, poses, pairs


def _contacts_close(z, key, c, atol, normal_atol, off_rows=0):
    """Ids, validity and point counts exactly; on the rows valid in both,
    distances within ``atol``, normals within ``normal_atol`` and each
    point on JAX's contact plane within ``atol`` (a face contact's witness
    may lie anywhere on the face), but for at most ``off_rows`` rows."""
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      z[f"{key}.{f}"], f)
    v = c.valid.numpy()
    assert v.sum() > 4
    n_j = z[f"{key}.normal_a"][v]
    off = ((np.abs(c.dist[:, 0].numpy()[v] - z[f"{key}.dist"][v]) > atol)
           | (np.abs(c.normal_a.numpy()[v] - n_j).max(-1) > normal_atol)
           | (np.abs(np.sum((c.points_a[:, 0].numpy()[v]
                             - z[f"{key}.point"][v]) * n_j, -1)) > atol))
    assert off.sum() <= off_rows, np.nonzero(off)


@pytest.mark.parametrize("route", ROUTES)
def test_mesh_ball_contacts_match_jax(z, route):
    shapes, poses, pairs = _contact_case(route)
    c = mesh_contact.mesh_ball_contacts(poses, shapes, pairs, 0.05,
                                        pair_cap=8, k_best=4)
    _contacts_close(z, f"contacts.{route}.ball", c, 1e-5, 1e-5)
    np.testing.assert_allclose(c.points_a[:, 0].numpy(),
                               z[f"contacts.{route}.ball.point"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_mesh_convex_contacts_match_jax(z, route):
    """Cuboids, capsules and convex polyhedra on the field: per-triangle
    GJK without EPA, each triangle dilated by the margin. One row a case
    may leave JAX's numbers: f32 GJK may take another simplex on a pair
    (ROADMAP C9; measured: one row of 57, dense route)."""
    shapes, poses, pairs = _contact_case(route)
    assert shp.vertex_window(shapes) == 12  # the hulls' vertex ranges
    c = mesh_contact.mesh_convex_contacts(poses, shapes, pairs, 0.05,
                                          pair_cap=16, k_best=4)
    _contacts_close(z, f"contacts.{route}.convex", c, GJK_ATOL,
                    NORMAL_ATOL, off_rows=1)
    d = mesh_contact.mesh_pair_demand(shapes, pairs)
    assert d.tolist() == [4, 12]


def _tri_args():
    tri, tb, qb = tri_pairs()
    n = len(tri)
    hull = convex_polyhedron(random_hull(13), device="cpu")
    tags = np.asarray([1, 2, 9] * n)[:n]
    par_b = torch.zeros((n, 8))
    par_b[torch.from_numpy(tags == 1), :3] = 0.2
    par_b[torch.from_numpy(tags == 2), :2] = torch.tensor([0.2, 0.1])
    par_b[torch.from_numpy(tags == 9)] = hull.params[0]
    args = (torch.full((n,), 6, dtype=torch.int64), torch.zeros((n, 8)),
            _ident(n), torch.from_numpy(tags), par_b,
            Sim(torch.from_numpy(qb), torch.from_numpy(tb), torch.ones(n)))
    return args, torch.from_numpy(tri), hull


def test_triangle_gjk_and_no_epa_contact_match_jax(z):
    """``gjk_distance`` with a triangle a pair, and ``pfm_contact`` with
    it, its margin and no EPA (the overlapping pairs pushed along the
    centre axis), on triangles against cuboids, capsules and polyhedra
    (the card's sync-free GJK giving the CPU's bits),
    under ``tests/test_torch_gjk.py``'s referee rule: the port run in f64
    decides which pairs are settled, and f32 JAX leaves it on some (here 3
    of 64 pairs reported overlapping 0.008-0.177 m apart: ROADMAP C9). The
    windowed support gives the dense support's bits."""
    args, tri, hull = _tri_args()
    res = gjk.gjk_distance(*args, vertices=hull.vertices, tri_verts_a=tri)
    card_form = gjk.gjk_distance(*args, vertices=hull.vertices,
                                 tri_verts_a=tri, sync_free=True)
    for k in vars(res):  # the card's fixed loop: the early exit's bits
        assert torch.equal(getattr(res, k), getattr(card_form, k)), k
    a64 = [(x.double() if x.is_floating_point() else x)
           if torch.is_tensor(x) else Sim(*(y.double() for y in (
               x.rotation, x.translation, x.scale))) for x in args]
    ref = gjk.gjk_distance(*a64, vertices=hull.vertices.double(),
                           tri_verts_a=tri.double())
    dist = _settled_rule(res.distance.numpy(), z["tri_gjk.distance"],
                         ref.distance.numpy(), GJK_ATOL, "tri distance",
                         0.1)
    inter = z["tri_gjk.intersecting"]
    assert torch.equal(res.intersecting, ref.intersecting)
    assert np.array_equal(res.intersecting.numpy()[dist], inter[dist])
    sep = dist & ~inter
    assert sep.sum() > 10 and (dist & inter).sum() > 10
    for f in ("point_a", "point_b"):
        np.testing.assert_allclose(getattr(res, f).numpy()[sep],
                                   z[f"tri_gjk.{f}"][sep], rtol=0,
                                   atol=GJK_ATOL, err_msg=f)
    np.testing.assert_allclose(res.normal.numpy()[sep],
                               z["tri_gjk.normal"][sep], rtol=0,
                               atol=NORMAL_ATOL)
    out = gjk.pfm_contact(*args, vertices=hull.vertices, tri_verts_a=tri,
                          tri_margin=0.02, use_epa=False)
    windowed = gjk.pfm_contact(*args, vertices=hull.vertices,
                               tri_verts_a=tri, tri_margin=0.02,
                               use_epa=False,
                               window=shp.vertex_window(hull))
    for a, b in zip(out, windowed):
        assert torch.equal(a, b)
    assert int(out[3]) == int(ref.intersecting.sum())  # the pushes
    np.testing.assert_allclose(out[2].numpy()[dist],
                               z["tri_pfm.dist"][dist], rtol=0,
                               atol=GJK_ATOL)
    np.testing.assert_allclose(out[1].numpy()[sep], z["tri_pfm.point"][sep],
                               rtol=0, atol=GJK_ATOL)
    # the overlapping pairs' normal is the centre axis
    deep = dist & inter
    np.testing.assert_allclose(out[0].numpy()[deep],
                               z["tri_pfm.normal"][deep], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[0].numpy()[sep], z["tri_pfm.normal"][sep],
                               rtol=0, atol=NORMAL_ATOL)


@pytest.mark.parametrize("route", ROUTES)
def test_field_cast_and_projection_match_jax(z, route):
    """Rays from above and boundary projections on a field: the dense
    sweep, or the clustered rounds (one host read a round)."""
    spec = ROUTES[route]
    h, field = _field(spec)
    o, d = field_rays(h, spec["spacing"])
    n = len(o)
    t = ray.cast(_tiled(field, n), _ident(n), torch.from_numpy(o),
                 torch.from_numpy(d))
    want = z[f"ray.{route}"]
    np.testing.assert_array_equal(np.isfinite(t.numpy()), np.isfinite(want))
    assert np.isfinite(want).sum() > n // 2
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-5, atol=1e-6)
    p = proj.project(_tiled(field, n), _ident(n),
                     torch.from_numpy(o * 0.3), boundary=True)
    np.testing.assert_allclose(p.point.numpy(), z[f"project.{route}"],
                               rtol=0, atol=1e-5)
    assert not p.is_inside.any()


@pytest.mark.parametrize("name", ["cube_trimesh", "hull"])
def test_convex_and_trimesh_queries_match_jax(z, name):
    """The CONVEX cast over the hull's faces and the trimesh cast; the
    projections: GJK / EPA on the polyhedron, the nearest triangle on the
    cube mesh."""
    s = _tiled(_sets()[name], 128)
    o, d, p = query_inputs()
    n = len(o)
    t = ray.cast(s, _ident(n), torch.from_numpy(o), torch.from_numpy(d))
    want = z[f"ray.{name}"]
    np.testing.assert_array_equal(np.isfinite(t.numpy()), np.isfinite(want))
    np.testing.assert_allclose(t.numpy(), want, rtol=1e-5, atol=1e-6)
    for boundary in (False, True):
        res = proj.project(s, _ident(n), torch.from_numpy(p),
                           boundary=boundary)
        key = f"project.{name}.{boundary}"
        np.testing.assert_array_equal(res.is_inside.numpy(),
                                      z[f"{key}.inside"])
        tol = 1e-3 if name == "hull" else 1e-5
        np.testing.assert_allclose(res.point.numpy(), z[f"{key}.point"],
                                   rtol=0, atol=tol)


def test_support_window_gives_the_dense_arg_max():
    """``support_core``'s vertex window against its dense arg-max over the
    whole buffer, on convex ranges inside a buffer a field fills."""
    rng = np.random.default_rng(15)
    hull = convex_polyhedron(random_hull(16), device="cpu")
    shapes = shp.ShapeSet.concat(_field(SMALL_FIELD)[1], hull, hull)
    rows = torch.tensor([2, 1, 0, 2])
    d = torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))
    tag, par = shapes.tag[rows], shapes.params[rows]
    dense = gjk.support_core(tag, par, d, shapes.vertices)
    win = gjk.support_core(tag, par, d, shapes.vertices,
                           window=shp.vertex_window(shapes))
    assert shp.vertex_window(shapes) == 12
    for a, b in zip(dense, win):
        assert torch.equal(a, b)


def test_build_bvh_matches_twin_and_jax(z):
    mn, mx = bvh_boxes()
    lib = native.build_bvh(mn, mx)
    twin = native.build_bvh_plain(mn, mx)
    for k, a, b in zip(("left", "right", "node_min", "node_max", "order"),
                       lib, twin):
        np.testing.assert_array_equal(a, b, k)
        np.testing.assert_array_equal(a, z[f"bvh.{k}"], k)
    one = native.build_bvh(mn[:1], mx[:1])
    assert one[4].tolist() == [0] and np.array_equal(one[2], mn[:1])
    with pytest.raises(ValueError, match="at least one box"):
        native.build_bvh(mn[:0], mx[:0])

