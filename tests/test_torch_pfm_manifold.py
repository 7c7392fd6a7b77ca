"""The port's multi-point manifolds of support-mapped pairs
(``queries/pfm_manifold.py``), the narrow phase's support-mapped branch and
``auto_manifold_points`` against the JAX package, on the seeded inputs and
JAX results stored by ``scripts/export_gjk_npz.py`` in
``artifacts/gjk_pfm_jax.npz`` (``auto_manifold_points`` is host code, run
live).

Tolerances, and why: the support features' selections and counts exactly,
the cylinder's and cone's rim points within 2.4e-7 (XLA divides by the
rim's length through a reciprocal). ``feature_contacts`` and
``pfm_manifold`` fed the same normals as JAX: no iteration, so points and
distances within 1e-5 and the candidate masks exactly, but for a
candidate an ulp from its test (``d <= prediction``, a point on a
polygon's edge), at most 1 % of them (3 % of the manifolds for the
reduction's tangent extremes). Where the narrow phase computes
its own GJK / EPA contact, a pair's manifold follows its normal, so the
rule of ``tests/test_torch_gjk.py`` applies: the pair is held to JAX's
result where both lie within 1e-3 of the port's f64 run (the referee);
the others are counted and bounded.
"""

import os

import numpy as np
import pytest
import torch

from wgmath_tpu.pipeline import auto_manifold_points as jax_auto_points
from wgmath_tpu.shapes.shape import ShapeSet as JaxShapeSet
from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.convert import shapes_from_arrays, shapes_to_arrays
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import auto_manifold_points
from wgmath_tpu_torch.queries import gjk, pfm_manifold as pm
from wgmath_tpu_torch.queries.narrow_phase import narrow_phase
from wgmath_tpu_torch.shapes import shape as shp
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "gjk_pfm_jax.npz")
PRED = 0.002
RIM_ATOL = 2.4e-7
ATOL = 1e-5
SETTLED = 1e-3
FLIP_SHARE = 0.01
# the seeded manifolds: the reduction picks its last two points as the
# extremes along a tangent, where two candidates can lie an ulp apart
# (measured 16 of 794 manifolds with another pick)
PICK_SHARE = 0.03
NP_VARIANTS = {"dense": (4, 0), "compacted": (4, 512), "truncated": (4, 16),
               "p_max1": (1, 512), "p_max2": (2, 512)}


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return dict(f)


def _t(x, dtype=None):
    x = np.asarray(x)
    if x.dtype == np.int32:
        return torch.from_numpy(x).long()
    t = torch.from_numpy(x)
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


@pytest.mark.parametrize("tag", [shp.BALL, shp.CUBOID, shp.CAPSULE,
                                 shp.CYLINDER, shp.CONE, shp.TRIANGLE,
                                 shp.CONVEX])
def test_support_face_matches_jax(z, tag):
    verts, nv = pm.support_face(_t(z[f"face.{tag}.tag"]),
                                _t(z[f"face.{tag}.par"]),
                                _t(z[f"face.{tag}.d"]),
                                _t(z["face.vertices"]), _t(z["face.indices"]))
    np.testing.assert_array_equal(nv.numpy(), z[f"face.{tag}.nv"])
    atol = RIM_ATOL if tag in (shp.CYLINDER, shp.CONE) else 0.0
    np.testing.assert_allclose(verts.numpy(), z[f"face.{tag}.verts"],
                               rtol=0, atol=atol)
    if tag in (shp.CYLINDER, shp.CONE):
        assert {2, 4} <= set(nv.tolist())  # side / slant and cap / base


def _mask_rule(got, want, what):
    """Masks equal but for at most ``FLIP_SHARE`` of the entries."""
    flips = int((got != want).sum())
    assert flips <= FLIP_SHARE * got.size, (what, flips)
    return got & want


def _close_rule(got, want, what, share=FLIP_SHARE):
    """Within ``ATOL`` but for at most ``share`` of the rows (a candidate
    an ulp from a crossing's end takes another end)."""
    off = np.abs(got - want).reshape(len(got), -1).max(-1) > ATOL
    assert off.sum() <= share * len(off), (what, off.sum())


def _canonical(pts, dist, num):
    """A manifold's live slots in a fixed order (by depth, then the
    point's coordinates at 1e-4): points of equal depth may come in
    either order."""
    out_p, out_d = np.zeros_like(pts), np.full_like(dist, 1e9)
    for i in range(len(num)):
        k = int(num[i])
        key = np.c_[np.round(pts[i, :k], 4), np.round(dist[i, :k], 4)]
        order = np.lexsort(key.T[::-1])
        out_p[i, :k], out_d[i, :k] = pts[i, :k][order], dist[i, :k][order]
    return out_p, out_d


def test_feature_contacts_matches_jax(z):
    """The 26 candidates of each seeded pair's two features (JAX's, along
    JAX's normal): the masks, then the points and distances of the
    candidates both keep."""
    pts, dist, valid = pm.feature_contacts(
        _t(z["features.f1"]), _t(z["features.nv1"]), _t(z["features.f2"]),
        _t(z["features.nv2"]), _t(z["pairs.pfm_normal"]),
        _t(z["features.pred"]))
    both = _mask_rule(valid.numpy(), z["features.valid"], "valid")
    assert both.sum() > 500
    _close_rule(dist.numpy()[both], z["features.dist"][both], "dist")
    _close_rule(pts.numpy()[both], z["features.pts"][both], "pts")
    # every group yields candidates somewhere
    for group in (slice(0, 4), slice(4, 8), slice(8, 24), slice(24, 26)):
        assert valid.numpy()[:, group].any()


def _manifold_args(z, prefix):
    g = lambda k: _t(z[f"{prefix}.{k}"])  # noqa: E731
    one = torch.ones(g("tag_a").shape[0])
    return (g("tag_a"), g("par_a"), Sim(g("qa"), g("ta"), one), g("tag_b"),
            g("par_b"), Sim(g("qb"), g("tb"), one))


@pytest.mark.parametrize("case", ["capsule_on_floor", "cylinder_cap_on_floor",
                                  "parallel_capsules", "crossed_capsules"])
def test_pfm_manifold_cases_match_jax(z, case):
    """The four cases of ``tests/test_pfm_manifold.py`` end to end (the
    port's own contact, then its manifold) against JAX's, and what each
    case asserts there."""
    pre = f"manifold.{case}"
    args = _manifold_args(z, pre)
    n_p, p_p, d_p, _ = gjk.pfm_contact(*args)
    pts, dist, num = pm.pfm_manifold(*args, n_p, p_p, d_p, 0.01)
    for got, key in ((n_p, "n"), (p_p, "p"), (d_p, "d")):
        np.testing.assert_allclose(got.numpy(), z[f"{pre}.{key}"], rtol=0,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(num.numpy(), z[f"{pre}.num"])
    for g, w in zip(_canonical(pts.numpy(), dist.numpy(), num.numpy()),
                    _canonical(z[f"{pre}.points"], z[f"{pre}.dist"],
                               z[f"{pre}.num"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    n, pts, dist = int(num[0]), pts[0].numpy(), dist[0].numpy()
    live = dist < 1e8
    assert np.count_nonzero(live) == n
    if case == "capsule_on_floor":
        assert n >= 2
        np.testing.assert_allclose(dist[live], -0.05, atol=1e-3)
        ys = np.sort(pts[live][:, 1])
        assert ys[0] < -0.9 and ys[-1] > 0.9
        np.testing.assert_allclose(
            np.linalg.norm(pts[live][:, [0, 2]], axis=-1), 0.25, atol=1e-3)
    elif case == "cylinder_cap_on_floor":
        assert n == 4
        np.testing.assert_allclose(dist[live], -0.02, atol=2e-3)
        assert np.all(pts[live][:, 1] < -0.45)
        rad = np.linalg.norm(pts[live][:, [0, 2]], axis=-1)
        assert np.count_nonzero(rad > 0.35) >= 3
    elif case == "parallel_capsules":
        assert n >= 2
        np.testing.assert_allclose(np.sort(dist[live])[:2], -0.05, atol=1e-3)
    else:
        assert 1 <= n <= 2 and abs(float(d_p[0]) + 0.05) < 1e-3


def test_pfm_manifold_seeded_pairs_match_jax(z):
    """Every seeded pair's manifold on JAX's contact (normal, witness and
    distance): the counts, then the points and distances of the slots
    both fill."""
    g = lambda k: _t(z[f"pairs.{k}"])  # noqa: E731
    args = (g("tag_a"), g("par_a"), Sim(g("qa"), g("ta"), g("sa")),
            g("tag_b"), g("par_b"), Sim(g("qb"), g("tb"), g("sb")))
    pts, dist, num = pm.pfm_manifold(*args, g("pfm_normal"), g("pfm_point"),
                                     g("pfm_dist"), PRED)
    same = num.numpy() == z["manifold.pairs.num"]
    assert (~same).sum() <= FLIP_SHARE * len(same), (~same).sum()
    assert (num.numpy() >= 1).all() and (num.numpy() == 4).any()
    g_p, g_d = _canonical(pts.numpy()[same], dist.numpy()[same],
                          num.numpy()[same])
    w_p, w_d = _canonical(z["manifold.pairs.points"][same],
                          z["manifold.pairs.dist"][same],
                          z["manifold.pairs.num"][same])
    _close_rule(g_d, w_d, "dist", PICK_SHARE)
    _close_rule(g_p, w_p, "points", PICK_SHARE)


def _scene(z, dtype=torch.float32):
    g = lambda k: _t(z[f"narrow.{k}"], dtype)  # noqa: E731
    pose = Sim(g("q"), g("tr"), g("scale"))
    pairs = PairList(g("a"), g("b"), g("valid"),
                     torch.tensor(int(z["narrow.count"])))
    tag = g("shapes.tag")
    shapes = shp.ShapeSet(tag, g("shapes.params"),
                          torch.zeros((0, 3), dtype=dtype),
                          torch.zeros((0, 3), dtype=torch.int64),
                          kinds=frozenset(int(k) for k in tag.unique()))
    return pose, shapes, pairs


def _narrow(z, name, dtype=torch.float32):
    p, cap = NP_VARIANTS[name]
    return narrow_phase(*_scene(z, dtype), PRED, p_max=p, sat_capacity=512,
                        pfm_capacity=cap, bc_capacity=64, with_overflow=True)


@pytest.fixture(scope="module")
def narrow_runs(z):
    return {name: (_narrow(z, name), _narrow(z, name, torch.float64))
            for name in NP_VARIANTS}


@pytest.mark.parametrize("name", list(NP_VARIANTS))
def test_narrow_phase_pfm_branch_matches_jax(z, narrow_runs, name):
    """The narrow phase over a turned, jittered lattice of the five kinds
    over the ground: the support-mapped pairs dense, compacted into 512,
    past a capacity of 16 (the true count returned, the pairs past it get
    no manifold), and at ``p_max`` 1 and 2. The demands exactly; each pair's
    count, validity, first distance and normal as JAX's where the pair is
    settled."""
    (c, need), (c64, _) = narrow_runs[name]
    np.testing.assert_array_equal(need.numpy(), z[f"narrow.{name}.need"])
    for f in ("body_a", "body_b"):
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      z[f"narrow.{name}.{f}"])
    w = lambda f: z[f"narrow.{name}.{f}"]  # noqa: E731
    d, d64, dw = c.dist.numpy(), c64.dist.numpy(), w("dist")
    settled = ((np.abs(d - d64).max(-1) <= SETTLED)
               & (np.abs(dw - d64).max(-1) <= SETTLED))
    assert (~settled).sum() <= 0.05 * len(d), (~settled).sum()
    for f in ("num_points", "valid"):
        np.testing.assert_array_equal(getattr(c, f).numpy()[settled],
                                      w(f)[settled], err_msg=f)
    np.testing.assert_allclose(d[settled], dw[settled], rtol=0, atol=SETTLED)
    live = settled & (dw[:, 0] < PRED)
    np.testing.assert_allclose(c.normal_a.numpy()[live], w("normal_a")[live],
                               rtol=0, atol=2e-3)
    tag = z["narrow.shapes.tag"]
    ta, tb = tag[z["narrow.a"]], tag[z["narrow.b"]]
    pfm = ((ta >= shp.CAPSULE) | (tb >= shp.CAPSULE)) & z["narrow.valid"]
    assert int(need[2]) == (int(pfm.sum()) if NP_VARIANTS[name][1] else 0)
    if name == "truncated":
        rows = np.nonzero(pfm)[0]
        assert len(rows) > 16
        assert (c.num_points.numpy()[rows[16:]] == 0).all()
        assert (c.num_points.numpy()[rows[:16]] > 0).any()
    assert (c.num_points <= NP_VARIANTS[name][0]).all()
    if name == "compacted":
        assert (c.num_points.numpy()[pfm] >= 2).any()


def test_narrow_phase_keeps_the_deepest_pfm_points(narrow_runs):
    """``p_max`` 2: each support-mapped manifold keeps the two deepest of
    its 4-point manifold (``top_k_desc``, equal depths in slot order)."""
    full, two = narrow_runs["compacted"][0][0], narrow_runs["p_max2"][0][0]
    want, idx = torch.sort(-full.dist, dim=-1, descending=True, stable=True)
    assert torch.equal(two.dist, -want[:, :2])
    assert torch.equal(two.points_a, torch.gather(
        full.points_a, 1, idx[:, :2, None].expand(-1, -1, 3)))
    assert torch.equal(two.num_points, torch.clamp(full.num_points, max=2))


def test_narrow_phase_refuses_other_kinds(z):
    """A polyline in 3D is refused (its contacts are 2D: a 2D step takes
    it, ``tests/test_torch_planar.py``); the standalone segment, triangle
    and convex kinds and the trimesh, once refused, are taken, and
    declaring one that no row holds changes no contact."""
    pose, shapes, pairs = _scene(z)
    want, _ = narrow_phase(pose, shapes, pairs, PRED, p_max=4,
                           with_overflow=True)
    for kind in (shp.SEGMENT, shp.TRIANGLE, shp.CONVEX, shp.TRIMESH,
                 shp.POLYLINE):
        odd = shp.ShapeSet(shapes.tag, shapes.params, shapes.vertices,
                           shapes.indices, kinds=shapes.kinds | {kind})
        if kind == shp.POLYLINE:
            with pytest.raises(NotImplementedError, match="in 3D"):
                narrow_phase(pose, odd, pairs, PRED, p_max=4)
            continue
        got, _ = narrow_phase(pose, odd, pairs, PRED, p_max=4,
                              with_overflow=True)
        for f in ("normal_a", "points_a", "dist", "num_points", "valid"):
            assert torch.equal(getattr(got, f), getattr(want, f)), (kind, f)


def test_auto_manifold_points_matches_jax():
    """Mixed scenes of the five kinds, each with no mask, its own dynamic
    mask, an all-static one and a mask whose only dynamic bodies are
    balls."""
    import jax.numpy as jnp

    r = jnp.full((3,), 0.4)
    he = jnp.full((3, 3), 0.4)
    sets = {
        "capsules_on_ground": JaxShapeSet.concat(
            JaxShapeSet.cuboids(he[:1]), JaxShapeSet.capsules(r, r)),
        "cones_and_balls": JaxShapeSet.concat(JaxShapeSet.cones(r, r),
                                              JaxShapeSet.balls(r)),
        "cylinders_on_cuboids": JaxShapeSet.concat(
            JaxShapeSet.cuboids(he), JaxShapeSet.cylinders(r, r)),
        "balls_on_ground": JaxShapeSet.concat(JaxShapeSet.cuboids(he[:1]),
                                              JaxShapeSet.balls(r)),
        "all_five": JaxShapeSet.concat(
            JaxShapeSet.cuboids(he[:1]), JaxShapeSet.balls(r),
            JaxShapeSet.capsules(r, r), JaxShapeSet.cylinders(r, r),
            JaxShapeSet.cones(r, r)),
    }
    for name, js in sets.items():
        tags = np.asarray(js.tag)
        n = len(tags)
        shapes = shapes_from_arrays(shapes_to_arrays(js), device="cpu")
        for mask in (None, np.arange(n) > 0, np.zeros(n, bool),
                     tags == shp.BALL):
            want = jax_auto_points(js, 3, None if mask is None else mask)
            assert auto_manifold_points(shapes, 3, mask) == want, name
            if mask is not None:
                assert auto_manifold_points(
                    shapes, 3, torch.from_numpy(mask)) == want, name
    assert auto_manifold_points(shapes_from_arrays(shapes_to_arrays(
        sets["capsules_on_ground"]), device="cpu"), 3) == 4
    # 2D: the capsules take one point (the 2D support-mapped branch has no
    # clip), a movable cuboid on the ground two, as JAX's
    import jax.numpy as jnp2

    flat = JaxShapeSet.concat(JaxShapeSet.cuboids(jnp2.full((2, 2), 0.4)),
                              JaxShapeSet.capsules(r, r, dim=2))
    got = shapes_from_arrays(shapes_to_arrays(flat), device="cpu")
    for mask in (None, np.arange(5) > 0, np.arange(5) > 1):
        assert auto_manifold_points(got, 2, mask) == jax_auto_points(
            flat, 2, mask)
