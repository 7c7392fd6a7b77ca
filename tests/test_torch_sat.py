"""The port's cuboid-cuboid SAT manifolds, the narrow phase's cuboid branch
and ``auto_manifold_points`` against the JAX package on the same seeded
inputs. The JAX package's results (one jitted call per batch shape) are
read from ``artifacts/torch_sat_jax.npz.xz``, with the JAX scene builder's
lattice and shapes (``JAX_PLATFORMS=cpu python
scripts/export_port_tests_npz.py --only sat`` rewrites it from this
file's input helpers), so this file imports no JAX.

Tolerances: point counts, chosen axes (through the normals' signs and the
counts) and every integer exactly. Reals within atol 2e-5, rtol 1e-5: XLA
on the CPU contracts ``a*b+c`` into one rounding where PyTorch rounds the
product (ROADMAP C4), which moves the composed rotation of a general pose
by an ulp; on 2,000 seeded pairs the largest gap was 4.3e-6 m. On
axis-aligned poses of unit scale every product is exact, so the aligned
lattice, where separations tie, is held bit for bit."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.convert import (
    load_arrays,
    shapes_from_arrays,
    shapes_to_arrays,
)
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import auto_manifold_points
from wgmath_tpu_torch.queries.narrow_phase import narrow_phase
from wgmath_tpu_torch.queries.sat import cuboid_cuboid_manifold
from wgmath_tpu_torch.shapes.shape import ShapeSet

PRED = 0.002
RTOL, ATOL = 1e-5, 2e-5
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "torch_sat_jax.npz.xz")
NARROW_FIELDS = ("body_a", "body_b", "valid", "num_points", "normal_a",
                 "points_a", "dist")


@pytest.fixture(scope="module")
def z():
    return load_arrays(NPZ)


def _quats(rng, n, angle):
    """Rotations of angle up to ``angle`` about seeded axes (xyzw)."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * rng.uniform(-angle, angle, (n, 1))
    return np.concatenate([axis * np.sin(half), np.cos(half)],
                          -1).astype(np.float32)


def _identity(n):
    return np.tile(np.float32([0, 0, 0, 1]), (n, 1))


def _cases():
    """Seeded pair batches by case: (qa, ta, sa, qb, tb, sb, ha, hb)."""
    rng = np.random.default_rng(12)
    one = np.ones(1, np.float32)
    cases = {}

    def single(tb, qb=None, ha=0.5, hb=0.5):
        return (_identity(1), np.zeros((1, 3), np.float32), one,
                _identity(1) if qb is None else qb,
                np.float32([tb]), one, np.full((1, 3), ha, np.float32),
                np.full((1, 3), hb, np.float32))

    # unit boxes stacked with 0.1 of overlap (tests/test_queries.py)
    cases["stacked"] = single([0.0, 0.9, 0.0])
    cases["separated"] = single([0.0, 2.0, 0.0])
    cases["offset_overlap"] = single([0.6, 0.95, 0.3])
    q45 = np.float32([[0.0, 0.0, np.sin(np.pi / 8), np.cos(np.pi / 8)]])
    cases["rotated_edge"] = single([0.0, 0.5 + 0.5 * np.sqrt(2) - 0.05, 0.0],
                                   q45)
    # edge across edge: B turned 45° about y and x, its lowest edge on A's
    # top edge region
    q_xy = np.float32([[np.sin(np.pi / 8), 0.0, 0.0, np.cos(np.pi / 8)]])
    cases["edge_edge"] = single([0.3, 1.15, 0.0], q_xy)
    # an aligned lattice of equal cubes, touching along x, 0.005 deep
    # along y and 0.02 apart along z, every neighbour pair (sideways,
    # diagonal, above): the separations of A's and B's faces tie exactly
    g = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                             indexing="ij"), -1).reshape(-1, 3)
    pos = (g * np.float32([1.0, 0.995, 1.02])).astype(np.float32)
    ia, ib = np.triu_indices(len(g), 1)
    near = np.abs(g[ia] - g[ib]).max(-1) == 1
    ia, ib = ia[near], ib[near]
    n = len(ia)
    he = np.full((n, 3), 0.5, np.float32)
    ones = np.ones(n, np.float32)
    cases["aligned_ties"] = (_identity(n), pos[ia], ones, _identity(n),
                             pos[ib], ones, he, he)
    # seeded general pairs, unit scale, then scaled poses and deep cores
    n = 256
    ta = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    ha = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    hb = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    cases["general"] = (_quats(rng, n, np.pi), ta, np.ones(n, np.float32),
                        _quats(rng, n, np.pi),
                        ta + rng.uniform(-1.4, 1.4, (n, 3)).astype(
                            np.float32),
                        np.ones(n, np.float32), ha, hb)
    cases["scaled"] = (_quats(rng, n, 0.3), ta,
                       rng.uniform(0.5, 2.0, n).astype(np.float32),
                       _quats(rng, n, 0.3),
                       ta + rng.uniform(-1.5, 1.5, (n, 3)).astype(
                           np.float32),
                       rng.uniform(0.5, 2.0, n).astype(np.float32), ha, hb)
    cases["deep"] = (_quats(rng, n, 0.2), ta, np.ones(n, np.float32),
                     _quats(rng, n, 0.2),
                     ta + rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32),
                     np.ones(n, np.float32), ha, hb)
    return cases


@pytest.fixture(scope="module")
def sat_results(z):
    """Every case through both packages as one batch (one JAX compile)."""
    cases = _cases()
    cat = [np.concatenate(cols) for cols in zip(*cases.values())]
    want = [z[f"cc.{i}"] for i in range(4)]
    t = [torch.from_numpy(x) for x in cat]
    got = [x.numpy() for x in cuboid_cuboid_manifold(
        Sim(*t[0:3]), Sim(*t[3:6]), t[6], t[7], PRED)]
    out, at = {}, 0
    for name, cols in cases.items():
        n = cols[0].shape[0]
        out[name] = ([g[at:at + n] for g in got], [w[at:at + n] for w in want])
        at += n
    return out


@pytest.mark.parametrize("case", ["stacked", "separated", "offset_overlap",
                                  "rotated_edge", "edge_edge", "aligned_ties",
                                  "general", "scaled", "deep"])
def test_cuboid_cuboid_manifold_matches_jax(sat_results, case):
    (normal, pts, dist, num), (j_normal, j_pts, j_dist, j_num) = \
        sat_results[case]
    np.testing.assert_array_equal(num, j_num)
    if case == "aligned_ties":
        for g, w in ((normal, j_normal), (pts, j_pts), (dist, j_dist)):
            np.testing.assert_array_equal(g, w)
    else:
        # the slots past the count hold 1e9 in both
        for g, w in ((normal, j_normal), (pts, j_pts), (dist, j_dist)):
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    # each case shows what it is named for
    if case == "stacked":
        assert num[0] == 4 and np.allclose(dist[0], -0.1, atol=1e-5)
        np.testing.assert_allclose(normal[0], [0, 1, 0], atol=1e-5)
    elif case == "separated":
        assert num[0] == 0
    elif case in ("offset_overlap", "rotated_edge", "edge_edge"):
        assert num[0] >= 1 and normal[0, 1] > 0.7
    elif case == "aligned_ties":
        assert (num == 4).any() and (num == 0).any()
    elif case == "deep":
        live = np.arange(4)[None, :] < num[:, None]
        assert (num > 0).all() and dist[live].min() < -0.3


def scene_arrays(translation, seed):
    """Balls and cuboids of ``boxes_and_balls(40)``'s lattice (its
    ``translation``) pulled tight over the ground and turned a little, with
    every pair whose centres lie within 1.6 m (and the ground's pairs):
    (rotations, translations, scales, (body_a, body_b, valid, count))."""
    rng = np.random.default_rng(seed)
    n = 41
    tr = np.asarray(translation).copy()
    tr[1:] *= np.float32([0.85, 0.9, 0.85])
    tr[1:, 1] -= 0.3
    q = _identity(n)
    q[1:] = _quats(rng, n - 1, 0.6)
    q[1::4] = _identity(1)  # some stay aligned: exact ties with the ground
    d = np.linalg.norm(tr[:, None] - tr[None], axis=-1)
    ia, ib = np.triu_indices(n, 1)
    keep = (d[ia, ib] < 1.6) | (ia == 0)
    cap = 512
    a = np.zeros(cap, np.int32)
    b = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    k = int(keep.sum())
    a[:k], b[:k], valid[:k] = ia[keep], ib[keep], True
    return q, tr, np.ones(n, np.float32), (a, b, valid, k)


# narrow-phase variants: (p_max, sat_capacity)
NP_VARIANTS = {"dense": (4, 0), "compacted": (4, 512), "truncated": (4, 32),
               "p_max2": (2, 512)}


@pytest.fixture(scope="module")
def narrow_results(z):
    q, tr, scale, (a, b, valid, k) = scene_arrays(z["scene.translation"], 5)
    tpose = Sim(torch.from_numpy(q), torch.from_numpy(tr),
                torch.from_numpy(scale))
    tpairs = PairList(torch.from_numpy(a).long(), torch.from_numpy(b).long(),
                      torch.from_numpy(valid), torch.tensor(k))
    tshapes = shapes_from_arrays(
        {k[len("scene.shapes."):]: v for k, v in z.items()
         if k.startswith("scene.shapes.")}, device="cpu")
    want = {name: (SimpleNamespace(**{f: z[f"narrow.{name}.{f}"]
                                      for f in NARROW_FIELDS}),
                   z[f"narrow.{name}.need"]) for name in NP_VARIANTS}
    got = {name: narrow_phase(tpose, tshapes, tpairs, PRED, p_max=p,
                              sat_capacity=cap, bc_capacity=64)
           for name, (p, cap) in NP_VARIANTS.items()}
    return got, want, tshapes, tpairs


@pytest.mark.parametrize("name", list(NP_VARIANTS))
def test_narrow_phase_cuboid_branch_matches_jax(narrow_results, name):
    got, want, tshapes, tpairs = narrow_results
    (gc, g_need), (wc, w_need) = got[name], want[name]
    np.testing.assert_array_equal(g_need.numpy(), np.asarray(w_need))
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(getattr(gc, f).numpy(),
                                      np.asarray(getattr(wc, f)), f)
    for f in ("normal_a", "points_a", "dist"):
        np.testing.assert_allclose(getattr(gc, f).numpy(),
                                   np.asarray(getattr(wc, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)
    tag = tshapes.tag
    cc = ((tag[tpairs.body_a] == 1) & (tag[tpairs.body_b] == 1)
          & tpairs.valid)
    n_cc = int(cc.sum())
    assert int(g_need[1]) == (n_cc if NP_VARIANTS[name][1] else 0)
    if name == "truncated":
        # past the capacity: the true count returned, the rows beyond the
        # capacity's first 32 cuboid pairs get no manifold
        assert n_cc > 32
        rows = torch.nonzero(cc)[:, 0]
        assert bool((gc.num_points[rows[32:]] == 0).all())
        assert bool((gc.num_points[rows[:32]] > 0).any())
    assert (gc.num_points <= NP_VARIANTS[name][0]).all()


def test_narrow_phase_keeps_the_deepest_points(narrow_results):
    """``p_max`` 2: each cuboid manifold keeps its two deepest points of
    the 4-point one, the deeper first; equal depths keep the lower slot
    first (``top_k_desc``, a stable sort, as ``lax.top_k`` does: the
    aligned pairs on the ground have four equal depths)."""
    got, _, tshapes, tpairs = narrow_results
    full, two = got["compacted"][0], got["p_max2"][0]
    d4, d2 = full.dist, two.dist
    want, idx = torch.sort(-d4, dim=-1, descending=True, stable=True)
    assert torch.equal(d2, -want[:, :2])
    assert torch.equal(two.points_a,
                       torch.gather(full.points_a, 1,
                                    idx[:, :2, None].expand(-1, -1, 3)))
    assert torch.equal(two.num_points, torch.clamp(full.num_points, max=2))
    ties = (full.num_points == 4) & (d4[:, 0] == d4[:, 3])
    assert bool(ties.any())
    assert bool((idx[ties, :2] == torch.tensor([0, 1])).all())


def auto_points_sets(shape_set, xp) -> dict:
    """The shape sets of the ``auto_manifold_points`` test, built with
    ``shape_set`` (either package's ``ShapeSet``) on arrays of ``xp``."""
    he = xp.full((3, 3), 0.5)
    r = xp.full((4,), 0.5)
    return {"cuboids": shape_set.cuboids(he),
            "balls_on_ground": shape_set.concat(shape_set.cuboids(he[:1]),
                                                shape_set.balls(r)),
            "mixed": shape_set.concat(shape_set.cuboids(he),
                                      shape_set.balls(r)),
            "one_cuboid": shape_set.cuboids(he[:1])}


def auto_points_masks(n: int) -> list:
    """No mask, the first body static, all static."""
    first_static = np.arange(n) > 0
    return [None, first_static, np.zeros(n, bool)]


def test_auto_manifold_points_matches_jax(z):
    """Cuboid stacks, balls over static cuboids, mixed scenes, each with no
    mask, its own dynamic mask (as numpy and as a tensor) and an all-static
    one."""
    sets = auto_points_sets(ShapeSet, torch)
    for name, ts in sets.items():
        shapes = shapes_from_arrays(shapes_to_arrays(ts), device="cpu")
        masks = auto_points_masks(ts.tag.shape[0])
        want = z[f"auto.{name}"]
        for mask, w in zip(masks + [torch.from_numpy(masks[1])],
                           list(want) + [want[1]]):
            assert auto_manifold_points(shapes, 3, mask) == w, name
    assert auto_manifold_points(shapes_from_arrays(shapes_to_arrays(
        sets["mixed"]), device="cpu"), 3) == 4
    with pytest.raises(NotImplementedError, match="dim 2"):
        auto_manifold_points(shapes, 2)
