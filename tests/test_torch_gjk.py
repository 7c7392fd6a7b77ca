"""The port's GJK, EPA and one-point support-mapped contact
(``queries/gjk.py``, ``queries/epa.py``) against the JAX package's results
on seeded inputs, stored with those inputs by ``scripts/export_gjk_npz.py``
in ``artifacts/gjk_pfm_jax.npz`` (a live JAX call of these functions is a
15-20 s compile on the CPU).

Tolerances, and why:

- ``support_core``: the selections (ball, cuboid, capsule, segment,
  triangle, convex range) bit for bit; the cylinder's and cone's rim within
  2.4e-7 (XLA divides by the rim's length through a reciprocal, an ulp
  off a division).
- GJK and EPA iterate in f32: an ulp of difference (XLA contracts ``a*b+c``
  into one rounding where PyTorch rounds the product, ROADMAP C4) can send
  a near-degenerate pair into another simplex. So each pair is also run
  through the port in f64, the referee. A pair is *settled* where both
  packages' f32 results lie within ``SETTLED`` of the referee; on settled
  pairs the port holds JAX's result within the tolerances below. Where a
  pair is not settled, the two f32 results may differ by any amount (a
  touching pair reported overlapping gets a deep EPA contact); such pairs
  stay in the sets, their number is bounded, and the port may miss the
  referee on at most 2 more pairs than JAX misses it.
"""

import os

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries import epa, gjk
from wgmath_tpu_torch.shapes import shape as shp
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "gjk_pfm_jax.npz")
BANDS = ("separated", "touching", "overlapping", "aligned")
RIM_ATOL = 2.4e-7
SETTLED = 1e-3  # an f32 result within this of the f64 referee
# on settled pairs: GJK distances (m; measured 5.0e-5), EPA depths and the
# contact's signed distances (EPA stops at a 1e-4 gap, in f32 on ~1 m
# supports; measured 6.4e-4 and 7.0e-4), unit normals, settled where
# within NORMAL_SETTLED of the referee's (measured 1.7e-3)
GJK_ATOL, EPA_ATOL, NORMAL_ATOL = 1e-4, 1e-3, 2e-3
NORMAL_SETTLED = 2e-3
# pairs not settled: at most this share of a set (measured: 3 of 200 in a
# GJK band, 18 of 266 EPA depths, 25 of 800 contacts, 13 of 775 contact
# normals); the port misses the referee on at most as many pairs as JAX
# does, plus 2 (measured: 13 against 18 contacts, 11 against 9 EPA normals)
UNSETTLED_SHARE = {"gjk": 0.03, "epa": 0.1}


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


def _pair_args(z, dtype=torch.float32, rows=slice(None)):
    g = lambda k: _t(z[f"pairs.{k}"][rows], dtype)  # noqa: E731
    return (g("tag_a"), g("par_a"), Sim(g("qa"), g("ta"), g("sa")),
            g("tag_b"), g("par_b"), Sim(g("qb"), g("tb"), g("sb")))


def _rows(x):
    x = np.asarray(x, np.float64)
    return np.abs(x).reshape(len(x), -1).max(-1)


def _settled_rule(got, want, ref, atol, what, share, settled_at=SETTLED):
    """Per pair: on settled pairs |got - want| <= atol; the others are
    counted. Returns the settled mask."""
    off_port = _rows(got - ref) > settled_at
    off_jax = _rows(want - ref) > settled_at
    settled = ~off_port & ~off_jax
    d = _rows(got - want)
    worst = float(d[settled].max(initial=0.0))
    assert worst <= atol, (what, worst, np.nonzero(settled & (d > atol)))
    assert (~settled).sum() <= share * len(d), (what, (~settled).sum())
    assert off_port.sum() <= off_jax.sum() + 2, (what, off_port.sum(),
                                                 off_jax.sum())
    return settled


@pytest.mark.parametrize("tag", range(10))
def test_support_core_matches_jax(z, tag):
    """Every tag's core support and radius: plain, with the vertex buffer
    (CONVEX ranges, standalone TRIANGLE), and with explicit triangle
    triples (``tri_verts``, ``tri_margin``)."""
    tags, par = _t(z[f"support.{tag}.tag"]), _t(z[f"support.{tag}.par"])
    d = _t(z["support.d"])
    runs = {"plain": gjk.support_core(tags, par, d),
            "vertices": gjk.support_core(tags, par, d,
                                         _t(z["support.vertices"])),
            "tri": gjk.support_core(tags, par, d,
                                    tri_verts=_t(z["support.tri_verts"]),
                                    tri_margin=0.05)}
    for route, (sup, rad) in runs.items():
        want = z[f"support.{tag}.{route}.sup"]
        np.testing.assert_array_equal(rad.numpy(),
                                      z[f"support.{tag}.{route}.rad"])
        if tag in (3, 4):  # cone, cylinder: the rim
            np.testing.assert_allclose(sup.numpy(), want, rtol=0,
                                       atol=RIM_ATOL, err_msg=route)
        else:
            np.testing.assert_array_equal(sup.numpy(), want, err_msg=route)
    if tag == 9:  # a CONVEX row reaches into the vertex range
        assert not np.array_equal(z["support.9.vertices.sup"],
                                  z["support.9.plain.sup"])


def test_cso_support_matches_jax(z):
    """w = p_a − p_b along seeded directions, B's pose given in A's frame:
    within 1e-6 (the rim's ulp, turned by B's rotation)."""
    s = gjk.cso_support(_t(z["pairs.tag_a"]), _t(z["pairs.par_a"]),
                        _t(z["pairs.tag_b"]), _t(z["pairs.par_b"]),
                        _t(z["pairs.r_ab"]), _t(z["pairs.t_ab"]),
                        _t(z["pairs.cso.d"]))
    for got, key in zip(s, ("w", "p_a", "p_b")):
        np.testing.assert_allclose(got.numpy(), z[f"pairs.cso.{key}"],
                                   rtol=0, atol=1e-6, err_msg=key)


@pytest.fixture(scope="module")
def gjk_runs(z):
    """The port's GJK on every pair in f32 and in f64 (the referee)."""
    return (gjk.gjk_distance(*_pair_args(z)),
            gjk.gjk_distance(*_pair_args(z, torch.float64)))


@pytest.mark.parametrize("band", BANDS)
def test_gjk_distance_matches_jax(z, gjk_runs, band):
    """Core distance (0 where the cores overlap), the overlap flag, and on
    separated settled pairs the unit normal, per band of relative pose
    over all 25 ordered kind pairs of primitives3."""
    rows = z["pairs.band"] == BANDS.index(band)
    got, ref = (r for r in gjk_runs)
    g = {k: getattr(got, k).numpy()[rows] for k in vars(got)}
    r = {k: getattr(ref, k).numpy()[rows] for k in vars(ref)}
    w = {k: z[f"pairs.gjk.{k}"][rows] for k in vars(got)}
    settled = _settled_rule(g["distance"], w["distance"], r["distance"],
                            GJK_ATOL, f"{band} distance",
                            UNSETTLED_SHARE["gjk"])
    np.testing.assert_array_equal(g["intersecting"][settled],
                                  w["intersecting"][settled])
    apart = settled & (w["distance"] > 1e-2)
    _settled_rule(g["normal"][apart], w["normal"][apart], r["normal"][apart],
                  NORMAL_ATOL, f"{band} normal", UNSETTLED_SHARE["gjk"],
                  NORMAL_SETTLED)
    if band == "overlapping":
        assert g["intersecting"].mean() > 0.5
    if band == "separated":
        assert (g["distance"] > 0).mean() > 0.9


@pytest.fixture(scope="module")
def epa_runs(z):
    sel = z["epa.sel"]
    args = [_t(z[f"pairs.{k}"][sel]) for k in ("tag_a", "par_a", "tag_b",
                                                "par_b", "r_ab", "t_ab")]
    f64 = [a.double() if a.is_floating_point() else a for a in args]
    return epa.epa_penetration(*args), epa.epa_penetration(*f64)


def test_epa_penetration_matches_jax(z, epa_runs):
    """Depth, normal and deepest point of every core-overlapping pair, from
    the same relative poses as JAX's: settled pairs within the tolerances
    (the deepest point of a flat contact is not unique: held only where
    the normal is)."""
    (n, depth, pt), (n64, d64, _) = epa_runs
    settled = _settled_rule(depth.numpy(), z["epa.depth"], d64.numpy(),
                            EPA_ATOL, "epa depth", UNSETTLED_SHARE["epa"])
    _settled_rule(n.numpy()[settled], z["epa.normal"][settled],
                  n64.numpy()[settled], NORMAL_ATOL, "epa normal",
                  UNSETTLED_SHARE["epa"], NORMAL_SETTLED)
    assert (depth.numpy() >= 0).all() and (depth.numpy() > 0.05).any()
    assert np.isfinite(pt.numpy()).all()


@pytest.fixture(scope="module")
def pfm_runs(z):
    args, args64 = _pair_args(z), _pair_args(z, torch.float64)
    cap = 320  # the export's FULL_EPA_CAP: every overlapping pair gets EPA
    return (gjk.pfm_contact(*args, epa_cap=cap)[:3],
            gjk.pfm_contact(*args64, epa_cap=cap)[:3])


def test_pfm_contact_matches_jax(z, pfm_runs):
    """GJK minus both radii, EPA on the core-overlapping pairs: the signed
    distance on settled pairs within ``EPA_ATOL``, their normals within
    ``NORMAL_ATOL``."""
    (n, _, d), (n64, _, d64) = pfm_runs
    settled = _settled_rule(d.numpy(), z["pairs.pfm_dist"], d64.numpy(),
                            EPA_ATOL, "pfm dist", UNSETTLED_SHARE["epa"])
    _settled_rule(n.numpy()[settled], z["pairs.pfm_normal"][settled],
                  n64.numpy()[settled], NORMAL_ATOL, "pfm normal",
                  UNSETTLED_SHARE["epa"], NORMAL_SETTLED)
    assert (d.numpy() < -0.05).sum() > 100  # deep pairs, EPA's depths


def test_pfm_contact_masked_past_its_epa_cap(z, pfm_runs):
    """``mask`` and ``epa_cap`` 16 below the overlapping pairs: the first 16
    masked overlapping pairs get EPA's answer, every other pair keeps
    GJK's, as in the JAX package; the demand is the unclamped count."""
    args = _pair_args(z)
    mask = _t(z["pairs.mask"])
    n, p, d, demand = gjk.pfm_contact(*args, mask=mask, epa_cap=16)
    res = gjk.gjk_distance(*args)
    inter = res.intersecting & mask
    assert int(demand) == int(inter.sum()) > 16
    past = inter.clone()
    past[torch.nonzero(inter)[:16, 0]] = False
    keep = ~inter | past  # GJK's answer
    n0, _, d0, _ = gjk.pfm_contact(*args, mask=torch.zeros_like(mask))
    assert torch.equal(n[keep], n0[keep]) and torch.equal(d[keep], d0[keep])
    first = torch.nonzero(inter)[:16, 0]
    full_n, _, full_d = pfm_runs[0]
    assert torch.equal(d[first], full_d[first])
    assert torch.equal(n[first], full_n[first])
    # JAX's masked run: the same rule as the full run
    ref = torch.where(keep, d0.double(), pfm_runs[1][2])
    _settled_rule(d.numpy(), z["pairs.masked.dist"], ref.numpy(), EPA_ATOL,
                  "masked pfm dist", UNSETTLED_SHARE["epa"])


def test_fixed_loop_equals_an_early_exit(z):
    """The card's sync-free form (``sync_free=True``: a fixed loop of
    ``max_iters``, no host read) gives the bits of the JAX package's
    ``while any(active)`` exit, which the port takes on the CPU: a retired
    pair is frozen. The separated band's pairs all retire within 32
    iterations; the fixed loops of 32 and 64 iterations and the early exit
    give the same bits."""
    args = _pair_args(z, rows=z["pairs.band"] == 0)
    a = gjk.gjk_distance(*args, max_iters=32, sync_free=True)
    b = gjk.gjk_distance(*args, max_iters=64, sync_free=True)
    c = gjk.gjk_distance(*args)
    for k in vars(a):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
        assert torch.equal(getattr(a, k), getattr(c, k)), k


def test_sync_free_form_gives_the_cpu_bits(z, gjk_runs, pfm_runs):
    """Every pair of every band through the card's sync-free form on the
    CPU: GJK's fixed loop, and EPA's full batch of ``epa_cap`` slots (the
    CPU cuts it to the demand), give the bits of the CPU's form, which the
    tests above hold against the JAX package; so do the masked run past
    its cap and the no-EPA push."""
    args = _pair_args(z)
    res = gjk.gjk_distance(*args, sync_free=True)
    for k in vars(res):
        assert torch.equal(getattr(res, k), getattr(gjk_runs[0], k)), k
    full = gjk.pfm_contact(*args, epa_cap=320, sync_free=True)
    for a, b in zip(full, pfm_runs[0]):
        assert torch.equal(a, b)
    mask = _t(z["pairs.mask"])
    for kw in ({"mask": mask, "epa_cap": 16}, {"use_epa": False}):
        cpu = gjk.pfm_contact(*args, **kw)
        card = gjk.pfm_contact(*args, sync_free=True, **kw)
        for a, b in zip(cpu, card):
            assert torch.equal(a, b), kw


def test_mesh_and_2d_options_raise():
    """An unknown EPA option raises (the 2D EPA, once refused, runs:
    ``tests/test_torch_planar.py`` holds it against the JAX package's);
    the mesh narrow phase's options, once refused, run
    (``tests/test_torch_mesh.py`` holds them against the JAX package): a
    ball over a triangle dilated by its margin."""
    one = torch.zeros(1, dtype=torch.int64)
    par = torch.zeros((1, 8))
    pose = Sim(torch.tensor([[0.0, 0, 0, 1]]), torch.zeros((1, 3)),
               torch.ones(1))
    args = (one, par, pose, one, par, pose)
    with pytest.raises(ValueError, match="use_epa"):
        gjk.pfm_contact(*args, use_epa="3d")
    tri = torch.tensor([[[-1.0, 0, -1], [1.0, 0, -1], [0.0, 0, 1]]])
    up = Sim(pose.rotation, torch.tensor([[0.0, 0.5, 0.0]]), torch.ones(1))
    ball = par.clone()
    ball[0, 0] = 0.25
    res = gjk.gjk_distance(one + shp.TRIANGLE, par, pose, one, ball, up,
                           tri_verts_a=tri)
    assert abs(float(res.distance[0]) - 0.5) < 1e-5
    n, _, d, pushes = gjk.pfm_contact(one + shp.TRIANGLE, par, pose, one,
                                      ball, up, tri_verts_a=tri,
                                      tri_margin=0.02, use_epa=False)
    assert abs(float(d[0]) - 0.23) < 1e-5 and int(pushes) == 0
    assert torch.allclose(n, torch.tensor([[0.0, 1.0, 0.0]]), atol=1e-6)
