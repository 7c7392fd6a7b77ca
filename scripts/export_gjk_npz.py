"""Export the JAX package's GJK, EPA and PFM-manifold results on seeded
inputs as a JAX-free ``.npz`` for the PyTorch port's CPU tests
(``tests/test_torch_gjk.py``, ``tests/test_torch_pfm_manifold.py``).

The inputs are drawn here with numpy (``default_rng``) and stored beside
the outputs, so the tests read both and run only the port; a live JAX call
of these functions costs a 15-20 s compile on the CPU. Each group's keys
start with its name:

- ``support.*``: ``support_core`` of every tag on seeded directions, the
  triangle through explicit vertex triples (``tri_verts``, ``tri_margin``)
  and through the vertex buffer, and a convex polyhedron's vertex range;
  plus ``support_face`` of each of primitives3's five tags, the triangle
  and the convex polyhedron;
- ``pairs.*``: 800 pairs of primitives3's five kinds (every ordered kind
  pair; separated, touching, core-overlapping and axis-aligned stacked
  poses), with ``gjk_distance``, ``cso_support`` along seeded directions,
  ``pfm_contact`` with ``epa_cap`` 320 (above the ~270 overlapping pairs)
  and ``pfm_contact`` with a mask and ``epa_cap`` 16, below them;
- ``epa.*``: ``epa_penetration`` on the pairs whose cores GJK found
  overlapping, with the relative poses it was given;
- ``manifold.*``: ``pfm_manifold`` on the four cases of
  ``tests/test_pfm_manifold.py`` and on the seeded pairs, each fed JAX's
  ``pfm_contact`` result, and ``feature_contacts`` on the features JAX's
  ``support_face`` gave for the seeded pairs;
- ``narrow.*``: a jittered, turned lattice of the five kinds over the
  ground with every pair of centres within 1.5 m, and the JAX narrow
  phase on it dense, compacted (``pfm_capacity`` 512), past its capacity
  (16), and at ``p_max`` 1 and 2.

Runs on the CPU in ~1 min::

    JAX_PLATFORMS=cpu python scripts/export_gjk_npz.py
"""

from __future__ import annotations

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from wgmath_tpu.broad_phase.brute_force import PairList  # noqa: E402
from wgmath_tpu.geometry import quat  # noqa: E402
from wgmath_tpu.geometry.sim import Sim  # noqa: E402
from wgmath_tpu.queries import epa, gjk, pfm_manifold  # noqa: E402
from wgmath_tpu.queries.narrow_phase import narrow_phase  # noqa: E402
from wgmath_tpu.scenes import builders  # noqa: E402
from wgmath_tpu.shapes import shape as shp  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "gjk_pfm_jax.npz")
KINDS = (shp.BALL, shp.CUBOID, shp.CAPSULE, shp.CYLINDER, shp.CONE)
BANDS = ("separated", "touching", "overlapping", "aligned")
PER_CELL = 8  # pairs per (kind A, kind B, band)
PRED = 0.002
SMALL_EPA_CAP = 16
FULL_EPA_CAP = 320  # above the overlapping pairs: every one gets EPA
NP_VARIANTS = {"dense": (4, 0), "compacted": (4, 512), "truncated": (4, 16),
               "p_max1": (1, 512), "p_max2": (2, 512)}


def _quats(rng, n, angle):
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    half = 0.5 * rng.uniform(-angle, angle, (n, 1))
    return np.concatenate([axis * np.sin(half), np.cos(half)],
                          -1).astype(np.float32)


def _params(rng, tags):
    """primitives3's sizes with jitter: radius / half height / half extents
    in [0.25, 0.5]."""
    p = np.zeros((len(tags), shp.NUM_PARAMS), np.float32)
    p[:, :3] = rng.uniform(0.25, 0.5, (len(tags), 3))
    return p


def support_group(rng, out):
    n = 64
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:8] = np.float32([[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1],
                        [0, 0, 0], [1, 1, 0], [0, 1, 1], [-1, 0, -1]])
    verts = rng.normal(size=(12, 3)).astype(np.float32)
    tri_verts = rng.normal(size=(n, 3, 3)).astype(np.float32)
    for tag in range(10):
        tags = np.full(n, tag, np.int32)
        par = rng.uniform(0.2, 0.6, (n, shp.NUM_PARAMS)).astype(np.float32)
        if tag == shp.SEGMENT:
            par[:, :6] = rng.normal(size=(n, 6))
        if tag in (shp.TRIANGLE, shp.CONVEX):
            par[:, 0] = rng.integers(0, 6, n)
            par[:, 1] = 3 if tag == shp.TRIANGLE else 6
        out[f"support.{tag}.tag"] = tags
        out[f"support.{tag}.par"] = par
    out["support.d"] = d
    out["support.vertices"] = verts
    out["support.tri_verts"] = tri_verts
    fn = jax.jit(gjk.support_core)
    for tag in range(10):
        tags, par = out[f"support.{tag}.tag"], out[f"support.{tag}.par"]
        s, r = fn(tags, par, d)
        out[f"support.{tag}.plain.sup"], out[f"support.{tag}.plain.rad"] = \
            np.asarray(s), np.asarray(r)
        s, r = jax.jit(lambda t, p, d, v: gjk.support_core(t, p, d, v))(
            tags, par, d, verts)
        out[f"support.{tag}.vertices.sup"] = np.asarray(s)
        out[f"support.{tag}.vertices.rad"] = np.asarray(r)
        s, r = jax.jit(lambda t, p, d, tv: gjk.support_core(
            t, p, d, tri_verts=tv, tri_margin=0.05))(tags, par, d, tri_verts)
        out[f"support.{tag}.tri.sup"] = np.asarray(s)
        out[f"support.{tag}.tri.rad"] = np.asarray(r)
    # support_face: the five kinds, a standalone triangle and a convex
    # polyhedron (a unit cube's 12 triangles over its 8 corners)
    cube = np.stack(np.meshgrid([-0.5, 0.5], [-0.5, 0.5], [-0.5, 0.5],
                                indexing="ij"), -1).reshape(8, 3).astype(
        np.float32)
    faces = np.int32([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]])
    out["face.vertices"], out["face.indices"] = cube, faces
    face_fn = jax.jit(pfm_manifold.support_face)
    for tag in KINDS + (shp.TRIANGLE, shp.CONVEX):
        tags = np.full(n, tag, np.int32)
        par = _params(rng, tags)
        if tag == shp.TRIANGLE:
            par[:, 0], par[:, 1] = rng.integers(0, 6, n), 3
        if tag == shp.CONVEX:
            par[:, :4] = (0, 8, 0, 12)
        dd = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-30)
        dd[4] = (0, 1, 0)
        v, nv = face_fn(tags, par, dd, cube, faces)
        out[f"face.{tag}.tag"], out[f"face.{tag}.par"] = tags, par
        out[f"face.{tag}.d"] = dd.astype(np.float32)
        out[f"face.{tag}.verts"], out[f"face.{tag}.nv"] = (
            np.asarray(v), np.asarray(nv, np.int32))


def pair_inputs(rng):
    """Every ordered kind pair of primitives3 in four bands of relative
    pose, ``PER_CELL`` pairs each."""
    rows = []
    for ka in KINDS:
        for kb in KINDS:
            for band in BANDS:
                rows += [(ka, kb, band)] * PER_CELL
    n = len(rows)
    tag_a = np.int32([r[0] for r in rows])
    tag_b = np.int32([r[1] for r in rows])
    band = np.array([r[2] for r in rows])
    par_a, par_b = _params(rng, tag_a), _params(rng, tag_b)
    qa, qb = _quats(rng, n, np.pi), _quats(rng, n, np.pi)
    ta = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    u = rng.normal(size=(n, 3))
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    dist = np.where(band == "separated", rng.uniform(1.3, 2.2, n),
                    np.where(band == "touching", rng.uniform(0.75, 1.05, n),
                             rng.uniform(0.0, 0.25, n)))
    tb = (ta + u * dist[:, None]).astype(np.float32)
    # aligned: identity rotations, B stacked straight above A with the
    # same half heights, 0.01 apart or 0.01 deep
    al = band == "aligned"
    qa[al] = qb[al] = (0.0, 0.0, 0.0, 1.0)
    h = np.float32(0.4)
    par_a[al, :3] = par_b[al, :3] = h
    ta[al] = np.round(ta[al], 1)
    gap = np.where(rng.random(n) < 0.5, 0.01, -0.01).astype(np.float32)
    tb[al] = ta[al] + np.float32([0.0, 1.0, 0.0]) * (2 * h + gap[al, None])
    scale = np.ones(n, np.float32)
    return dict(tag_a=tag_a, par_a=par_a, qa=qa, ta=ta, sa=scale,
                tag_b=tag_b, par_b=par_b, qb=qb, tb=tb, sb=scale,
                band=np.array([BANDS.index(b) for b in band], np.int32))


def pair_group(rng, out):
    x = pair_inputs(rng)
    out.update({f"pairs.{k}": v for k, v in x.items()})
    args = (x["tag_a"], x["par_a"], x["qa"], x["ta"], x["sa"],
            x["tag_b"], x["par_b"], x["qb"], x["tb"], x["sb"])

    def poses(a):
        return a[0], a[1], Sim(a[2], a[3], a[4]), a[5], a[6], Sim(a[7], a[8],
                                                                  a[9])

    @jax.jit
    def run(*a):
        ta_, pa_, sa_, tb_, pb_, sb_ = poses(a)
        g = gjk.gjk_distance(ta_, pa_, sa_, tb_, pb_, sb_)
        return (g.distance, g.point_a, g.point_b, g.normal, g.intersecting,
                *gjk.pfm_contact(ta_, pa_, sa_, tb_, pb_, sb_,
                                 epa_cap=FULL_EPA_CAP))

    res = [np.asarray(v) for v in run(*args)]
    for k, v in zip(("distance", "point_a", "point_b", "normal",
                     "intersecting", "pfm_normal", "pfm_point", "pfm_dist"),
                    res):
        out[f"pairs.gjk.{k}" if k[:3] != "pfm" else f"pairs.{k}"] = v
    inter = res[4]
    n_inter = int(inter.sum())
    print(f"pairs: {len(inter)}, cores overlapping {n_inter}", flush=True)
    assert SMALL_EPA_CAP < n_inter < FULL_EPA_CAP
    mask = rng.random(len(inter)) < 0.7
    out["pairs.mask"] = mask

    @jax.jit
    def run_masked(mask, *a):
        ta_, pa_, sa_, tb_, pb_, sb_ = poses(a)
        return gjk.pfm_contact(ta_, pa_, sa_, tb_, pb_, sb_, mask=mask,
                               epa_cap=SMALL_EPA_CAP)

    for k, v in zip(("normal", "point", "dist"), run_masked(mask, *args)):
        out[f"pairs.masked.{k}"] = np.asarray(v)

    # cso_support along seeded directions
    d = rng.normal(size=(len(inter), 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    out["pairs.cso.d"] = d

    @jax.jit
    def relative(qa, ta, sa, qb, tb):
        q_ab = quat.mul(quat.inv(qa), qb)
        t_ab = quat.inv_mul_vec(qa, tb - ta) / sa[..., None]
        return quat.to_matrix(q_ab), t_ab

    r_ab, t_ab = (np.asarray(v) for v in relative(
        x["qa"], x["ta"], x["sa"], x["qb"], x["tb"]))
    out["pairs.r_ab"], out["pairs.t_ab"] = r_ab, t_ab
    s = jax.jit(gjk.cso_support)(x["tag_a"], x["par_a"], x["tag_b"],
                                 x["par_b"], r_ab, t_ab, d)
    out["pairs.cso.w"], out["pairs.cso.p_a"], out["pairs.cso.p_b"] = (
        np.asarray(v) for v in s)

    # EPA on the overlapping pairs, with the relative poses it is given
    sel = np.nonzero(inter)[0]
    out["epa.sel"] = sel.astype(np.int32)
    e = jax.jit(epa.epa_penetration)(
        x["tag_a"][sel], x["par_a"][sel], x["tag_b"][sel], x["par_b"][sel],
        r_ab[sel], t_ab[sel])
    out["epa.normal"], out["epa.depth"], out["epa.point_a"] = (
        np.asarray(v) for v in e)

    # the manifold on JAX's contact, and feature_contacts on JAX's features
    @jax.jit
    def manifold(n_p, p_p, d_p, *a):
        ta_, pa_, sa_, tb_, pb_, sb_ = poses(a)
        return pfm_manifold.pfm_manifold(ta_, pa_, sa_, tb_, pb_, sb_, n_p,
                                         p_p, d_p, PRED)

    m = manifold(res[5], res[6], res[7], *args)
    out["manifold.pairs.points"], out["manifold.pairs.dist"] = (
        np.asarray(m[0]), np.asarray(m[1]))
    out["manifold.pairs.num"] = np.asarray(m[2], np.int32)

    @jax.jit
    def features(n_p, *a):
        ta_, pa_, sa_, tb_, pb_, sb_ = poses(a)
        f1, nv1 = pfm_manifold.support_face(ta_, pa_, n_p)
        q_ab = quat.mul(quat.inv(sa_.rotation), sb_.rotation)
        r = quat.to_matrix(q_ab)
        t = quat.inv_mul_vec(sa_.rotation, sb_.translation - sa_.translation)
        t = t / sa_.scale[..., None]
        f2l, nv2 = pfm_manifold.support_face(
            tb_, pb_, jnp.einsum("nij,ni->nj", r, -n_p))
        f2 = t[:, None, :] + jnp.einsum("nij,nkj->nki", r, f2l)
        return f1, nv1, f2, nv2

    f1, nv1, f2, nv2 = (np.asarray(v) for v in features(res[5], *args))
    pred = rng.uniform(0.0, 0.6, len(inter)).astype(np.float32)
    c = jax.jit(pfm_manifold.feature_contacts)(f1, nv1, f2, nv2, res[5],
                                               pred)
    out.update({"features.f1": f1, "features.nv1": nv1.astype(np.int32),
                "features.f2": f2, "features.nv2": nv2.astype(np.int32),
                "features.pred": pred})
    out["features.pts"], out["features.dist"], out["features.valid"] = (
        np.asarray(v) for v in c)


def _pose(t, q=None):
    q = [[0.0, 0.0, 0.0, 1.0]] if q is None else q
    return np.float32(q), np.float32(t)


def _qz(angle):
    return [0.0, 0.0, float(np.sin(angle / 2)), float(np.cos(angle / 2))]


def manifold_cases(out):
    """The four cases of ``tests/test_pfm_manifold.py``."""
    qx = [float(np.sin(np.pi / 4)), 0.0, 0.0, float(np.cos(np.pi / 4))]
    cases = {
        "capsule_on_floor": (shp.CAPSULE, [1.0, 0.25],
                             _pose([[0.0, 0.20, 0.0]], [_qz(-np.pi / 2)]),
                             shp.CUBOID, [5.0, 0.5, 5.0],
                             _pose([[0.0, -0.5, 0.0]])),
        "cylinder_cap_on_floor": (shp.CYLINDER, [0.5, 0.4],
                                  _pose([[0.0, 0.48, 0.0]]), shp.CUBOID,
                                  [5.0, 0.5, 5.0], _pose([[0.0, -0.5, 0.0]])),
        "parallel_capsules": (shp.CAPSULE, [1.0, 0.25],
                              _pose([[0.0, 0.45, 0.0]], [_qz(np.pi / 2)]),
                              shp.CAPSULE, [1.0, 0.25],
                              _pose([[0.0, 0.0, 0.0]], [_qz(np.pi / 2)])),
        "crossed_capsules": (shp.CAPSULE, [1.0, 0.25],
                             _pose([[0.0, 0.45, 0.0]], [qx]), shp.CAPSULE,
                             [1.0, 0.25], _pose([[0.0, 0.0, 0.0]],
                                                [_qz(np.pi / 2)])),
    }

    @jax.jit
    def run(ta, pa, qa, tra, tb, pb, qb, trb):
        one = jnp.ones(1, jnp.float32)
        sa, sb = Sim(qa, tra, one), Sim(qb, trb, one)
        n_p, p_p, d_p = gjk.pfm_contact(ta, pa, sa, tb, pb, sb)
        return (n_p, p_p, d_p, *pfm_manifold.pfm_manifold(
            ta, pa, sa, tb, pb, sb, n_p, p_p, d_p, 0.01))

    for name, (ta, pa, (qa, tra), tb, pb, (qb, trb)) in cases.items():
        par_a = np.zeros((1, shp.NUM_PARAMS), np.float32)
        par_a[0, :len(pa)] = pa
        par_b = np.zeros((1, shp.NUM_PARAMS), np.float32)
        par_b[0, :len(pb)] = pb
        ins = dict(tag_a=np.int32([ta]), par_a=par_a, qa=qa, ta=tra,
                   tag_b=np.int32([tb]), par_b=par_b, qb=qb, tb=trb)
        res = run(ins["tag_a"], par_a, qa, tra, ins["tag_b"], par_b, qb, trb)
        for k, v in ins.items():
            out[f"manifold.{name}.{k}"] = v
        for k, v in zip(("n", "p", "d", "points", "dist", "num"), res):
            out[f"manifold.{name}.{k}"] = np.asarray(v)


def narrow_group(rng, out):
    """A tight, turned lattice of the five kinds over the ground, every pair
    of centres within 1.5 m and the ground's pairs."""
    st = builders.primitives3(8)
    tr = np.asarray(st.bodies.poses.translation).copy()
    n = tr.shape[0]
    tr[1:] *= np.float32([0.6, 0.55, 0.6])
    tr[1:, 1] -= 0.35
    q = np.tile(np.float32([0, 0, 0, 1]), (n, 1))
    q[1:] = _quats(rng, n - 1, 1.2)
    q[1::5] = (0.0, 0.0, 0.0, 1.0)  # some stay aligned
    d = np.linalg.norm(tr[:, None] - tr[None], axis=-1)
    ia, ib = np.triu_indices(n, 1)
    keep = (d[ia, ib] < 1.5) | (ia == 0)
    cap = 1024
    a = np.zeros(cap, np.int32)
    b = np.zeros(cap, np.int32)
    valid = np.zeros(cap, bool)
    k = int(keep.sum())
    a[:k], b[:k], valid[:k] = ia[keep], ib[keep], True
    scale = np.ones(n, np.float32)
    out.update({"narrow.q": q, "narrow.tr": tr, "narrow.scale": scale,
                "narrow.a": a, "narrow.b": b, "narrow.valid": valid,
                "narrow.count": np.int32(k),
                "narrow.shapes.tag": np.asarray(st.shapes.tag),
                "narrow.shapes.params": np.asarray(st.shapes.params)})
    shapes = st.shapes

    @jax.jit
    def run(q, tr, scale, a, b, valid, count):
        pose = Sim(q, tr, scale)
        pairs = PairList(a, b, valid, count)
        return {name: narrow_phase(pose, shapes, pairs, PRED, p_max=p,
                                   sat_capacity=512, pfm_capacity=cap_,
                                   bc_capacity=64, with_overflow=True)
                for name, (p, cap_) in NP_VARIANTS.items()}

    res = run(q, tr, scale, a, b, valid, np.int32(k))
    for name, (c, need) in res.items():
        out[f"narrow.{name}.need"] = np.asarray(need, np.int32)
        for f in ("body_a", "body_b", "normal_a", "points_a", "dist",
                  "num_points", "valid"):
            out[f"narrow.{name}.{f}"] = np.asarray(getattr(c, f))
    print("narrow: pairs", k, "demands", {nm: out[f"narrow.{nm}.need"]
                                          .tolist() for nm in res},
          flush=True)


def main():
    t0 = time.time()
    rng = np.random.default_rng(13)
    out = {}
    support_group(rng, out)
    pair_group(rng, out)
    manifold_cases(out)
    narrow_group(rng, out)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
