"""The port's 2D modules against the JAX package's, on the CPU, on seeded
numpy inputs (each JAX function jitted once on them; no pipeline is compiled).

- ``cuboid_cuboid_manifold_2d``: point counts exact, normals, points and
  distances within 1e-5.
- ``epa2_penetration`` on overlapping capsules, balls and boxes embedded
  in 3D: depths and normals within 1e-4 (float32, the ring's vertices in
  another rounding where XLA contracts ``a*b+c``, ROADMAP C4).
- The 2D support-mapped branch of the narrow phase on ``capsules2``'s
  stored states against a float64 witness without GJK
  (``tests.planar_inputs.witness_2d``, itself held to the closed form on
  the capsule-ball rows): the port's rows (its kernel runs in float64)
  within 1e-6 in distance, normal and point; JAX's float32 rows leave it
  on a few rows a state (ROADMAP C14).
- ``polyline_ball_contacts`` / ``polyline_cuboid_contacts`` on
  ``polyline2``'s terrain: rows, validity and point counts exact, reals
  within 1e-5.
- The 2D grid, brute-force and LBVH broad phases: pairs exact.
- ``build_constraints`` in 2D: within 1e-5 of each field's largest value.
- The 2D joints: ``build_joint_constraints`` (with ``_orthogonalize``) and
  ``joint_gs_pass`` for fixed, revolute with limits and a motor, and
  prismatic with limits, within 5e-5 of each field's largest value (the
  3D joints' C4 tolerance, ``tests/test_torch_joint.py``); masks and
  bounds exact.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wgmath_tpu.broad_phase import brute_force as jbf
from wgmath_tpu.broad_phase import grid as jgrid
from wgmath_tpu.broad_phase import lbvh as jlbvh
from wgmath_tpu.dynamics import body as jbody
from wgmath_tpu.dynamics import constraint as jcons
from wgmath_tpu.dynamics import joint as jjoint
from wgmath_tpu.dynamics.sim_params import SimParams as JParams
from wgmath_tpu.geometry import quat as jquat
from wgmath_tpu.geometry.sim import Sim as JSim
from wgmath_tpu.queries import epa as jepa
from wgmath_tpu.queries import mesh_contact as jmc
from wgmath_tpu.queries import sat as jsat
from wgmath_tpu_torch.broad_phase import brute_force as tbf
from wgmath_tpu_torch.broad_phase import grid as tgrid
from wgmath_tpu_torch.broad_phase import lbvh as tlbvh
from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.convert import state_to_arrays
from wgmath_tpu_torch.dynamics import body as tbody
from wgmath_tpu_torch.dynamics import constraint as tcons
from wgmath_tpu_torch.dynamics import joint as tjoint
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.queries import epa as tepa
from wgmath_tpu_torch.queries import mesh_contact as tmc
from wgmath_tpu_torch.queries import sat as tsat
from wgmath_tpu_torch.scenes import builders as tbuild
from wgmath_tpu_torch.shapes import shape as shp
from tests.torch_threads import one_torch_thread  # noqa: F401

# the module: the package exports the function of the same name, as JAX's
tnp = importlib.import_module("wgmath_tpu_torch.queries.narrow_phase")
TOL = 1e-5
EPA_TOL = 1e-4
JOINT_TOL = 5e-5
PRED = 0.002


def _t(x, dtype=None):
    a = np.asarray(x)
    if dtype is not None:
        a = a.astype(dtype)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)


def _jsim(s: Sim) -> JSim:
    return JSim(_j(s.rotation), _j(s.translation), _j(s.scale))


def _close(got, want, tol=TOL, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = max(float(np.abs(want).max()), 1.0) if want.size else 1.0
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                                   err_msg=what)


def _rot2(theta):
    return np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)


def _poses2(rng, n, spread):
    return Sim(_t(_rot2(rng.uniform(-np.pi, np.pi, n))),
               _t(rng.uniform(-spread, spread, (n, 2)).astype(np.float32)),
               torch.ones(n))


def test_sat_2d_against_jax():
    rng = np.random.default_rng(21)
    n = 256
    pa, pb = _poses2(rng, n, 0.2), _poses2(rng, n, 0.9)
    he_a = _t(rng.uniform(0.2, 0.6, (n, 2)).astype(np.float32))
    he_b = _t(rng.uniform(0.2, 0.6, (n, 2)).astype(np.float32))
    # a quarter of the pairs axis-aligned and stacked, as a pile's are
    k = n // 4
    pa.rotation[:k] = torch.tensor([1.0, 0.0])
    pb.rotation[:k] = torch.tensor([1.0, 0.0])
    pb.translation[:k, 0] = pa.translation[:k, 0] + 0.1
    pb.translation[:k, 1] = (pa.translation[:k, 1] + he_a[:k, 1]
                             + he_b[:k, 1] - 0.01)
    got = tsat.cuboid_cuboid_manifold_2d(pa, pb, he_a, he_b, PRED)
    want = jax.jit(jsat.cuboid_cuboid_manifold_2d, static_argnums=4)(
        _jsim(pa), _jsim(pb), _j(he_a), _j(he_b), PRED)
    num = np.asarray(want[3])
    _close(got[3], num, what="num_points")
    assert (num > 0).sum() > n // 4
    live = np.arange(2)[None, :] < num[:, None]
    _close(got[0][num > 0], np.asarray(want[0])[num > 0], what="normal")
    _close(got[1].numpy()[live], np.asarray(want[1])[live], what="points")
    _close(got[2].numpy()[live], np.asarray(want[2])[live], what="dists")


def _embedded_pairs(rng, m):
    """Overlapping 2D pairs (capsule-capsule, capsule-ball, capsule-box)
    embedded in 3D as the narrow phase embeds them."""
    tag_a = np.full(m, shp.CAPSULE)
    tag_b = rng.choice([shp.CAPSULE, shp.BALL, shp.CUBOID], m)
    par_a = np.zeros((m, shp.NUM_PARAMS), np.float32)
    par_b = np.zeros((m, shp.NUM_PARAMS), np.float32)
    par_a[:, 0], par_a[:, 1] = 0.3, 0.2
    par_b[:, 0] = np.where(tag_b == shp.CUBOID, 0.4, 0.3)
    par_b[:, 1] = np.where(tag_b == shp.BALL, 0.0, 0.2)
    par_b[:, 0] = np.where(tag_b == shp.BALL, 0.3, par_b[:, 0])
    pa, pb = _poses2(rng, m, 0.05), _poses2(rng, m, 0.2)
    ta, tb = _t(tag_a), _t(tag_b)
    a3, pa3 = tnp._embed(pa, ta, _t(par_a))
    b3, pb3 = tnp._embed(pb, tb, _t(par_b))
    return ta, pa3, a3, tb, pb3, b3


def test_epa2_against_jax():
    rng = np.random.default_rng(22)
    ta, par_a, a3, tb, par_b, b3 = _embedded_pairs(rng, 128)
    from wgmath_tpu_torch.queries.gjk import relative_pose

    r_ab, t_ab = relative_pose(a3, b3)
    got = tepa.epa2_penetration(ta, par_a, tb, par_b, r_ab, t_ab)
    q_ab = jquat.mul(jquat.inv(_j(a3.rotation)), _j(b3.rotation))
    jt = jquat.inv_mul_vec(_j(a3.rotation),
                           _j(b3.translation) - _j(a3.translation))
    want = jax.jit(jepa.epa2_penetration)(_j(ta), _j(par_a), _j(tb),
                                         _j(par_b), jquat.to_matrix(q_ab),
                                         jt)
    depth = np.asarray(want[1])
    assert (depth > 1e-3).sum() > 64
    _close(got[1], depth, EPA_TOL, "depth")
    _close(got[0], want[0], EPA_TOL, "normal")
    _close(got[2], want[2], EPA_TOL, "point")


@pytest.mark.parametrize("i", [0, 1, 2])
def test_pfm_2d_branch_against_a_witness(i):
    """``capsules2``'s support-mapped rows in JAX's stored states: the
    pairs JAX's; the port's distance, normal and point (where it is the
    only one) within 1e-6 of the witness on every row (8.1e-8, 2.3e-7
    and 2.2e-7 measured); JAX's float32 rows off the witness by more
    than 1e-5 on 5-7 rows of 95-111 (ROADMAP C14), bounded here at 8."""
    from tests.planar_inputs import (
        config_of,
        planar_arrays,
        planar_state,
        support_rows,
    )

    z = planar_arrays()
    st = planar_state("capsules2", i)
    cfg = config_of("capsules2.config_json" if i == 0
                    else f"capsules2.ref.{i - 1}.config_json")
    b, sh = st.bodies, st.shapes
    mins, maxs = shp.world_aabbs(sh, b.poses, margin=PRED)
    p = tbf.find_pairs(mins, maxs, capacity=cfg.pair_capacity,
                       block=cfg.broad_phase_block,
                       max_per_row=cfg.broad_phase_max_per_row,
                       ball_radius=shp.ball_radii_or_nan(sh, b.poses),
                       margin=PRED, dynamic=b.is_dynamic())
    got, _ = tnp.narrow_phase(b.poses, sh, p, PRED, p_max=2,
                              with_overflow=True)
    k = z[f"capsules2.np{i}.dist"].shape[0]
    assert int(p.count) < k
    _close(p.body_a[:k], z[f"capsules2.np{i}.body_a"].astype(np.int64))
    _close(p.body_b[:k], z[f"capsules2.np{i}.body_b"].astype(np.int64))
    sr = support_rows("capsules2", i, st)
    rows = torch.from_numpy(sr["rows"])
    assert rows.numel() > 90
    np.testing.assert_allclose(got.dist[rows, 0].numpy(), sr["dist"],
                               atol=1e-6)
    np.testing.assert_allclose(got.normal_a[rows].numpy(), sr["normal"],
                               atol=1e-6)
    only = sr["only"]
    np.testing.assert_allclose(got.points_a[rows, 0].numpy()[only],
                               sr["point"][only], atol=1e-6)
    assert sr["c14"].sum() <= 8, sr["rows"][sr["c14"]]
    # the witness against the closed form on the capsule-ball rows: the
    # ball's centre to the capsule's segment, less both radii
    a = p.body_a[rows].numpy()
    bb = p.body_b[rows].numpy()
    tag = sh.tag.numpy()
    cap = np.where(tag[a] == shp.CAPSULE, a, bb)
    ball = np.where(tag[a] == shp.CAPSULE, bb, a)
    sel = (tag[cap] == shp.CAPSULE) & (tag[ball] == shp.BALL)
    assert sel.sum() > 10
    cap, ball = cap[sel], ball[sel]
    par = sh.params.numpy().astype(np.float64)
    rot = b.poses.rotation.numpy().astype(np.float64)
    tr = b.poses.translation.numpy().astype(np.float64)
    axis = np.stack([-rot[cap, 1], rot[cap, 0]], -1) * par[cap, :1]
    d = tr[ball] - tr[cap]
    s = np.clip((d * axis).sum(1) / (axis * axis).sum(1), -1.0, 1.0)
    exact = (np.linalg.norm(d - s[:, None] * axis, axis=1) - par[cap, 1]
             - par[ball, 0])
    np.testing.assert_allclose(sr["dist"][sel], exact, atol=1e-9)


def _polyline_world(rng, n, kind, lift):
    """polyline2's terrain and ``n`` balls or boxes of 0.3 around it,
    their centres ``lift`` m over the terrain's height there."""
    st = tbuild.polyline2(4, device="cpu")
    terrain = st.shapes
    x = rng.uniform(-18, 18, n).astype(np.float32)
    y = (np.sin(x * 0.6) * 1.5 + lift + rng.uniform(-0.1, 0.1, n)).astype(
        np.float32)
    if kind == "ball":
        objs = shp.ShapeSet.balls(torch.full((n,), 0.3), dim=2)
    else:
        objs = shp.ShapeSet.cuboids(torch.full((n, 2), 0.3))
    shapes = shp.ShapeSet.concat(
        shp.ShapeSet(terrain.tag[:1], terrain.params[:1], terrain.vertices,
                     terrain.indices, terrain.cluster_min,
                     terrain.cluster_max, kinds=frozenset({shp.POLYLINE})),
        objs)
    rot = _rot2(np.concatenate([[0.0], rng.uniform(-0.5, 0.5, n)]))
    poses = Sim(_t(rot), _t(np.concatenate([[[0.0, 0.0]],
                                            np.stack([x, y], -1)])),
                torch.ones(n + 1))
    pairs = PairList(torch.zeros(n, dtype=torch.int64),
                     torch.arange(1, n + 1), torch.ones(n, dtype=torch.bool),
                     torch.tensor(n))
    return shapes, poses, pairs


def _jax_shapes(shapes):
    from wgmath_tpu.shapes.shape import ShapeSet as JShapes

    return JShapes(_j(shapes.tag), _j(shapes.params), _j(shapes.vertices),
                   _j(shapes.indices), _j(shapes.cluster_min),
                   _j(shapes.cluster_max), kinds=shapes.kinds)


def _jpairs(p):
    return jbf.PairList(_j(p.body_a), _j(p.body_b), _j(p.valid),
                        _j(p.count))


def _contacts_close(got, want):
    _close(got.body_a, np.asarray(want.body_a).astype(np.int64), what="a")
    _close(got.body_b, np.asarray(want.body_b).astype(np.int64), what="b")
    valid = np.asarray(want.valid)
    _close(got.valid, valid, what="valid")
    _close(got.num_points, np.asarray(want.num_points).astype(np.int64),
           what="num_points")
    assert valid.sum() > 10
    nump = np.asarray(want.num_points)
    live = np.arange(got.dist.shape[1])[None, :] < nump[:, None]
    _close(got.normal_a.numpy()[valid], np.asarray(want.normal_a)[valid],
           what="normal")
    _close(got.points_a.numpy()[live], np.asarray(want.points_a)[live],
           what="points")
    _close(got.dist.numpy()[live], np.asarray(want.dist)[live], what="dist")


@pytest.mark.parametrize("kind", ["ball", "cuboid"])
def test_polyline_contacts_against_jax(kind):
    rng = np.random.default_rng(23 if kind == "ball" else 24)
    shapes, poses, pairs = _polyline_world(rng, 96, kind, 0.25)
    fn = (("polyline_ball_contacts", dict(k_best=2, p_max=2))
          if kind == "ball" else ("polyline_cuboid_contacts",
                                  dict(k_best=2)))
    got = getattr(tmc, fn[0])(poses, shapes, pairs, 0.05, pair_cap=128,
                              **fn[1])
    jshapes = _jax_shapes(shapes)
    want = jax.jit(lambda po, pa: getattr(jmc, fn[0])(
        po, jshapes, pa, 0.05, pair_cap=128, **fn[1]))(
            _jsim(poses), _jpairs(pairs))
    _contacts_close(got, want)


def _boxes_2d(rng, n):
    c = rng.uniform(0, 12, (n, 2)).astype(np.float32)
    he = rng.uniform(0.2, 0.5, (n, 2)).astype(np.float32)
    he[: n // 10] *= 6.0  # some outliers for the grid's global list
    return _t(c - he), _t(c + he)


@pytest.mark.parametrize("algo", ["grid", "brute", "lbvh"])
def test_broad_phase_2d_against_jax(algo):
    rng = np.random.default_rng(25)
    mins, maxs = _boxes_2d(rng, 300)
    dyn = _t(rng.random(300) < 0.8)
    if algo == "grid":
        got = tgrid.find_pairs_grid(mins, maxs, capacity=4096,
                                    max_per_body=64, dynamic=dyn)
        want = jgrid.find_pairs_grid(_j(mins), _j(maxs), capacity=4096,
                                     max_per_body=64, dynamic=_j(dyn))
    elif algo == "brute":
        got = tbf.find_pairs(mins, maxs, capacity=4096, dynamic=dyn)
        want = jbf.find_pairs(_j(mins), _j(maxs), capacity=4096,
                              dynamic=_j(dyn))
    else:
        got = tlbvh.find_pairs_lbvh(mins, maxs, capacity=4096)
        want = jlbvh.find_pairs_lbvh(_j(mins), _j(maxs), capacity=4096)
    assert int(got.count) == int(want.count) > 100
    for f in ("body_a", "body_b", "valid"):
        _close(getattr(got, f), np.asarray(getattr(want, f)).astype(
            np.int64 if f != "valid" else bool), what=f)


def _bodies_2d(rng, n):
    st = tbuild.boxes_and_balls(n, dim=2, device="cpu")
    b = st.bodies
    poses = Sim(_t(_rot2(rng.uniform(-0.3, 0.3, n + 1))),
                b.poses.translation, b.poses.scale)
    vels = tbody.Velocity(_t(rng.normal(size=(n + 1, 2)).astype(
        np.float32)), _t(rng.normal(size=n + 1).astype(np.float32)))
    return tbody.Bodies(poses, vels, b.local_mprops), st


def test_constraint_build_2d_against_jax():
    rng = np.random.default_rng(26)
    bodies, _ = _bodies_2d(rng, 64)
    c, p = 200, 2
    ba = _t(rng.integers(0, 65, c))
    bb = _t(rng.integers(0, 65, c))
    nrm = rng.normal(size=(c, 2)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    contacts = tcons.Contacts(
        ba, bb, _t(nrm), _t(rng.uniform(-0.5, 0.5, (c, p, 2)).astype(
            np.float32)), _t(rng.uniform(-0.05, 0.01, (c, p)).astype(
                np.float32)), _t(rng.integers(1, 3, c)),
        _t(rng.random(c) < 0.9))
    params = SimParams().substep()
    mp = tbody.update_mprops(bodies.poses, bodies.local_mprops)
    got = tcons.build_constraints(bodies.poses, bodies.vels, mp, contacts,
                                  params)
    jb = jbody.Bodies(_jsim(bodies.poses),
                      jbody.Velocity(_j(bodies.vels.linear),
                                     _j(bodies.vels.angular)),
                      jbody.LocalMassProperties(
                          _j(bodies.local_mprops.inv_mass),
                          _j(bodies.local_mprops.com), None,
                          _j(bodies.local_mprops.inv_principal_inertia)))
    jmp = jbody.update_mprops(jb.poses, jb.local_mprops)
    jc = jcons.Contacts(*(_j(getattr(contacts, f)) for f in (
        "body_a", "body_b", "normal_a", "points_a", "dist", "num_points",
        "valid")))
    want = jax.jit(jcons.build_constraints, static_argnums=4)(
        jb.poses, jb.vels, jmp, jc, JParams().substep())
    for f in dataclasses.fields(tcons.ContactConstraints):
        w = np.asarray(getattr(want, f.name))
        if w.dtype == np.int32:
            w = w.astype(np.int64)
        _close(getattr(got, f.name), w, what=f.name)


JOINT_CASES = {
    "fixed": dict(fn="fixed_joints", kw={}),
    "revolute": dict(fn="revolute_joints",
                     kw=dict(limits=(-0.4, 0.3), motor_vel=0.5)),
    "prismatic": dict(fn="prismatic_joints", kw=dict(limits=(-0.2, 0.1))),
}


@pytest.mark.parametrize("case", sorted(JOINT_CASES))
def test_joint_build_and_pass_2d_against_jax(case):
    rng = np.random.default_rng(27)
    bodies, _ = _bodies_2d(rng, 40)
    bodies.local_mprops.inv_mass[:3] = 0.0
    bodies.local_mprops.inv_principal_inertia[:3] = 0.0
    j = 60
    ba = rng.integers(0, 41, j)
    bb = (ba + rng.integers(1, 40, j)) % 41
    anch_a = rng.uniform(-0.5, 0.5, (j, 2)).astype(np.float32)
    anch_b = rng.uniform(-0.5, 0.5, (j, 2)).astype(np.float32)
    dyn = bodies.is_dynamic().numpy()
    spec = JOINT_CASES[case]
    args = [ba.tolist(), bb.tolist(), anch_a.tolist(), anch_b.tolist()]
    if case == "prismatic":
        ax = rng.normal(size=(j, 2)).astype(np.float32)
        args.append((ax / np.linalg.norm(ax, axis=-1,
                                         keepdims=True)).tolist())
    tset = getattr(tjoint, spec["fn"])(*args, dim=2, dynamic_mask=dyn,
                                       device="cpu", **spec["kw"])
    jset = getattr(jjoint, spec["fn"])(*args, dim=2, dynamic_mask=dyn,
                                       **spec["kw"])
    sub = SimParams().substep().with_dim(2)
    mp = tbody.update_mprops(bodies.poses, bodies.local_mprops)
    got = tjoint.build_joint_constraints(tset, bodies.poses, mp, sub)
    jmp = jbody.WorldMassProperties(_j(mp.inv_mass), _j(mp.com),
                                    _j(mp.inv_inertia))
    want = jax.jit(jjoint.build_joint_constraints, static_argnums=3)(
        jset, _jsim(bodies.poses), jmp, JParams().substep().with_dim(2))
    for f in dataclasses.fields(jjoint.JointConstraints):
        w = np.asarray(getattr(want, f.name))
        g = getattr(got, f.name)
        if f.name.startswith("bounds") or w.dtype == np.bool_:
            _close(g, w, what=f.name)
        else:
            _close(g, w.astype(np.int64) if w.dtype == np.int32 else w,
                   JOINT_TOL, f.name)
    vels = bodies.vels
    got_v, got_c = tjoint.joint_gs_pass(got, vels, tset.colors)
    want_v, want_c = jax.jit(jjoint.joint_gs_pass)(
        want, jbody.Velocity(_j(vels.linear), _j(vels.angular)),
        jset.colors)
    _close(got_v.linear, want_v.linear, JOINT_TOL, "linear")
    _close(got_v.angular, want_v.angular, JOINT_TOL, "angular")
    _close(got_c.impulse, want_c.impulse, JOINT_TOL, "impulse")
    # JAX's own constraints through the port's pass: the same arithmetic
    own = dataclasses.replace(
        got, **{f.name: _t(np.asarray(getattr(want, f.name))).to(
            getattr(got, f.name).dtype)
            for f in dataclasses.fields(jjoint.JointConstraints)})
    own_v, _ = tjoint.joint_gs_pass(own, vels, tset.colors)
    _close(own_v.linear, want_v.linear, 2e-6, "linear, JAX's constraints")


def test_state_arrays_2d_carry_no_inertia_frame():
    st = tbuild.SCENES["joint_prismatic2"](device="cpu")
    arrays = state_to_arrays(st)
    assert "bodies.local_mprops.inertia_ref_frame" not in arrays
    assert arrays["bodies.vels.angular"].shape == (st.bodies.num_bodies,)
    # locked: linear y and the angle; limited: linear x
    assert st.joints.slots == (3, 5, 7)
