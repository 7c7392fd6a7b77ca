"""The port's solver pieces against the JAX package on the same seeded
inputs: colouring (exact), colour carry-over and greedy assignment
(exact), warmstart sides and the last-writer chain (exact), the constraint
build and packed field layout, and one chained rhs-in-rung sweep pair
(biased, then unbiased) through the impulse math."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wgmath_tpu.dynamics import SimParams as JaxSimParams
from wgmath_tpu.dynamics import body as jbody
from wgmath_tpu.dynamics import constraint as jcons
from wgmath_tpu.dynamics import solver as jsolver
from wgmath_tpu.geometry import sim as jsim
from wgmath_tpu_torch.dynamics import body as tbody
from wgmath_tpu_torch.dynamics import constraint as tcons
from wgmath_tpu_torch.dynamics import solver as tsolver
from wgmath_tpu_torch.dynamics.gs_math import pack_meta
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import sim as tsim
from tests.torch_threads import one_torch_thread  # noqa: F401

# the GS impulse math's tolerance (the JAX package's, for the same math)
RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    a = np.array(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int64))
    return torch.from_numpy(a.astype(np.float32))


def _graph(seed, n, c, n_static=3, p_valid=0.9):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, c)
    b = rng.integers(0, n, c)
    b = np.where(a == b, (b + 1) % n, b)
    ba, bb = np.minimum(a, b).astype(np.int32), np.maximum(a, b).astype(
        np.int32)
    valid = rng.random(c) < p_valid
    dyn = np.ones(n, bool)
    dyn[:n_static] = False
    return ba, bb, valid, dyn


def _colors(ba, bb, valid, dyn, n, **kw):
    want = jsolver.color_pairs(jnp.asarray(ba), jnp.asarray(bb),
                               jnp.asarray(valid), jnp.asarray(dyn[ba]),
                               jnp.asarray(dyn[bb]), n, **kw)
    got = tsolver.color_pairs(_t(ba), _t(bb), _t(valid), _t(dyn[ba]),
                              _t(dyn[bb]), n, **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("class_cap", [0, 24])
def test_color_pairs_matches_jax_exactly(class_cap):
    """The Luby claim hash is uint32 arithmetic emulated in int64; colours
    must come out identical, residue included."""
    n, c = 600, 2500
    ba, bb, valid, dyn = _graph(0, n, c)
    got, want = _colors(ba, bb, valid, dyn, n, max_colors=16,
                        claim_rounds=4, class_cap=class_cap)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want[valid])) > 8
    if class_cap:
        assert (want[valid] == 0).any()  # the cap leaves residue here


def test_color_carry_over_and_greedy_assignment_match_jax():
    n, c = 300, 900
    ba, bb, valid, dyn = _graph(1, n, c)
    old, _ = _colors(ba, bb, valid, dyn, n, max_colors=24, claim_rounds=4,
                     class_cap=64)
    # the next broad phase: a permutation, a few pairs lost, a few new
    rng = np.random.default_rng(2)
    perm = rng.permutation(c)
    nba, nbb, nvalid = ba[perm].copy(), bb[perm].copy(), valid[perm].copy()
    nvalid[:20] = False
    nba[20:60] = rng.integers(0, n // 2, 40)
    nbb[20:60] = nba[20:60] + 1 + rng.integers(0, n // 2 - 1, 40)
    nvalid[20:60] = True
    args_j = [jnp.asarray(x) for x in (nba, nbb, nvalid, ba, bb, valid, old)]
    args_t = [_t(x) for x in (nba, nbb, nvalid, ba, bb, valid, old)]
    want = np.asarray(jsolver.transfer_pair_colors(*args_j))
    got = tsolver.transfer_pair_colors(*args_t)
    np.testing.assert_array_equal(got.numpy(), want)
    n_new = int((nvalid & (want == 0)).sum())
    assert 0 < n_new <= 128
    kw = dict(max_colors=24, class_cap=64, new_cap=128)
    want2 = jsolver.assign_new_pair_colors(
        jnp.asarray(nba), jnp.asarray(nbb), jnp.asarray(nvalid),
        jnp.asarray(want), jnp.asarray(dyn[nba]), jnp.asarray(dyn[nbb]), n,
        **kw)
    got2 = tsolver.assign_new_pair_colors(
        _t(nba), _t(nbb), _t(nvalid), got, _t(dyn[nba]), _t(dyn[nbb]), n,
        n_new=n_new, **kw)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))


def _solver_inputs(seed=3, n=64, c=180, max_colors=16):
    """Random contacts in colour-major pair-slot order, bodies, the layout
    and the rung ladder as numpy arrays (coloured by the port, whose
    colours are the JAX package's, ``test_color_pairs_matches_jax_exactly``).
    """
    ba, bb, pair_valid, dyn = _graph(seed, n, c, p_valid=1.0)
    rng = np.random.default_rng(seed)
    cols = tsolver.color_pairs(_t(ba), _t(bb), _t(pair_valid), _t(dyn[ba]),
                               _t(dyn[bb]), n, max_colors=max_colors,
                               claim_rounds=4, class_cap=0).numpy()
    perm = np.argsort(np.clip(cols, 0, max_colors), kind="stable")
    ba, bb, cols = ba[perm], bb[perm], cols[perm]
    counts = np.bincount(cols, minlength=max_colors + 2)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    windows = tuple(int(-(-k // 32) * 32)
                    for k in counts[1:max_colors + 1])
    normals = rng.normal(size=(c, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    contact = dict(
        body_a=ba, body_b=bb, normal_a=normals.astype(np.float32),
        points_a=rng.uniform(-0.3, 0.3, (c, 1, 3)).astype(np.float32),
        dist=rng.uniform(-0.05, 0.0, (c, 1)).astype(np.float32),
        num_points=np.ones(c, np.int32), valid=rng.random(c) < 0.9)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.3, 0.7, n).astype(np.float32)
    lin = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    ang = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    return dict(contact=contact, q=q, tr=tr, radii=radii, lin=lin, ang=ang,
                dyn=dyn, counts=counts, offsets=offsets, windows=windows,
                n=n, c=c, max_colors=max_colors, pair_valid=pair_valid)


def _port_bodies(x):
    """The port's bodies of :func:`_solver_inputs`."""
    tmp = tbody.ball_local_mprops(_t(x["radii"]), dynamic=_t(x["dyn"]))
    tposes = tsim.Sim(_t(x["q"]), _t(x["tr"]), torch.ones(x["n"]))
    return tbody.Bodies(tposes, tbody.Velocity(_t(x["lin"]), _t(x["ang"])),
                        tmp)


def _solver_setup(seed=3, n=64, c=180, max_colors=16):
    """:func:`_solver_inputs` with both packages' bodies and constraints."""
    x = _solver_inputs(seed, n, c, max_colors)
    contact = x["contact"]
    jmp = jbody.ball_local_mprops(jnp.asarray(x["radii"]),
                                  dynamic=jnp.asarray(x["dyn"]))
    jposes = jsim.Sim(jnp.asarray(x["q"]), jnp.asarray(x["tr"]), jnp.ones(n))
    jvels = jbody.Velocity(jnp.asarray(x["lin"]), jnp.asarray(x["ang"]))
    jb = jbody.Bodies(jposes, jvels, jmp)
    jc = jcons.build_constraints(
        jposes, jvels, jbody.update_mprops(jposes, jmp),
        jcons.Contacts(**{k: jnp.asarray(v) for k, v in contact.items()}),
        JaxSimParams())

    tb = _port_bodies(x)
    tc = tcons.build_constraints(
        tb.poses, tb.vels, tbody.update_mprops(tb.poses, tb.local_mprops),
        tcons.Contacts(**{k: _t(v) for k, v in contact.items()}),
        SimParams())
    # the layout/warmstart/sweep tests start from the JAX package's
    # constraints, so they measure those stages alone
    tj = tcons.ContactConstraints(**{
        f.name: _t(getattr(jc, f.name))
        for f in dataclasses.fields(tcons.ContactConstraints)})
    return dict(jb=jb, jc=jc, tb=tb, tc=tc, tj=tj, dyn=x["dyn"],
                counts=x["counts"], offsets=x["offsets"],
                windows=x["windows"], n=n, c=c, max_colors=max_colors,
                pair_valid=x["pair_valid"])


@pytest.fixture(scope="module")
def setup():
    return _solver_setup()


def test_build_constraints_matches_jax(setup):
    tc, jc = setup["tc"], setup["jc"]
    for f in dataclasses.fields(tcons.ContactConstraints):
        got, want = getattr(tc, f.name).numpy(), np.asarray(
            getattr(jc, f.name))
        assert got.shape == want.shape, f.name
        if want.dtype in (np.bool_, np.int32):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            # inverse-inertia products reach ~100 (radius 0.3 balls) and
            # sum three terms in another order
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f.name)


def test_packed_layout_sides_and_chain_match_jax(setup):
    """Pair-slot layout: the packed field matrix and its column map, the
    warmstart sides and the last-writer chain — the integer parts exact."""
    cmax = max(setup["windows"])
    jss, (jpf, jmeta) = jsolver.pad_solver_fields_packed(setup["jc"], cmax)
    tss, (tpf, tmeta) = tsolver.pad_solver_fields_packed(setup["tj"], cmax)
    assert {k: (a, tuple(t)) for k, (a, t) in jmeta.items()} == tmeta
    assert tmeta == pack_meta(1)
    np.testing.assert_array_equal(tpf.numpy(), np.asarray(jpf))
    dyn = setup["dyn"]
    ba, bb = tss.body_a.numpy(), tss.body_b.numpy()
    lv = np.concatenate([setup["pair_valid"], np.zeros(cmax, bool)])
    n = setup["n"]
    want = jsolver._build_sides(jnp.asarray(ba), jnp.asarray(bb),
                                jnp.asarray(dyn[ba]), jnp.asarray(dyn[bb]),
                                jnp.asarray(lv), n)
    got = tsolver._build_sides(_t(ba), _t(bb), _t(dyn[ba]), _t(dyn[bb]),
                               _t(lv), n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    off, cnt = setup["offsets"], setup["counts"]
    want = jsolver.build_gs_chain(jnp.asarray(ba), jnp.asarray(bb),
                                  jnp.asarray(dyn[ba]), jnp.asarray(dyn[bb]),
                                  jnp.asarray(off, jnp.int32),
                                  jnp.asarray(cnt, jnp.int32),
                                  setup["windows"], n)
    got = tsolver.build_gs_chain(_t(ba), _t(bb), _t(dyn[ba]), _t(dyn[bb]),
                                 [int(x) for x in off], [int(x) for x in cnt],
                                 setup["windows"], n)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_warmstart_matches_jax(setup):
    """By-key transfer (onto a shuffled copy), the per-side deltas and
    their segment-difference application."""
    rng = np.random.default_rng(9)
    c = setup["c"]
    imp_n = rng.uniform(0, 1, (c, 1)).astype(np.float32)
    imp_t = rng.normal(size=(c, 1, 2)).astype(np.float32)
    jprev = dataclasses.replace(setup["jc"], n_impulse=jnp.asarray(imp_n),
                                t_impulse=jnp.asarray(imp_t))
    tprev = dataclasses.replace(setup["tj"], n_impulse=_t(imp_n),
                                t_impulse=_t(imp_t))
    perm = rng.permutation(c)

    def shuffled(cons, conv):
        return dataclasses.replace(cons, **{
            f.name: conv(np.asarray(getattr(cons, f.name))[perm])
            for f in dataclasses.fields(cons)})

    jp, tp = JaxSimParams(), SimParams()
    want = jsolver.transfer_warmstart(shuffled(setup["jc"], jnp.asarray),
                                      jprev, jp)
    got = tsolver.transfer_warmstart(shuffled(setup["tj"], _t), tprev, tp)
    np.testing.assert_array_equal(got.n_impulse.numpy(),
                                  np.asarray(want.n_impulse))
    np.testing.assert_array_equal(got.t_impulse.numpy(),
                                  np.asarray(want.t_impulse))
    want = jsolver.slotwise_warmstart(setup["jc"], jprev, jp)
    got = tsolver.slotwise_warmstart(setup["tj"], tprev, tp)
    np.testing.assert_array_equal(got.n_impulse.numpy(),
                                  np.asarray(want.n_impulse))

    cmax = max(setup["windows"])
    jss, _ = jsolver.pad_solver_fields_packed(jprev, cmax)
    tss, _ = tsolver.pad_solver_fields_packed(tprev, cmax)
    n_s = np.concatenate([imp_n, np.zeros((cmax, 1), np.float32)])
    t_s = np.concatenate([imp_t, np.zeros((cmax, 1, 2), np.float32)])
    jd = jsolver._ws_deltas(jss, jnp.asarray(n_s), jnp.asarray(t_s),
                            jss.valid, 1)
    td = tsolver._ws_deltas(tss, _t(n_s), _t(t_s), tss.valid, 1)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    dyn, n = setup["dyn"], setup["n"]
    ba, bb, v = tss.body_a.numpy(), tss.body_b.numpy(), tss.valid.numpy()
    jsides = jsolver._build_sides(jnp.asarray(ba), jnp.asarray(bb),
                                  jnp.asarray(dyn[ba]), jnp.asarray(dyn[bb]),
                                  jnp.asarray(v), n)
    tsides = tsolver._build_sides(_t(ba), _t(bb), _t(dyn[ba]), _t(dyn[bb]),
                                  _t(v), n)
    want = jsolver._ws_apply(setup["jb"].vels, jd, jsides)
    got = tsolver._ws_apply(setup["tb"].vels, td, tsides)
    # a segment sum is a difference of two running prefix sums: it carries
    # the rounding of the running total, not of the segment
    np.testing.assert_allclose(got.linear.numpy(), np.asarray(want.linear),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.angular.numpy(),
                               np.asarray(want.angular), rtol=RTOL,
                               atol=ATOL)


def test_chained_rhs_sweeps_match_jax(setup):
    """One biased sweep (rhs rebuilt per rung from the stream-ridden poses)
    then one unbiased sweep (stored rhs, cfm 1), in both packages."""
    cmax = max(setup["windows"])
    windows, n, c = setup["windows"], setup["n"], setup["c"]
    jss, jpf = jsolver.pad_solver_fields_packed(setup["jc"], cmax)
    tss, tpf = tsolver.pad_solver_fields_packed(setup["tj"], cmax)
    dyn = setup["dyn"]
    ba, bb = tss.body_a.numpy(), tss.body_b.numpy()
    off = [int(x) for x in setup["offsets"]]
    cnt = [int(x) for x in setup["counts"]]
    jchain = jsolver.build_gs_chain(
        jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(dyn[ba]),
        jnp.asarray(dyn[bb]), jnp.asarray(off, jnp.int32),
        jnp.asarray(cnt, jnp.int32), windows, n)
    tchain = tsolver.build_gs_chain(_t(ba), _t(bb), _t(dyn[ba]),
                                    _t(dyn[bb]), off, cnt, windows, n)
    rng = np.random.default_rng(5)
    total = c + cmax
    n_s = rng.uniform(0, 0.2, (total, 1)).astype(np.float32)
    t_s = rng.normal(scale=0.05, size=(total, 1, 2)).astype(np.float32)
    jb, tb = setup["jb"], setup["tb"]
    pose = np.concatenate([np.asarray(jb.poses.rotation),
                           np.asarray(jb.poses.translation),
                           np.asarray(jb.poses.scale)[:, None]], -1)
    sub = SimParams().substep()
    consts = (sub.inv_dt, sub.contact_erp_inv_dt, sub.allowed_linear_error,
              sub.max_corrective_velocity, sub.contact_cfm_factor)
    layout = (jnp.zeros(total, jnp.int32), jnp.asarray(off, jnp.int32),
              jnp.asarray(cnt, jnp.int32))
    jkw = dict(cmax=cmax, dim=3, packed_fields=jpf, windows=windows,
               chain=jchain, rhs_consts=consts)
    jv, jn, jt, jrhs = jsolver.gs_color_major_pass(
        jss, jb.vels, jnp.asarray(n_s), jnp.asarray(t_s), layout,
        jnp.int32(len(windows)), rhs_mode="biased",
        pose_tab=jnp.asarray(pose),
        rhs_store=jnp.zeros((total, 1), jnp.float32), **jkw)
    jv, jn, jt, _ = jsolver.gs_color_major_pass(
        jss, jv, jn, jt, layout, jnp.int32(len(windows)),
        rhs_mode="unbiased", rhs_store=jrhs, **jkw)

    tkw = dict(packed_fields=tpf, rhs_consts=consts)
    tv, tn, tt, trhs = tsolver.gs_color_major_pass(
        tss, tb.vels, _t(n_s), _t(t_s), (off, cnt), windows, tchain,
        rhs_mode="biased", pose_tab=_t(pose),
        rhs_store=torch.zeros((total, 1)), **tkw)
    np.testing.assert_allclose(trhs.numpy(), np.asarray(jrhs), rtol=RTOL,
                               atol=ATOL)
    tv, tn, tt, _ = tsolver.gs_color_major_pass(
        tss, tv, tn, tt, (off, cnt), windows, tchain, rhs_mode="unbiased",
        rhs_store=trhs, **tkw)
    # XLA on the CPU fuses a*b+c into one rounding, PyTorch rounds the
    # product; the rhs rebuild multiplies the difference of two ~3 m world
    # points by inv_dt = 240, and two Gauss-Seidel sweeps carry that on
    for got, want in ((tv.linear, jv.linear), (tv.angular, jv.angular),
                      (tn, jn), (tt, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-4)
    assert float(np.abs(np.asarray(jn) - n_s).max()) > 1e-3  # impulses moved
