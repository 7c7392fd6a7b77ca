"""The port's fused-solver modules against the JAX package on the same seeded
inputs: the static rung-padded compaction (integers exact, rungs that fit
and rungs that overflow), the field layout, the fused constraint build
(B9's plain version), the per-colour gather / inverse tables (exact), and
the plain versions of the fused sweep (B10), the substep opening (B11) and
the pose update (B12), alone and carried by the sweep. Where the JAX
function reaches a Pallas kernel it runs both in interpret mode and through
its XLA twin.

On the CPU the port's wrappers run their plain versions; the CUDA kernels
are held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).

The JAX package's results on these inputs are read from
``artifacts/torch_fused_jax.npz``, written by
``scripts/export_port_tests_npz.py --only fused`` from the same input
helpers as below (the JAX calls, three Pallas kernels in interpret mode
among them, cost ~100 s on the CPU; no assertion or tolerance changed when
they moved there)."""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_solver import _graph, _t
from wgmath_tpu_torch.dynamics import body as tbody
from wgmath_tpu_torch.dynamics import build_fused as tbuild
from wgmath_tpu_torch.dynamics import constraint as tcons
from wgmath_tpu_torch.dynamics import gs_fused as tfused
from wgmath_tpu_torch.dynamics.gs_math import PACK_FIELDS
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import sim as tsim
from tests.torch_threads import one_torch_thread  # noqa: F401

# the JAX package's own tolerance for the fused sweep and the pose update
# (tests/test_gs_fused.py)
RTOL, ATOL = 1e-5, 1e-6
# the sweep against XLA on the CPU: XLA contracts a*b+c into one rounding
# where PyTorch rounds the product (ROADMAP C); measured 4.3e-6 on the
# velocity table, up to 2.4x the limit above
SWEEP_RTOL, SWEEP_ATOL = 1e-4, 1e-5
# the substep opening rebuilds the rhs from two ~3 m world points whose
# drift is multiplied by 1/dt = 240 (one ulp of a world point is 5.7e-5 of
# rhs): a float64 run of the same inputs lies 1.5e-4 (rhs) and 6.3e-4
# (velocities) from EITHER float32 run, and the two differ by up to 8.7e-4
SUBSTEP_RTOL, SUBSTEP_ATOL = 1e-3, 2e-3
S_LEN = 2
N_BODIES = 64
NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "torch_fused_jax.npz")
# the fused cases: id -> (P, rung0, pairs, colours). XLA's compile time
# grows with P times the colour count, so the P = 4 case is a smaller graph
CASES = {"P1-rung0-0": (1, 0, 260, 12), "P1-rung0-32": (1, 32, 260, 12),
         "P4-rung0-32": (4, 32, 120, 6)}
STATIC_RUNGS = (16, 4)
_CONTACT_FIELDS = ("body_a", "body_b", "normal_a", "points_a", "dist",
                   "num_points", "valid")


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return dict(f)


def _stored_compaction(z, pre):
    """JAX's ``compact_contacts`` result stored under ``pre``: (Contacts
    fields as a namespace, live count, slot colours, class counts)."""
    return (SimpleNamespace(**{f: z[f"{pre}.{f}"] for f in _CONTACT_FIELDS}),
            z[f"{pre}.count"], z[f"{pre}.colors"], z[f"{pre}.class_counts"])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def compact_port(contact, colors, windows):
    return tcons.compact_contacts(
        tcons.Contacts(**{k: _t(v) for k, v in contact.items()}), 0,
        extra=_t(colors), sort_by_extra=True, static_windows=windows)


def _raw_contacts(rng, ba, bb, p_max):
    c = ba.shape[0]
    normals = rng.normal(size=(c, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    return dict(
        body_a=ba, body_b=bb, normal_a=normals.astype(np.float32),
        points_a=rng.uniform(-0.3, 0.3, (c, p_max, 3)).astype(np.float32),
        dist=rng.uniform(-0.05, 0.01, (c, p_max)).astype(np.float32),
        num_points=rng.integers(1, p_max + 1, c).astype(np.int32),
        valid=rng.random(c) < 0.9)


def setup_inputs(seed, p_max, n_pairs):
    """The numpy inputs of a fused case: a pair graph, its contacts and
    the bodies (the colours are the JAX package's, ``setup.<id>.colors``)."""
    n = N_BODIES
    ba, bb, _, dyn = _graph(seed, n, n_pairs, p_valid=1.0)
    rng = np.random.default_rng(seed)
    contact = _raw_contacts(rng, ba, bb, p_max)
    q = rng.normal(size=(n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    radii = rng.uniform(0.3, 0.7, n).astype(np.float32)
    lin = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    ang = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    return dict(n=n, ba=ba, bb=bb, dyn=dyn, contact=contact, q=q, tr=tr,
                radii=radii, lin=lin, ang=ang)


def rungs(colors, valid, max_colors):
    """The class counts, and each colour's rung rounded up to 16 (at least
    16, so an empty colour keeps a rung)."""
    cc = np.bincount(np.where(valid, colors, 0), minlength=max_colors + 1)
    return cc, tuple(int(max(16, -(-k // 16) * 16))
                     for k in cc[1:max_colors + 1])


def _setup(z, case):
    """Random contacts on a properly coloured pair graph (a residue class
    under the class cap), compacted to the static layout by the port (the
    JAX package's compaction read from the file), with the port's
    bodies."""
    p_max, rung0, n_pairs, max_colors = CASES[case]
    x = setup_inputs(5 + p_max + rung0, p_max, n_pairs)
    n = x["n"]
    colors = z[f"setup.{case}.colors"]
    cc, windows = rungs(colors, x["contact"]["valid"], max_colors)
    got = compact_port(x["contact"], colors, (rung0,) + windows)
    want = _stored_compaction(z, f"setup.{case}.compact")
    tposes = tsim.Sim(_t(x["q"]), _t(x["tr"]), torch.ones(n))
    tvels = tbody.Velocity(_t(x["lin"]), _t(x["ang"]))
    tmp = tbody.update_mprops(tposes, tbody.ball_local_mprops(
        _t(x["radii"]), dynamic=_t(x["dyn"])))
    return dict(n=n, windows=windows, rung0=rung0, p_max=p_max, got=got,
                want=want, t=(tposes, tvels, tmp), q=x["q"], tr=x["tr"],
                cc=cc, case=case)


def static_inputs():
    rng = np.random.default_rng(11)
    ba, bb, _, _ = _graph(11, 40, 120, p_valid=1.0)
    contact = _raw_contacts(rng, ba, bb, 1)
    colors = rng.integers(0, 9, 120).astype(np.int32)
    return contact, colors


@pytest.mark.parametrize("rung", [16, 4], ids=["fits", "overflows"])
def test_compact_static_windows_matches_jax(z, rung):
    """Every field of the rung-padded buffer, the slot colours, the live
    count and the TRUE per-class counts, bit for bit; a rung smaller than
    its class drops the class's last entries."""
    contact, colors = static_inputs()
    windows = (rung,) * 9
    got = compact_port(contact, colors, windows)
    want = _stored_compaction(z, f"static.{rung}")
    assert len(got) == int(z[f"static.{rung}.len"]) == 4
    assert int(got[1]) == int(want[1]) == int(contact["valid"].sum())
    for f in dataclasses.fields(tcons.Contacts):
        np.testing.assert_array_equal(_np(getattr(got[0], f.name)),
                                      _np(getattr(want[0], f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(_np(got[2]), _np(want[2]))
    np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
    kept = int(got[0].valid.sum())
    assert (kept < int(got[1])) == (rung == 4)
    assert got[0].body_a.shape == (9 * rung,)


@pytest.mark.parametrize("p_max", [1, 4])
def test_field_meta_matches_jax(z, p_max):
    want = {k: (a, tuple(t)) for k, (a, t) in json.loads(str(
        z[f"meta.{p_max}.json"])).items()}
    k_want = int(z[f"meta.{p_max}.k"])
    got, k_got = tbuild.field_meta(p_max, S_LEN)
    assert k_got == k_want and (p_max > 1 or k_got == 71)
    assert got == want
    assert got["cfm_factor"][0] == (66 if p_max == 1 else 216)


@pytest.fixture(scope="module", params=list(CASES))
def setup(request, z):
    """(P, rung0, pairs, colours): XLA's compile time grows with P times
    the colour count, so the P = 4 case is a smaller graph."""
    return _setup(z, request.param)


def jax_routes(p_max, rung0):
    """The JAX routes a case is held against: always the XLA twin; the
    Pallas kernel in interpret mode too in the P = 1, rung0 > 0 case (the
    interpreter costs ~10 s a kernel at these sizes)."""
    return (False, True) if (p_max, rung0) == (1, 32) else (False,)


def _jax_routes(setup):
    return jax_routes(setup["p_max"], setup["rung0"])


def test_setup_compaction_matches_jax(setup):
    got, want = setup["got"], setup["want"]
    for f in dataclasses.fields(tcons.Contacts):
        np.testing.assert_array_equal(_np(getattr(got[0], f.name)),
                                      _np(getattr(want[0], f.name)),
                                      err_msg=f.name)
    np.testing.assert_array_equal(_np(got[3]), _np(want[3]))
    cc = setup["cc"]
    assert cc[0] > 0 and (cc[1:] == 0).any()  # residue and empty colours


def test_build_constraints_fused_matches_jax(z, setup, tables):
    """B9's plain version against the JAX package's: every field of every
    live column within the JAX test's tolerance (1e-5 + 2e-6 max|field|:
    cancellation in the torque terms scales with the field's magnitude),
    the integer fields exact. The rung padding's columns (dist 1e9, never
    read: inactive) carry torques that cancel two ~5e8 terms, which the two
    packages round differently, so they are held to that scale."""
    tc = setup["got"][0]
    t_cons, t_big, t_meta = tbuild.build_constraints_fused(
        *setup["t"], tc, SimParams())
    assert t_big.shape[0] == tbuild.field_meta(setup["p_max"], S_LEN)[1]
    live = _np(tc.valid)
    assert live.any() and not live.all()
    for use_pallas in _jax_routes(setup):
        # the XLA route's constraints are the tables' own
        j_cons, j_big, j_meta = _stored_build(z, setup["case"], "pallas") \
            if use_pallas else tables[:3]
        assert t_meta == j_meta
        jb = np.asarray(j_big)
        for f, (at, tail) in t_meta.items():
            k = int(np.prod(tail)) if tail else 1
            want, got = jb[at:at + k], _np(t_big[at:at + k])
            tol = 1e-5 + 2e-6 * float(np.abs(want[:, live]).max(initial=0))
            d = np.abs(got - want)[:, live].max(initial=0.0)
            assert d <= tol, (f, use_pallas, d, tol)
            np.testing.assert_allclose(got[:, ~live], want[:, ~live],
                                       rtol=1e-5, atol=1e-6 * 5e8)
            np.testing.assert_array_equal(
                _np(getattr(t_cons, f)),
                _np(t_big[at:at + k]).T.reshape((-1,) + tuple(tail)))
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(_np(getattr(t_cons, f)),
                                      _np(getattr(j_cons, f)))


def test_build_fused_plain_reads_the_padded_table_and_strided_views(
        setup, tables):
    """B9's plain version on what the kernel reads: the 32-float body table
    (the 29 fields, then zeros) and the compacted contacts' float fields as
    they come, column views of one gathered matrix. Equal to its run on
    contiguous copies, and to the JAX package's fused build within
    :func:`test_build_constraints_fused_matches_jax`'s tolerances."""
    p_max = setup["p_max"]
    tc = setup["got"][0]
    packed = tbuild._packed_bodies(*setup["t"])
    assert packed.shape == (setup["n"], tbuild.W_SIDE) == (setup["n"], 32)
    assert not packed[:, tbuild.SIDE_OFFS[-1]:].any()
    width = 3 + 4 * p_max  # normal, points, dist side by side
    assert tc.normal_a.stride() == (width, 1)
    assert tc.points_a.stride() == (width, 3, 1)
    assert not tc.normal_a.is_contiguous()
    assert tc.normal_a.untyped_storage().data_ptr() == \
        tc.points_a.untyped_storage().data_ptr()
    meta, k_all = tbuild.field_meta(p_max, S_LEN)
    p = SimParams()
    consts = (p.restitution, p.inv_dt, p.friction, p.contact_cfm_factor)
    got = tbuild._build_torch(packed, tc, consts, meta, k_all, p_max)
    copies = dataclasses.replace(
        tc, normal_a=tc.normal_a.contiguous(),
        points_a=tc.points_a.contiguous(), dist=tc.dist.contiguous())
    assert torch.equal(
        got, tbuild._build_torch(packed[:, :29].contiguous(), copies, consts,
                                 meta, k_all, p_max))
    want = tables[1]  # the JAX package's bigT (XLA route)
    live = _np(tc.valid)
    g = _np(got)
    for f, (at, tail) in meta.items():
        k = int(np.prod(tail)) if tail else 1
        w = want[at:at + k]
        tol = 1e-5 + 2e-6 * float(np.abs(w[:, live]).max(initial=0))
        assert np.abs(g[at:at + k] - w)[:, live].max(initial=0.0) <= tol, f
        np.testing.assert_allclose(g[at:at + k][:, ~live], w[:, ~live],
                                   rtol=1e-5, atol=1e-6 * 5e8)


def test_build_fused_kernel_reads_contact_fields_in_place_or_raises():
    """The row strides B9's wrapper passes for the compaction's views,
    and its refusal of a view the kernel cannot read in place (no silent
    copy)."""
    big = torch.zeros((5, 3 + 4 * 4 + 3))  # one padding column
    normal, points = big[:, :3], big[:, 3:15].reshape(5, 4, 3)
    dist = big[:, 15:19]
    assert tbuild._row_stride(normal, "normal_a", (3,)) == 22
    assert tbuild._row_stride(points, "points_a", (4, 3)) == 22
    assert tbuild._row_stride(dist, "dist", (4,)) == 22
    assert tbuild._row_stride(big[:, 15:16], "dist", (1,)) == 22
    with pytest.raises(ValueError, match="stride"):
        tbuild._row_stride(big[:, 0:6:2], "normal_a", (3,))
    with pytest.raises(ValueError, match="stride"):
        tbuild._row_stride(big[:, 3:15].reshape(5, 3, 4).transpose(1, 2),
                           "points_a", (4, 3))
    with pytest.raises(ValueError, match="stride"):
        tbuild._row_stride(big[:, 3:19].reshape(5, 4, 4)[:, :, :3],
                           "points_a", (4, 3))
    raw = bytearray(64)
    unaligned = torch.frombuffer(raw, dtype=torch.float32, offset=1,
                                 count=15).reshape(5, 3)
    with pytest.raises(ValueError, match="aligned"):
        tbuild._row_stride(unaligned, "normal_a", (3,))


@pytest.fixture(scope="module")
def tables(setup, z):
    """:func:`_tables` of the case, computed once for the tests that read
    it."""
    return _tables(setup, z)


_BUILD_FIELDS = ("body_a", "body_b", "valid", "num_points", "im_a", "im_b")


def _stored_build(z, case, route):
    """JAX's ``build_constraints_fused`` of a case by ``route`` ("xla",
    "pallas"): (constraint fields read here, bigT, field meta)."""
    pre = f"setup.{case}.build.{route}"
    cons = SimpleNamespace(**{f: z[f"{pre}.{f}"] for f in _BUILD_FIELDS})
    meta = {k: (a, tuple(t)) for k, (a, t) in json.loads(str(
        z[f"{pre}.meta_json"])).items()}
    return cons, z[f"{pre}.big"], meta


def _tables(setup, z):
    """Both packages' idx / inv from the JAX package's fused constraints
    (XLA route)."""
    case = setup["case"]
    j_cons, j_big, j_meta = _stored_build(z, case, "xla")
    windows, rung0 = setup["windows"], setup["rung0"]
    w_g = int(z[f"setup.{case}.w_g"])
    assert w_g == tfused.gather_width(setup["n"], windows)
    dyn_a = np.any(j_cons.im_a != 0.0, axis=-1)
    dyn_b = np.any(j_cons.im_b != 0.0, axis=-1)
    want = (z[f"setup.{case}.idx"], z[f"setup.{case}.inv"])
    got = tfused.build_fused_tables(
        _t(j_cons.body_a), _t(j_cons.body_b), _t(dyn_a), _t(dyn_b),
        _t(j_cons.valid), windows=windows, rung0=rung0, w_g=w_g)
    return j_cons, j_big, j_meta, w_g, got, want


def test_build_fused_tables_exact(setup, tables):
    _, _, _, w_g, got, want = tables
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(_np(g), _np(w))
    inv = _np(got[1])
    assert (inv == w_g - 1).any() and (inv < w_g - 1).any()
    assert tfused.fused_layout(setup["windows"], setup["rung0"])[2] == \
        setup["got"][0].body_a.shape[0]


def sweep_arrays(p_max, n, q, tr, ctot, w_g, seed):
    """The seeded operands of the sweep and substep kernels (numpy):
    velocities, impulses, rhs and poses."""
    rng = np.random.default_rng(seed)
    vt = np.zeros((8, w_g), np.float32)
    vt[0:6, :n] = rng.normal(scale=0.5, size=(6, n))
    n_imp = rng.uniform(0.0, 0.1, (p_max, ctot)).astype(np.float32)
    t_imp = rng.uniform(-0.02, 0.02, (p_max * S_LEN, ctot)).astype(
        np.float32)
    n_rhs = rng.uniform(-1.0, 1.0, (p_max, ctot)).astype(np.float32)
    t_rhs = rng.uniform(-0.1, 0.1, (p_max * S_LEN, ctot)).astype(np.float32)
    pose = np.zeros((8, w_g), np.float32)
    pose[0:4, :n] = q.T
    pose[4:7, :n] = tr.T
    pose[7, :n] = 1.0
    return dict(vt=vt, n_imp=n_imp, t_imp=t_imp, n_rhs=n_rhs, t_rhs=t_rhs,
                pose=pose)


RELIN = ("t_rhs_wo_bias", "local_pt_a", "local_pt_b", "info_dist",
         "info_normal_vel")


def sweep_layout(j_meta):
    """The packed fields' meta (the JAX package's ``_PACK_FIELDS`` order,
    the port's ``gs_math.PACK_FIELDS``), the window's row count and the
    relinearization source's first row and meta."""
    meta = {f: tuple(j_meta[f]) for f in PACK_FIELDS}
    k_pack = j_meta["cfm_factor"][0]
    src0 = min(j_meta[f][0] for f in RELIN)
    src_meta = {f: (j_meta[f][0] - src0, tuple(j_meta[f][1])) for f in RELIN}
    return meta, k_pack, src0, src_meta


def _sweep_inputs(setup, tables, seed):
    """Operands of the sweep and substep kernels: the JAX package's fused
    constraint matrix, seeded velocities, impulses and rhs, the tables."""
    j_cons, j_big, j_meta, w_g, (t_idx, t_inv), _ = tables
    p_max, n = setup["p_max"], setup["n"]
    windows, rung0 = setup["windows"], setup["rung0"]
    ctot = j_big.shape[1]
    meta, k_pack, src0, src_meta = sweep_layout(j_meta)
    arrays = sweep_arrays(p_max, n, setup["q"], setup["tr"], ctot, w_g, seed)
    counts = np.concatenate([setup["cc"], [0]]).astype(np.int32)
    active = np.asarray(j_cons.valid, np.float32)[None]
    nump = np.asarray(j_cons.num_points, np.float32)[None]
    arrays.update(win=j_big[:k_pack], src=j_big[src0:], active=active,
                  nump=nump, counts=counts)
    kw = dict(windows=windows, rung0=rung0, p_max=p_max, s_len=S_LEN)
    return arrays, (t_idx, t_inv), kw, meta, src_meta


def _close(got, want, what, rtol, atol):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=f"{what} output {i}")


def _stored(z, pre):
    """The outputs stored under ``pre`` (``pre.0``, ``pre.1``, ...)."""
    out, k = [], 0
    while f"{pre}.{k}" in z:
        out.append(z[f"{pre}.{k}"])
        k += 1
    return out


def _route(use_pallas):
    return "pallas" if use_pallas else "xla"


def test_fused_sweep_plain_matches_jax(z, setup, tables):
    a, (t_idx, t_inv), kw, meta, _ = _sweep_inputs(setup, tables, 1)
    t_args = (_t(a["vt"]), _t(a["n_imp"]), _t(a["t_imp"]), _t(a["win"]),
              _t(a["active"]), _t(a["nump"]), 0.93, _t(a["n_rhs"]),
              _t(a["t_rhs"]), t_idx, t_inv,
              torch.from_numpy(a["counts"]))
    got = tfused.fused_sweep(*t_args, meta=meta, **kw)
    for use_pallas in _jax_routes(setup):
        want = _stored(z, f"setup.{setup['case']}.sweep."
                          f"{_route(use_pallas)}")
        assert len(want) == 3
        _close(got, want, f"fused_sweep (pallas={use_pallas})", SWEEP_RTOL,
               SWEEP_ATOL)
    # the sweep moved every live colour and left the padding untouched
    assert not np.allclose(_np(got[1]), a["n_imp"])
    live = _np(got[1])[:, _np(t_args[4])[0] > 0.5]
    assert np.isfinite(live).all()


SUBSTEP_SCALARS = (0.85, 0.93, 240.0, 175.3, 1e-3, 10.0)


def test_fused_substep1_plain_matches_jax(z, setup, tables):
    a, (t_idx, t_inv), kw, meta, src_meta = _sweep_inputs(setup, tables, 2)
    scalars = SUBSTEP_SCALARS
    got = tfused.fused_substep1(
        _t(a["vt"]), _t(a["n_imp"]), _t(a["t_imp"]), _t(a["win"]),
        _t(a["src"]), _t(a["pose"]), _t(a["active"]), _t(a["nump"]), t_idx,
        t_inv, torch.from_numpy(a["counts"]), meta=meta, src_meta=src_meta,
        scalars=scalars, **kw)
    for use_pallas in _jax_routes(setup):
        want = _stored(z, f"setup.{setup['case']}.substep."
                          f"{_route(use_pallas)}")
        assert len(want) == len(got)
        _close(got, want, f"fused_substep1 (pallas={use_pallas})",
               SUBSTEP_RTOL, SUBSTEP_ATOL)
    # the residue rows are scaled, not swept; rows past every class are 0
    r0 = setup["rung0"]
    np.testing.assert_array_equal(_np(got[1])[:, :r0],
                                  (a["n_imp"] * np.float32(0.85))[:, :r0])


def carry_inputs(vt):
    """B10 carrying B12's extra operands: the velocities with small-angle
    and still lanes, and the centres of mass."""
    vt = vt.copy()
    vt[3:6, :8] *= 1e-5  # angle below 1e-6: the small-angle branch
    vt[3:6, 8:12] = 0.0
    com = np.random.default_rng(4).uniform(
        -0.1, 0.1, (3, vt.shape[1])).astype(np.float32)
    return vt, com


INTEGRATE_DT = 1.0 / 240.0


def test_fused_sweep_carrying_integrate_matches_jax(z, setup, tables):
    """``fused_sweep(..., integrate=...)`` (B10 carrying B12): the sweep's
    outputs are JAX's ``fused_sweep``'s and the same as without the
    integrate, bit for bit; the poses are JAX's ``fused_integrate`` of the
    sweep's input velocities (small-angle lanes included) and
    ``fused_integrate``'s, bit for bit."""
    a, (t_idx, t_inv), kw, meta, _ = _sweep_inputs(setup, tables, 1)
    vt, com = carry_inputs(a["vt"])
    dt = INTEGRATE_DT
    t_args = (_t(vt), _t(a["n_imp"]), _t(a["t_imp"]), _t(a["win"]),
              _t(a["active"]), _t(a["nump"]), 0.93, _t(a["n_rhs"]),
              _t(a["t_rhs"]), t_idx, t_inv, torch.from_numpy(a["counts"]))
    got = tfused.fused_sweep(*t_args, meta=meta,
                             integrate=(_t(a["pose"]), _t(com), dt), **kw)
    assert len(got) == 4
    alone = tfused.fused_sweep(*t_args, meta=meta, **kw)
    assert all(torch.equal(g, w) for g, w in zip(got[:3], alone))
    assert torch.equal(got[3], tfused.fused_integrate(
        _t(a["pose"]), _t(vt), _t(com), dt))
    pre = f"setup.{setup['case']}.carry"
    for use_pallas in _jax_routes(setup):
        want = _stored(z, f"{pre}.sweep.{_route(use_pallas)}")
        assert len(want) == 3
        _close(got[:3], want, f"fused_sweep (pallas={use_pallas})",
               SWEEP_RTOL, SWEEP_ATOL)
    for use_pallas in (False, True):
        want = z[f"{pre}.integrate.{_route(use_pallas)}"]
        _close(got[3:], [want], f"fused_integrate (pallas={use_pallas})",
               RTOL, ATOL)


def integrate_inputs():
    rng = np.random.default_rng(9)
    lanes = 384
    q = rng.normal(size=(4, lanes))
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    pose = np.concatenate([q, rng.uniform(-20, 20, (3, lanes)),
                           rng.uniform(0.9, 1.1, (1, lanes))]).astype(
        np.float32)
    vt = np.zeros((8, lanes), np.float32)
    vt[0:6] = rng.normal(scale=2.0, size=(6, lanes))
    vt[3:6, :64] *= 1e-5  # angle below 1e-6: the small-angle branch
    vt[3:6, 64:80] = 0.0
    com = rng.uniform(-0.1, 0.1, (3, lanes)).astype(np.float32)
    return pose, vt, com


def test_fused_integrate_plain_matches_jax(z):
    pose, vt, com = integrate_inputs()
    dt = INTEGRATE_DT
    got = tfused.fused_integrate(_t(pose), _t(vt), _t(com), dt)
    for use_pallas in (False, True):
        want = z[f"integrate.{_route(use_pallas)}"]
        np.testing.assert_allclose(_np(got), want, rtol=RTOL, atol=ATOL)
    qn = np.linalg.norm(_np(got)[0:4], axis=0)
    np.testing.assert_allclose(qn, 1.0, atol=1e-6)
    np.testing.assert_array_equal(_np(got)[7], pose[7])
