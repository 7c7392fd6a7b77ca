"""The port's ladder-path pieces against the JAX package on the same seeded
inputs: contact compaction (both branches, integers exact, overflow
count), the sorted-space rhs relinearization, the colour layout and the
one-gather field sort (exact), the sorted-sides warmstart, and one ladder
sweep and one plain chained sweep of ``gs_color_major_pass``."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_torch_solver import _solver_setup, _t
from wgmath_tpu.dynamics import SimParams as JaxSimParams
from wgmath_tpu.dynamics import constraint as jcons
from wgmath_tpu.dynamics import solver as jsolver
from wgmath_tpu.geometry import sim as jsim
from wgmath_tpu_torch.dynamics import constraint as tcons
from wgmath_tpu_torch.dynamics import solver as tsolver
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import sim as tsim

# the GS impulse math's tolerance (the JAX package's, for the same math)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def setup():
    return _solver_setup(seed=4)


def _contacts(seed, c=300, p_max=1):
    rng = np.random.default_rng(seed)
    return dict(
        body_a=rng.integers(0, 50, c).astype(np.int32),
        body_b=rng.integers(50, 100, c).astype(np.int32),
        normal_a=rng.normal(size=(c, 3)).astype(np.float32),
        points_a=rng.normal(size=(c, p_max, 3)).astype(np.float32),
        dist=rng.uniform(-0.1, 0.1, (c, p_max)).astype(np.float32),
        num_points=rng.integers(1, p_max + 1, c).astype(np.int32),
        valid=rng.random(c) < 0.6), rng.integers(0, 13, c).astype(np.int32)


@pytest.mark.parametrize("capacity", [256, 100], ids=["fits", "overflows"])
@pytest.mark.parametrize("branch", ["cumsum", "cumsum_extra", "sorted"])
def test_compact_contacts_matches_jax(branch, capacity):
    """Every field of the compacted buffer, the carried colours and the
    true count come out as in the JAX package — bit for bit, since
    compaction only moves rows. A count above the capacity is the overflow
    signal."""
    contact, colors = _contacts(7)
    kw = {"cumsum": {}, "cumsum_extra": dict(extra=colors),
          "sorted": dict(extra=colors, sort_by_extra=True)}[branch]
    want = jcons.compact_contacts(
        jcons.Contacts(**{k: jnp.asarray(v) for k, v in contact.items()}),
        capacity, **{k: jnp.asarray(v) if k == "extra" else v
                     for k, v in kw.items()})
    got = tcons.compact_contacts(
        tcons.Contacts(**{k: _t(v) for k, v in contact.items()}), capacity,
        **{k: _t(v) if k == "extra" else v for k, v in kw.items()})
    assert len(got) == len(want) == (2 if branch == "cumsum" else 3)
    n_valid = int(contact["valid"].sum())
    assert int(got[1]) == int(want[1]) == n_valid
    assert (n_valid > capacity) == (capacity == 100)
    for f in dataclasses.fields(tcons.Contacts):
        np.testing.assert_array_equal(getattr(got[0], f.name).numpy(),
                                      np.asarray(getattr(want[0], f.name)),
                                      err_msg=f.name)
    if branch != "cumsum":
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if branch == "sorted":
        live = got[2].numpy()[:min(n_valid, capacity)]
        assert (np.diff(live) >= 0).all()  # colour-major


def _moved_poses(setup, seed=12):
    """The setup's poses after a small substep-sized motion."""
    rng = np.random.default_rng(seed)
    jb = setup["jb"]
    n = setup["n"]
    q = np.asarray(jb.poses.rotation) + rng.normal(scale=1e-3, size=(n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = (np.asarray(jb.poses.translation)
          + rng.normal(scale=2e-3, size=(n, 3))).astype(np.float32)
    return (jsim.Sim(jnp.asarray(q), jnp.asarray(tr), jnp.ones(n)),
            tsim.Sim(_t(q), _t(tr), torch.ones(n)))


def test_update_rhs_sorted_matches_jax(setup):
    jposes, tposes = _moved_poses(setup)
    jsub, tsub = JaxSimParams().substep(), SimParams().substep()
    want = jcons.update_rhs_sorted(setup["jc"], jposes, jsub)
    got = tcons.update_rhs_sorted(setup["tj"], tposes, tsub)
    # the drift is the difference of two ~3 m world points (one ulp is
    # 2.4e-7) times inv_dt = 240, and XLA on the CPU fuses a*b+c into one
    # rounding where PyTorch rounds the product: atol 2e-4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=2e-4)
    assert float(np.abs(np.asarray(want[0])
                        - np.asarray(setup["jc"].n_rhs)).max()) > 1e-2


def test_remove_cfm_and_bias_matches_jax(setup):
    want = jcons.remove_cfm_and_bias(setup["jc"])
    got = tcons.remove_cfm_and_bias(setup["tj"])
    for f in ("n_rhs", "t_rhs", "cfm_factor", "n_rhs_wo_bias"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert float(got.cfm_factor.min()) == 1.0


def _shuffled(setup, seed=21):
    """The setup's constraints out of colour order, with their colours."""
    rng = np.random.default_rng(seed)
    c, mc = setup["c"], setup["max_colors"]
    perm = rng.permutation(c)
    colors = np.repeat(np.arange(mc + 2), setup["counts"])[perm].astype(
        np.int32)
    take = lambda cons, conv: dataclasses.replace(cons, **{
        f.name: conv(np.asarray(getattr(cons, f.name))[perm])
        for f in dataclasses.fields(cons)})
    return take(setup["jc"], jnp.asarray), take(setup["tj"], _t), colors


def test_color_layout_and_field_sort_match_jax(setup):
    """``build_color_layout`` (order, offsets, counts) and the one-gather
    sort of every solver field: integers and the gathered matrix exact."""
    jc, tc, colors = _shuffled(setup)
    mc, cmax = setup["max_colors"], max(setup["windows"])
    want = jsolver.build_color_layout(jnp.asarray(colors), jc.valid,
                                      max_colors=mc, cmax=cmax)
    got = tsolver.build_color_layout(_t(colors), tc.valid, max_colors=mc,
                                     cmax=cmax)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jss, (jpf, jmeta) = jsolver.sort_solver_fields_packed(jc, want[0])
    tss, (tpf, tmeta) = tsolver.sort_solver_fields_packed(tc, got[0])
    assert {k: (a, tuple(t)) for k, (a, t) in jmeta.items()} == tmeta
    np.testing.assert_array_equal(tpf.numpy(), np.asarray(jpf))
    assert vars(tss).keys() == vars(jss).keys()
    for f in vars(jss):
        np.testing.assert_array_equal(getattr(tss, f).numpy(),
                                      np.asarray(getattr(jss, f)), f)
    assert not tss.valid[-cmax:].any() and not tss.num_points[-cmax:].any()


def test_pack_sorted_fields_matches_jax(setup):
    jpf, jmeta = jsolver.pack_sorted_fields(setup["jc"])
    tpf, tmeta = tsolver.pack_sorted_fields(setup["tj"])
    assert {k: (a, tuple(t)) for k, (a, t) in jmeta.items()} == tmeta
    np.testing.assert_array_equal(tpf.numpy(), np.asarray(jpf))


def test_sorted_sides_warmstart_matches_jax(setup):
    rng = np.random.default_rng(31)
    c, n = setup["c"], setup["n"]
    imp_n = rng.uniform(0, 1, (c, 1)).astype(np.float32)
    imp_t = rng.normal(size=(c, 1, 2)).astype(np.float32)
    jc = dataclasses.replace(setup["jc"], n_impulse=jnp.asarray(imp_n),
                             t_impulse=jnp.asarray(imp_t))
    tc = dataclasses.replace(setup["tj"], n_impulse=_t(imp_n),
                             t_impulse=_t(imp_t))
    jsides = jsolver.build_sorted_sides(jc, n)
    tsides = tsolver.build_sorted_sides(tc, n)
    for g, w in zip(tsides, jsides):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jsolver.warmstart_apply_sorted(jc, setup["jb"].vels, jsides)
    got = tsolver.warmstart_apply_sorted(tc, setup["tb"].vels, tsides)
    # a segment sum is a difference of two running prefix sums
    np.testing.assert_allclose(got.linear.numpy(), np.asarray(want.linear),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.angular.numpy(),
                               np.asarray(want.angular), rtol=RTOL,
                               atol=ATOL)


def _sweep_inputs(setup, seed=5):
    """Sorted-space inputs of one sweep in both packages. One empty class
    keeps a nonzero rung (the JAX ladder skips it under a cond, the port
    runs it masked) and the rungs past it stay pruned (w = 0)."""
    windows = list(setup["windows"])
    empty = windows.index(0)
    windows[empty] = 32
    assert 0 in windows[empty + 1:]
    windows = tuple(windows)
    cmax = max(windows)
    rng = np.random.default_rng(seed)
    c = setup["c"]
    t_rhs = rng.normal(scale=0.1, size=(c, 1, 2)).astype(np.float32)
    cfm = rng.uniform(0.8, 1.0, c).astype(np.float32)
    jss, jpf = jsolver.pad_solver_fields_packed(dataclasses.replace(
        setup["jc"], t_rhs=jnp.asarray(t_rhs), cfm_factor=jnp.asarray(cfm)),
        cmax)
    tss, tpf = tsolver.pad_solver_fields_packed(dataclasses.replace(
        setup["tj"], t_rhs=_t(t_rhs), cfm_factor=_t(cfm)), cmax)
    total = c + cmax
    n_s = rng.uniform(0, 0.2, (total, 1)).astype(np.float32)
    t_s = rng.normal(scale=0.05, size=(total, 1, 2)).astype(np.float32)
    off = [int(x) for x in setup["offsets"]]
    cnt = [int(x) for x in setup["counts"]]
    return SimpleNamespace(windows=windows, cmax=cmax, jss=jss, jpf=jpf,
                           tss=tss, tpf=tpf, n_s=n_s, t_s=t_s, off=off,
                           cnt=cnt, total=total)


def _chains(setup, x):
    dyn, n = setup["dyn"], setup["n"]
    ba, bb = x.tss.body_a.numpy(), x.tss.body_b.numpy()
    jchain = jsolver.build_gs_chain(
        jnp.asarray(ba), jnp.asarray(bb), jnp.asarray(dyn[ba]),
        jnp.asarray(dyn[bb]), jnp.asarray(x.off, jnp.int32),
        jnp.asarray(x.cnt, jnp.int32), x.windows, n)
    tchain = tsolver.build_gs_chain(_t(ba), _t(bb), _t(dyn[ba]),
                                    _t(dyn[bb]), x.off, x.cnt, x.windows, n)
    return jchain, tchain


@pytest.mark.parametrize("mode", ["ladder", "chained"])
def test_sweep_matches_jax(setup, mode):
    """One sweep with the rhs taken from the constraints: the ladder
    (gather by body, unique-index scatter-add) and the chained stream."""
    x = _sweep_inputs(setup)
    jchain, tchain = _chains(setup, x) if mode == "chained" else (None,
                                                                  None)
    layout = (jnp.zeros(x.total, jnp.int32), jnp.asarray(x.off, jnp.int32),
              jnp.asarray(x.cnt, jnp.int32))
    jv, jn, jt = jsolver.gs_color_major_pass(
        x.jss, setup["jb"].vels, jnp.asarray(x.n_s), jnp.asarray(x.t_s),
        layout, jnp.int32(len(x.windows)), cmax=x.cmax, dim=3,
        packed_fields=x.jpf, windows=x.windows, chain=jchain)
    tv, tn, tt = tsolver.gs_color_major_pass(
        x.tss, setup["tb"].vels, _t(x.n_s), _t(x.t_s), (x.off, x.cnt),
        x.windows, tchain, packed_fields=x.tpf)
    for got, want in ((tv.linear, jv.linear), (tv.angular, jv.angular),
                      (tn, jn), (tt, jt)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    assert float(np.abs(np.asarray(jn) - x.n_s).max()) > 1e-3  # it moved
    # rows outside every class keep their impulses bit for bit
    np.testing.assert_array_equal(tn.numpy()[-x.cmax:], x.n_s[-x.cmax:])


@pytest.mark.parametrize("seed", [0, 1])
def test_port_chained_sweep_matches_port_ladder(seed):
    """Within the port: the chained sweep equals the ladder pass up to one
    float re-association per update."""
    setup = _solver_setup(seed=seed)
    x = _sweep_inputs(setup, seed=seed + 7)
    _, tchain = _chains(setup, x)
    args = (x.tss, setup["tb"].vels, _t(x.n_s), _t(x.t_s), (x.off, x.cnt),
            x.windows)
    ref = tsolver.gs_color_major_pass(*args, None, packed_fields=x.tpf)
    out = tsolver.gs_color_major_pass(*args, tchain, packed_fields=x.tpf)
    for got, want, atol in ((out[0].linear, ref[0].linear, 1e-6),
                            (out[0].angular, ref[0].angular, 1e-6),
                            (out[1], ref[1], 1e-7), (out[2], ref[2], 1e-7)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=atol)
