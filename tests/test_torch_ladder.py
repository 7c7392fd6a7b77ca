"""The port's ladder-path pieces against the JAX package on the same seeded
inputs: contact compaction (both branches, integers exact, overflow
count), the sorted-space rhs relinearization, the colour layout and the
one-gather field sort (exact), the sorted-sides warmstart, and one ladder
sweep and one plain chained sweep of ``gs_color_major_pass``.

The JAX package's results on these inputs, and its constraints of the
seeded setups, are read from ``artifacts/torch_ladder_jax.npz``, written
by ``scripts/export_port_tests_npz.py --only ladder`` from the same input
helpers as below (the JAX calls cost ~40 s on the CPU; no assertion or
tolerance changed when they moved there)."""

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_torch_solver import _port_bodies, _solver_inputs, _t
from wgmath_tpu_torch.dynamics import constraint as tcons
from wgmath_tpu_torch.dynamics import solver as tsolver
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import sim as tsim
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "torch_ladder_jax.npz")
# the GS impulse math's tolerance (the JAX package's, for the same math)
RTOL, ATOL = 1e-4, 1e-5
SEEDS = (4, 0, 1)  # the module's setup, then the chained-vs-ladder cases
COMPACT_CASES = [(b, c) for c in (256, 100)
                 for b in ("cumsum", "cumsum_extra", "sorted")]
_CONSTRAINT_FIELDS = [f.name for f in
                      dataclasses.fields(tcons.ContactConstraints)]


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return dict(f)


def _setup_from(z, seed):
    """The port's half of ``_solver_setup(seed)``: the seeded inputs and
    bodies, and the JAX package's constraints of them as ``tj``."""
    x = _solver_inputs(seed=seed)
    jc = {f: z[f"setup.{seed}.jc.{f}"] for f in _CONSTRAINT_FIELDS}
    tj = tcons.ContactConstraints(**{f: _t(v) for f, v in jc.items()})
    return dict(x, tb=_port_bodies(x), tj=tj, jc=jc)


@pytest.fixture(scope="module")
def setup(z):
    return _setup_from(z, 4)


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


def compact_kw(branch, colors):
    return {"cumsum": {}, "cumsum_extra": dict(extra=colors),
            "sorted": dict(extra=colors, sort_by_extra=True)}[branch]


@pytest.mark.parametrize("capacity", [256, 100], ids=["fits", "overflows"])
@pytest.mark.parametrize("branch", ["cumsum", "cumsum_extra", "sorted"])
def test_compact_contacts_matches_jax(z, branch, capacity):
    """Every field of the compacted buffer, the carried colours and the
    true count come out as in the JAX package — bit for bit, since
    compaction only moves rows. A count above the capacity is the overflow
    signal."""
    contact, colors = _contacts(7)
    kw = compact_kw(branch, colors)
    pre = f"compact.{branch}.{capacity}"
    got = tcons.compact_contacts(
        tcons.Contacts(**{k: _t(v) for k, v in contact.items()}), capacity,
        **{k: _t(v) if k == "extra" else v for k, v in kw.items()})
    n_want = 2 if branch == "cumsum" else 3
    assert len(got) == n_want == int(z[f"{pre}.len"])
    n_valid = int(contact["valid"].sum())
    assert int(got[1]) == int(z[f"{pre}.count"]) == n_valid
    assert (n_valid > capacity) == (capacity == 100)
    for f in dataclasses.fields(tcons.Contacts):
        np.testing.assert_array_equal(getattr(got[0], f.name).numpy(),
                                      z[f"{pre}.{f.name}"], err_msg=f.name)
    if branch != "cumsum":
        np.testing.assert_array_equal(got[2].numpy(), z[f"{pre}.extra"])
    if branch == "sorted":
        live = got[2].numpy()[:min(n_valid, capacity)]
        assert (np.diff(live) >= 0).all()  # colour-major


def moved_poses(q, tr, seed=12):
    """The setup's poses after a small substep-sized motion (numpy)."""
    rng = np.random.default_rng(seed)
    n = q.shape[0]
    q = q + rng.normal(scale=1e-3, size=(n, 4))
    q = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    tr = (tr + rng.normal(scale=2e-3, size=(n, 3))).astype(np.float32)
    return q, tr


def test_update_rhs_sorted_matches_jax(z, setup):
    q, tr = moved_poses(setup["q"], setup["tr"])
    tposes = tsim.Sim(_t(q), _t(tr), torch.ones(setup["n"]))
    got = tcons.update_rhs_sorted(setup["tj"], tposes, SimParams().substep())
    want = [z[f"update_rhs.{i}"] for i in range(int(z["update_rhs.len"]))]
    assert len(got) == len(want)
    # the drift is the difference of two ~3 m world points (one ulp is
    # 2.4e-7) times inv_dt = 240, and XLA on the CPU fuses a*b+c into one
    # rounding where PyTorch rounds the product: atol 2e-4
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=2e-4)
    assert float(np.abs(want[0] - setup["jc"]["n_rhs"]).max()) > 1e-2


def test_remove_cfm_and_bias_matches_jax(z, setup):
    got = tcons.remove_cfm_and_bias(setup["tj"])
    for f in ("n_rhs", "t_rhs", "cfm_factor", "n_rhs_wo_bias"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      z[f"remove_cfm.{f}"], f)
    assert float(got.cfm_factor.min()) == 1.0


def shuffle(x, seed=21):
    """A permutation of the setup's constraints out of colour order, and
    their colours."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(x["c"])
    colors = np.repeat(np.arange(x["max_colors"] + 2), x["counts"])[perm]
    return perm, colors.astype(np.int32)


def _meta(z, key):
    return {k: (a, tuple(t)) for k, (a, t) in json.loads(str(z[key])).items()}


def test_color_layout_and_field_sort_match_jax(z, setup):
    """``build_color_layout`` (order, offsets, counts) and the one-gather
    sort of every solver field: integers and the gathered matrix exact."""
    perm, colors = shuffle(setup)
    tc = dataclasses.replace(setup["tj"], **{
        f: getattr(setup["tj"], f)[_t(perm)] for f in _CONSTRAINT_FIELDS})
    mc, cmax = setup["max_colors"], max(setup["windows"])
    got = tsolver.build_color_layout(_t(colors), tc.valid, max_colors=mc,
                                     cmax=cmax)
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g.numpy(), z[f"layout.{i}"])
    tss, (tpf, tmeta) = tsolver.sort_solver_fields_packed(tc, got[0])
    assert _meta(z, "sorted.meta_json") == tmeta
    np.testing.assert_array_equal(tpf.numpy(), z["sorted.pf"])
    fields = json.loads(str(z["sorted.fields_json"]))
    assert set(vars(tss)) == set(fields)
    for f in fields:
        np.testing.assert_array_equal(getattr(tss, f).numpy(),
                                      z[f"sorted.{f}"], f)
    assert not tss.valid[-cmax:].any() and not tss.num_points[-cmax:].any()


def test_pack_sorted_fields_matches_jax(z, setup):
    tpf, tmeta = tsolver.pack_sorted_fields(setup["tj"])
    assert _meta(z, "pack.meta_json") == tmeta
    np.testing.assert_array_equal(tpf.numpy(), z["pack.pf"])


def warm_impulses(x, seed=31):
    rng = np.random.default_rng(seed)
    c = x["c"]
    imp_n = rng.uniform(0, 1, (c, 1)).astype(np.float32)
    imp_t = rng.normal(size=(c, 1, 2)).astype(np.float32)
    return imp_n, imp_t


def test_sorted_sides_warmstart_matches_jax(z, setup):
    imp_n, imp_t = warm_impulses(setup)
    tc = dataclasses.replace(setup["tj"], n_impulse=_t(imp_n),
                             t_impulse=_t(imp_t))
    tsides = tsolver.build_sorted_sides(tc, setup["n"])
    for i, g in enumerate(tsides):
        np.testing.assert_array_equal(g.numpy(), z[f"sides.{i}"])
    got = tsolver.warmstart_apply_sorted(tc, setup["tb"].vels, tsides)
    # a segment sum is a difference of two running prefix sums
    np.testing.assert_allclose(got.linear.numpy(), z["warm.linear"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.angular.numpy(), z["warm.angular"],
                               rtol=RTOL, atol=ATOL)


def sweep_arrays(x, seed=5):
    """The numpy half of one sweep's inputs. One empty class keeps a
    nonzero rung (the JAX ladder skips it under a cond, the port runs it
    masked) and the rungs past it stay pruned (w = 0)."""
    windows = list(x["windows"])
    empty = windows.index(0)
    windows[empty] = 32
    assert 0 in windows[empty + 1:]
    windows = tuple(windows)
    cmax = max(windows)
    rng = np.random.default_rng(seed)
    c = x["c"]
    t_rhs = rng.normal(scale=0.1, size=(c, 1, 2)).astype(np.float32)
    cfm = rng.uniform(0.8, 1.0, c).astype(np.float32)
    total = c + cmax
    n_s = rng.uniform(0, 0.2, (total, 1)).astype(np.float32)
    t_s = rng.normal(scale=0.05, size=(total, 1, 2)).astype(np.float32)
    return SimpleNamespace(
        windows=windows, cmax=cmax, t_rhs=t_rhs, cfm=cfm, n_s=n_s, t_s=t_s,
        off=[int(v) for v in x["offsets"]], cnt=[int(v) for v in x["counts"]],
        total=total)


def _sweep_inputs(setup, seed=5):
    """The port's sorted-space inputs of one sweep."""
    x = sweep_arrays(setup, seed)
    x.tss, x.tpf = tsolver.pad_solver_fields_packed(dataclasses.replace(
        setup["tj"], t_rhs=_t(x.t_rhs), cfm_factor=_t(x.cfm)), x.cmax)
    return x


def _chain(setup, x):
    dyn, n = setup["dyn"], setup["n"]
    ba, bb = x.tss.body_a.numpy(), x.tss.body_b.numpy()
    return tsolver.build_gs_chain(_t(ba), _t(bb), _t(dyn[ba]), _t(dyn[bb]),
                                  x.off, x.cnt, x.windows, n)


@pytest.mark.parametrize("mode", ["ladder", "chained"])
def test_sweep_matches_jax(z, setup, mode):
    """One sweep with the rhs taken from the constraints: the ladder
    (gather by body, unique-index scatter-add) and the chained stream."""
    x = _sweep_inputs(setup)
    tchain = _chain(setup, x) if mode == "chained" else None
    tv, tn, tt = tsolver.gs_color_major_pass(
        x.tss, setup["tb"].vels, _t(x.n_s), _t(x.t_s), (x.off, x.cnt),
        x.windows, tchain, packed_fields=x.tpf)
    for got, key in ((tv.linear, "linear"), (tv.angular, "angular"),
                     (tn, "n"), (tt, "t")):
        want = z[f"sweep.{mode}.{key}"]
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert float(np.abs(z[f"sweep.{mode}.n"] - x.n_s).max()) > 1e-3  # moved
    # rows outside every class keep their impulses bit for bit
    np.testing.assert_array_equal(tn.numpy()[-x.cmax:], x.n_s[-x.cmax:])


@pytest.mark.parametrize("seed", [0, 1])
def test_port_chained_sweep_matches_port_ladder(z, seed):
    """Within the port: the chained sweep equals the ladder pass up to one
    float re-association per update."""
    setup = _setup_from(z, seed)
    x = _sweep_inputs(setup, seed=seed + 7)
    tchain = _chain(setup, x)
    args = (x.tss, setup["tb"].vels, _t(x.n_s), _t(x.t_s), (x.off, x.cnt),
            x.windows)
    ref = tsolver.gs_color_major_pass(*args, None, packed_fields=x.tpf)
    out = tsolver.gs_color_major_pass(*args, tchain, packed_fields=x.tpf)
    for got, want, atol in ((out[0].linear, ref[0].linear, 1e-6),
                            (out[0].angular, ref[0].angular, 1e-6),
                            (out[1], ref[1], 1e-7), (out[2], ref[2], 1e-7)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=atol)
