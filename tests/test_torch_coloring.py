"""The port's colouring in the solve (``solver.color_constraints``), its
colour minimization (``solver.minimize_colors``) and the Jacobi solver's
body CSR (``solver.build_body_constraint_csr``) against the JAX package's,
exactly. Four seeded graphs of 300 bodies (five static) and 1,500 edges,
a tenth of them invalid: no class cap, too few colours (the legacy residue
on the last colour), a class cap, and a cap with too few colours (a
residue class 0). The JAX outputs are stored by
``scripts/export_solve_modes_npz.py`` in ``artifacts/solve_modes_jax.npz``
(group ``graph``); this file imports no JAX."""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.dynamics import solver
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "solve_modes_jax.npz")
CASES = ("free", "legacy", "capped", "residue")


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return {k: f[k] for k in f.files if k.startswith("graph.")}


def _graph(z, case):
    g = {k[len(f"graph.{case}."):]: v for k, v in z.items()
         if k.startswith(f"graph.{case}.")}
    t = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                             else v) for k, v in g.items()}
    cons = SimpleNamespace(body_a=t["body_a"], body_b=t["body_b"],
                           valid=t["valid"], im_a=t["im_a"], im_b=t["im_b"])
    return cons, g


def _dyn(cons):
    return (cons.im_a != 0).any(-1), (cons.im_b != 0).any(-1)


@pytest.mark.parametrize("case", CASES)
def test_color_constraints_match_jax(z, case):
    cons, g = _graph(z, case)
    mc, cap = int(g["max_colors"]), int(g["class_cap"])
    got = solver.color_constraints(cons, int(g["num_bodies"]),
                                   max_colors=mc, class_cap=cap).numpy()
    np.testing.assert_array_equal(got, g["colors"])
    one = solver.color_constraints(cons, int(g["num_bodies"]),
                                   max_colors=mc, claim_rounds=1,
                                   class_cap=cap).numpy()
    np.testing.assert_array_equal(one, g["colors_r1"])
    # the same colours as the broad phase's colouring of the same graph
    dyn_a, dyn_b = _dyn(cons)
    pairs = solver.color_pairs(cons.body_a, cons.body_b, cons.valid, dyn_a,
                               dyn_b, int(g["num_bodies"]), max_colors=mc,
                               class_cap=cap).numpy()
    np.testing.assert_array_equal(pairs, got)
    valid = g["valid"]
    if case == "legacy":  # too few colours: the rest on the last one
        assert ((got == mc) & valid).sum() > 0
    if case == "residue":  # under a cap the rest stay at 0, unswept
        assert ((got == 0) & valid).sum() > 0
    else:
        assert ((got == 0) & valid).sum() == 0


def _independent(colors, cons, classes):
    """Every class in ``classes`` holds each dynamic body at most once."""
    dyn_a, dyn_b = (x.numpy() for x in _dyn(cons))
    ba, bb, valid = (x.numpy() for x in (cons.body_a, cons.body_b,
                                         cons.valid))
    for k in classes:
        m = valid & (colors == k)
        ends = np.concatenate([ba[m & dyn_a], bb[m & dyn_b]])
        assert len(ends) == len(np.unique(ends)), k


@pytest.mark.parametrize("case", CASES)
def test_minimize_colors_match_jax(z, case):
    cons, g = _graph(z, case)
    mc, cap = int(g["max_colors"]), int(g["class_cap"])
    dyn_a, dyn_b = _dyn(cons)
    colors = torch.from_numpy(g["colors_r1"].astype(np.int64))
    got = solver.minimize_colors(cons.body_a, cons.body_b, cons.valid,
                                 colors, dyn_a, dyn_b, int(g["num_bodies"]),
                                 max_colors=mc, sweeps=2,
                                 class_cap=cap).numpy()
    np.testing.assert_array_equal(got, g["min_colors"])
    # edges moved, but where every class is full to the cap
    assert ((got != g["colors_r1"]).sum() > 0) == (case != "residue")
    # under a class cap (the only way the pipeline calls it) the moves
    # keep every class independent and within the cap; without one, the
    # legacy residue on the last colour is no independent set, and its
    # moves need not be either (in both packages)
    if cap:
        _independent(got, cons, range(1, mc + 1))
        sizes = np.bincount(got[g["valid"] & (got > 0)], minlength=mc + 1)
        before = np.bincount(
            g["colors_r1"][g["valid"] & (g["colors_r1"] > 0)],
            minlength=mc + 1)
        assert (sizes <= np.maximum(before, cap)).all()


@pytest.mark.parametrize("case", CASES)
def test_body_constraint_csr_matches_jax(z, case):
    cons, g = _graph(z, case)
    entries, offsets, counts = solver.build_body_constraint_csr(
        cons, int(g["num_bodies"]))
    np.testing.assert_array_equal(entries.numpy(), g["csr.entries"])
    np.testing.assert_array_equal(offsets.numpy(), g["csr.offsets"])
    np.testing.assert_array_equal(counts.numpy(), g["csr.counts"])
    # static bodies own no side
    assert counts.numpy()[:5].sum() == 0
