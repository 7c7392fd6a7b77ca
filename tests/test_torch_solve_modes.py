"""The port's sweeps without a window ladder (uniform and split windows,
``gs_color_major_pass`` through the plan of ``solver.uniform_windows`` and
the plain sweep ``solver._sweep_torch``), its Jacobi pass and its
``update_constraints`` against the JAX package's. The input is the
160-ball pit warmed by the JAX package under the README's quick-start
layout (``bp_slack`` 0, ``gs_cmax`` 0, no windows); its constraints are
relinearized, coloured (16 colours, class cap 48) and swept once by both
packages: uniformly (window 48) and split (colours 1-3 at 48, the rest at
8, which truncates the larger tail classes). The JAX outputs are stored
by ``scripts/export_solve_modes_npz.py`` in
``artifacts/solve_modes_jax.npz`` (groups ``pit.quick`` and ``unit``);
this file imports no JAX.

Integers are exact. Velocities are held at atol 5e-5 and impulses at
rtol 1e-3 / atol 1e-4: XLA on the CPU fuses ``a*b+c`` into one rounding
where PyTorch rounds the product, and the rhs (an anchor drift times 1/dt
= 240) carries one ulp of a world point into ~1e-5 m/s."""

import os

import numpy as np
import pytest
import torch

from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.dynamics import solver
from wgmath_tpu_torch.dynamics.constraint import update_constraints
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "solve_modes_jax.npz")
COLORS, CAP, SPLIT, TAIL = 16, 48, 3, 8  # the export's unit sweeps
V_ATOL = 5e-5


@pytest.fixture(scope="module")
def z():
    with np.load(NPZ) as f:
        return {k: f[k] for k in f.files
                if k.startswith(("unit.", "pit.quick.warmed."))}


@pytest.fixture(scope="module")
def setup(z):
    """The relinearized constraints, their colours, layout and sorted
    fields, built by the port from the warmed state."""
    p = "pit.quick.warmed."
    state = state_from_arrays({k[len(p):]: v for k, v in z.items()
                               if k.startswith(p)}, device="cpu")
    n = state.bodies.num_bodies
    sub = SimParams().substep().with_dim(3)
    cons = update_constraints(state.prev_constraints, state.bodies.poses,
                              sub)
    colors = solver.color_constraints(cons, n, max_colors=COLORS,
                                      class_cap=CAP)
    c_cap = cons.body_a.shape[0]
    cmax = min(c_cap, n + 64, CAP)
    layout = solver.build_color_layout(colors, cons.valid,
                                       max_colors=COLORS, cmax=cmax)
    ss, packed = solver.sort_solver_fields_packed(cons, layout[0])
    idx = torch.clamp(layout[0], max=c_cap - 1)
    return dict(state=state, cons=cons, colors=colors, cmax=cmax,
                layout=layout, ss=ss, packed=packed,
                n_imp_s=cons.n_impulse[idx], t_imp_s=cons.t_impulse[idx],
                host=(layout[1].tolist(), layout[2].tolist()))


def _close(got, want, atol, rtol=1e-4):
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)


def test_update_constraints_matches_jax(z, setup):
    cons = setup["cons"]
    for f in ("n_impulse", "t_impulse", "n_impulse_jacobi",
              "t_impulse_jacobi", "cfm_factor"):
        np.testing.assert_array_equal(getattr(cons, f).numpy(),
                                      z[f"unit.update.{f}"], f)
    for f in ("n_rhs", "n_rhs_wo_bias", "t_rhs"):
        _close(getattr(cons, f), z[f"unit.update.{f}"], V_ATOL)


def test_layout_matches_jax(z, setup):
    np.testing.assert_array_equal(setup["colors"].numpy(), z["unit.colors"])
    assert setup["cmax"] == int(z["unit.cmax"])
    for k, v in zip(("order_padded", "offsets", "counts"), setup["layout"]):
        np.testing.assert_array_equal(v.numpy(), z[f"unit.layout.{k}"], k)


def _windows(setup, name):
    kw = dict(tail_window=TAIL, split=SPLIT) if name == "split" else {}
    return solver.uniform_windows(setup["host"][1], max_colors=COLORS,
                                  cmax=setup["cmax"], **kw)


def _sweep(setup, windows, plan=None):
    return solver.gs_color_major_pass(
        setup["ss"], setup["state"].bodies.vels, setup["n_imp_s"],
        setup["t_imp_s"], setup["host"], windows, None,
        packed_fields=setup["packed"], sweep_plan=plan)


@pytest.mark.parametrize("name", ["uniform", "split"])
def test_windowless_sweep_matches_jax(z, setup, name):
    vels, n_imp, t_imp = _sweep(setup, _windows(setup, name))
    _close(vels.linear, z[f"unit.{name}.linear"], V_ATOL)
    _close(vels.angular, z[f"unit.{name}.angular"], V_ATOL)
    _close(n_imp, z[f"unit.{name}.n_imp_s"], 1e-4, 1e-3)
    _close(t_imp, z[f"unit.{name}.t_imp_s"], 1e-4, 1e-3)


@pytest.mark.parametrize("name", ["uniform", "split"])
def test_windowless_plan_is_one_rung_a_colour(setup, name):
    """One rung per occupied colour at its class offset (never moved by the
    clamp), ``min(count, window)`` rows each, the sides sized by those rows;
    the split's tail rungs truncated at the tail window. The same sweep
    through a plan of full ``cmax`` windows (its rows past the class masked
    out) gives the same bits."""
    windows = _windows(setup, name)
    offsets, counts = setup["host"]
    plan = solver.build_sweep_plan(setup["ss"], setup["host"], windows,
                                   setup["state"].bodies.num_bodies, None,
                                   p_max=1)
    occupied = [c for c in range(1, COLORS + 1) if counts[c] > 0]
    assert [r.colour for r in plan.rungs] == occupied
    full_w = tuple(TAIL if name == "split" and c > SPLIT else setup["cmax"]
                   for c in range(1, COLORS + 1))
    truncated = 0
    for r in plan.rungs:
        w = full_w[r.colour - 1]
        assert r.start == offsets[r.colour]
        assert r.rows == r.window == min(counts[r.colour], w)
        truncated += counts[r.colour] > w
    assert plan.sides.shape[0] == 2 * sum(r.rows for r in plan.rungs)
    assert truncated > 0 if name == "split" else truncated == 0
    full = solver.build_sweep_plan(
        setup["ss"], setup["host"],
        tuple(w if counts[c] else 0 for c, w in enumerate(full_w, 1)),
        setup["state"].bodies.num_bodies, None, p_max=1)
    assert full.sides.shape[0] > plan.sides.shape[0]
    (v, n_imp, t_imp), (fv, fn, ft) = (_sweep(setup, windows, plan),
                                        _sweep(setup, windows, full))
    for got, want in ((v.linear, fv.linear), (v.angular, fv.angular),
                      (n_imp, fn), (t_imp, ft)):
        assert torch.equal(got, want)


def test_jacobi_pass_matches_jax(z, setup):
    cons, state = setup["cons"], setup["state"]
    csr = solver.build_body_constraint_csr(cons, state.bodies.num_bodies)
    vels, out = solver.jacobi_pass(cons, state.bodies.vels, csr,
                                   max_per_body=32)
    _close(vels.linear, z["unit.jacobi.linear"], V_ATOL)
    _close(vels.angular, z["unit.jacobi.angular"], V_ATOL)
    for f in ("n_impulse", "n_impulse_jacobi", "t_impulse",
              "t_impulse_jacobi"):
        _close(getattr(out, f), z[f"unit.jacobi.{f}"], 1e-4, 1e-3)
    # a loop cut at the busiest body's side count gives the same bits
    rounds = int(csr[2].max())
    assert rounds < 32
    short = solver.jacobi_pass(cons, state.bodies.vels, csr,
                               max_per_body=rounds)
    assert torch.equal(short[0].linear, vels.linear)
    assert torch.equal(short[1].n_impulse, out.n_impulse)
