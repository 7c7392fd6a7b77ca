"""The port's small-matrix geometry (``geometry/decomp.py``, ``inv.py``,
``utils.py``) against the JAX package's on the same seeded inputs, the
JAX package's own residual checks on the port's outputs, and the port's
surface against the JAX package's: the registered kernel modules, the
pipeline configuration, the geometry package's names and the examples.

Tolerances: values within rtol 1e-5 / atol 1e-6 of JAX's (LU's ``perm``
exactly), but where a step amplifies one rounding: eigenvectors rtol 1e-4
/ atol 1e-5, and the SVD at atol 1e-4 (its singular values are square
roots of the eigenvalues of AᵀA, so one ulp of the largest σ² is ~1e-5
at σ ~ 0.03). Eigenvectors and the SVD's bases are held column by column
up to a sign, the sign taken from the larger component. The JAX side runs
eagerly, as ``tests/test_geometry.py`` runs it."""

import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wgmath_tpu.geometry as jgeo
from wgmath_tpu.geometry import decomp as jdecomp
from wgmath_tpu.geometry import utils as jutils
from wgmath_tpu.pipeline import PipelineConfig as JConfig
import wgmath_tpu_torch.geometry as tgeo
from wgmath_tpu_torch.core.module import compile_check
from wgmath_tpu_torch.geometry import decomp as tdecomp
from wgmath_tpu_torch.geometry import utils as tutils
from wgmath_tpu_torch.pipeline import PipelineConfig as TConfig
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 256  # matrices a case
RTOL, ATOL = 1e-5, 1e-6
# the JAX package's kernel modules and the Python modules that register
# them, in both packages
MODULES = ("ops.gemv", "ops.reduce", "ops.gemm", "ops.elementwise",
           "dynamics.body", "broad_phase.grid", "geometry.inv",
           "geometry.sim", "geometry.rot2", "geometry.decomp",
           "geometry.quat", "geometry.utils", "utils.scan_sort",
           "queries.ray", "queries.projection")
EXAMPLES = ("compose", "hot_reload", "overwrite", "profiling", "readback")
# the package re-exports ``inv`` the function over ``inv`` the module
tinv = importlib.import_module("wgmath_tpu_torch.geometry.inv")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _signed_columns(x):
    """Each column (last axis but one is the row) turned so that its
    largest-magnitude component is positive."""
    x = _np(x)
    idx = np.argmax(np.abs(x), axis=-2)[..., None, :]
    return x * np.sign(np.take_along_axis(x, idx, axis=-2))


def _general(n, seed=0):
    """Well-conditioned general matrices (``test_geometry``'s LU inputs)."""
    rng = np.random.default_rng(seed + n)
    return (rng.normal(size=(B, n, n)).astype(np.float32)
            + np.eye(n, dtype=np.float32))


def _spd(n, seed=0):
    rng = np.random.default_rng(seed + 10 * n)
    b = rng.normal(size=(B, n, n)).astype(np.float32)
    return np.einsum("nki,nkj->nij", b, b) + np.eye(n, dtype=np.float32) * 0.5


def _sym(n, seed=0):
    rng = np.random.default_rng(seed + 20 * n)
    b = rng.normal(size=(B, n, n)).astype(np.float32)
    return (b + np.swapaxes(b, -1, -2)) / 2


def _rhs(n, seed=0):
    return np.random.default_rng(seed + 30 * n).normal(
        size=(B, n)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --- against the JAX package -------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_lu_matches_jax(n):
    a, b = _general(n), _rhs(n)
    jp, jperm = jdecomp.lu(jnp.asarray(a))
    tp, tperm = tdecomp.lu(_t(a))
    assert tperm.dtype == torch.int32
    np.testing.assert_array_equal(_np(tperm), _np(jperm))
    _close(tp, jp)
    for got, want in zip(tdecomp.lu_unpack(tp), jdecomp.lu_unpack(jp)):
        _close(got, want)
    _close(tdecomp.lu_solve(tp, tperm, _t(b)),
           jdecomp.lu_solve(jp, jperm, jnp.asarray(b)), rtol=1e-5,
           atol=1e-5)


def test_lu_pivots_on_the_first_largest_row():
    """Equal magnitudes pivot on the first row, as ``jnp.argmax``."""
    a = np.array([[[1.0, 2.0, 0.0], [-1.0, 0.5, 1.0], [1.0, 1.0, 3.0]],
                  [[0.0, 1.0, 2.0], [2.0, 0.0, 1.0], [-2.0, 3.0, 0.0]]],
                 np.float32)
    jp, jperm = jdecomp.lu(jnp.asarray(a))
    tp, tperm = tdecomp.lu(_t(a))
    np.testing.assert_array_equal(_np(tperm), _np(jperm))
    np.testing.assert_array_equal(_np(tperm)[:, 0], [0, 1])
    _close(tp, jp)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_qr_matches_jax(n):
    a = _general(n, seed=1) - np.eye(n, dtype=np.float32)
    for got, want in zip(tdecomp.qr(_t(a)), jdecomp.qr(jnp.asarray(a))):
        _close(got, want)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_cholesky_matches_jax(n):
    a, b = _spd(n), _rhs(n, seed=1)
    jl, tl = jdecomp.cholesky(jnp.asarray(a)), tdecomp.cholesky(_t(a))
    _close(tl, jl)
    _close(tdecomp.cholesky_solve(tl, _t(b)),
           jdecomp.cholesky_solve(jl, jnp.asarray(b)))
    # the 1e-30 clamp of a non-positive pivot
    z = np.zeros((2, n, n), np.float32)
    z[1] = -np.eye(n)
    _close(tdecomp.cholesky(_t(z)), jdecomp.cholesky(jnp.asarray(z)), atol=0)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_symmetric_eigen_matches_jax(n):
    a = _sym(n)
    jw, jv = jdecomp.symmetric_eigen(jnp.asarray(a))
    tw, tv = tdecomp.symmetric_eigen(_t(a))
    _close(tw, jw)
    # eigenvectors: columns up to a sign, at the values' tolerance scaled
    # by the largest eigenvalue gap's conditioning (atol 1e-5)
    _close(_signed_columns(tv), _signed_columns(jv), rtol=1e-4, atol=1e-5)


def test_symmetric_eigen_sorts_stably():
    """Equal eigenvalues keep their diagonal order (``jnp.argsort`` is
    stable; the port sorts with ``stable=True``)."""
    a = np.stack([np.diag([2.0, 1.0, 2.0, 1.0]),
                  np.diag([3.0, 3.0, 3.0, 0.0])]).astype(np.float32)
    jw, jv = jdecomp.symmetric_eigen(jnp.asarray(a))
    tw, tv = tdecomp.symmetric_eigen(_t(a))
    np.testing.assert_array_equal(_np(tw), _np(jw))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    np.testing.assert_array_equal(_np(tv)[0], np.eye(4)[:, [1, 3, 0, 2]])


@pytest.mark.parametrize("n", [2, 3])
def test_svd_matches_jax(n):
    rng = np.random.default_rng(40 + n)
    a = rng.normal(size=(B, n, n)).astype(np.float32)
    ju, js, jvt = jdecomp.svd(jnp.asarray(a))
    tu, ts, tvt = tdecomp.svd(_t(a))
    _close(ts, js, atol=1e-4)
    _close(_signed_columns(tu), _signed_columns(ju), rtol=1e-4, atol=1e-4)
    _close(_signed_columns(torch.transpose(tvt, -1, -2)),
           _signed_columns(np.swapaxes(_np(jvt), -1, -2)), rtol=1e-4,
           atol=1e-4)


@pytest.mark.parametrize("n", [2, 3])
def test_svd_degenerate_matches_jax(n):
    """Rank-1, rank-deficient and zero matrices (the re-orthonormalisation
    and the identity guard)."""
    col = np.arange(1, n + 1, dtype=np.float32)
    a = np.stack([np.outer(col, col), np.zeros((n, n), np.float32),
                  np.diag(np.r_[1.0, np.zeros(n - 1)]).astype(np.float32)])
    ju, js, jvt = jdecomp.svd(jnp.asarray(a))
    tu, ts, tvt = tdecomp.svd(_t(a))
    _close(ts, js, atol=1e-5)
    _close(tu, ju, rtol=1e-4, atol=1e-4)
    _close(tvt, jvt, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_np(tu)[1], np.eye(n))


def test_svd_refuses_other_sizes():
    with pytest.raises(ValueError, match="svd"):
        tdecomp.svd(torch.eye(4)[None])


def test_any_orthonormal_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    x[:4] = np.eye(3, dtype=np.float32)[[0, 1, 2, 0]] * [[1], [1], [1], [-1]]
    _close(tdecomp._any_orthonormal(_t(x)),
           jdecomp._any_orthonormal(jnp.asarray(x)))


@pytest.mark.parametrize("n", [2, 3, 4])
def test_inverses_match_jax(n):
    a = _general(n, seed=2) + np.eye(n, dtype=np.float32) * (n - 1)
    for name in (f"inv{n}", f"det{n}", "inv"):
        _close(getattr(tinv, name)(_t(a)), getattr(jgeo, name)(
            jnp.asarray(a)), msg=name)


def test_inv_refuses_non_square():
    with pytest.raises(ValueError, match="square"):
        tinv.inv(torch.zeros((2, 3, 2)))


def test_utils_match_jax():
    rng = np.random.default_rng(6)
    y = rng.normal(size=B).astype(np.float32)
    x = rng.normal(size=B).astype(np.float32)
    # (0, 0) and a zero over a negative x
    y[:2], x[:2] = [0.0, -0.0], [0.0, -1.0]
    _close(tutils.stable_atan2(_t(y), _t(x)),
           jutils.stable_atan2(jnp.asarray(y), jnp.asarray(x)))
    # the pole guard: every |x|, |y| < 1e-38 gives 0. (XLA on the CPU
    # flushes subnormals, the 1e-38 bound among them, so there the JAX
    # package's guard never fires and atan2(0, -0) is pi: the JAX side is
    # not asked at the pole)
    py = torch.tensor([0.0, -0.0, 0.0, -0.0, 1e-39, -5e-39])
    px = torch.tensor([0.0, 0.0, -0.0, -0.0, -1e-39, 0.0])
    np.testing.assert_array_equal(_np(tutils.stable_atan2(py, px)), 0.0)
    u = np.concatenate([rng.uniform(-0.999, 0.999, B - 4),
                        [1.0, -1.0, 2.0, -3.0]]).astype(np.float32)
    _close(tutils.stable_atanh(_t(u)), jutils.stable_atanh(jnp.asarray(u)))
    assert torch.isfinite(tutils.stable_atanh(_t(u))).all()
    v = rng.normal(size=(B, 3)).astype(np.float32)
    w = rng.normal(size=(B, 3)).astype(np.float32)
    for name in ("vec_min", "vec_max"):
        np.testing.assert_array_equal(
            _np(getattr(tutils, name)(_t(v), _t(w))),
            _np(getattr(jutils, name)(jnp.asarray(v), jnp.asarray(w))))
    for name in ("component_min", "component_max"):
        np.testing.assert_array_equal(
            _np(getattr(tutils, name)(_t(v))),
            _np(getattr(jutils, name)(jnp.asarray(v))))


# --- tests/test_geometry.py's residual checks on the port's outputs ---------


@pytest.mark.parametrize("n", [2, 3, 4])
def test_residuals(n):
    rng = np.random.default_rng(7 + n)
    a = rng.normal(size=(B, n, n)).astype(np.float32) + np.eye(
        n, dtype=np.float32)
    b = rng.normal(size=(B, n)).astype(np.float32)
    packed, perm = tdecomp.lu(_t(a))
    l, u = (_np(x) for x in tdecomp.lu_unpack(packed))
    pa = np.take_along_axis(a, _np(perm)[..., None].astype(np.int64),
                            axis=-2)
    _close(l @ u, pa, rtol=1e-2, atol=1e-3)
    x = _np(tdecomp.lu_solve(packed, perm, _t(b)))
    _close(np.einsum("nij,nj->ni", a, x), b, rtol=1e-2, atol=1e-2)
    # QR
    g = rng.normal(size=(B, n, n)).astype(np.float32)
    q, r = (_np(x) for x in tdecomp.qr(_t(g)))
    _close(q @ r, g, rtol=1e-2, atol=1e-3)
    _close(np.einsum("nij,nik->njk", q, q),
           np.broadcast_to(np.eye(n), (B, n, n)), rtol=1e-3, atol=1e-3)
    for i in range(1, n):
        assert np.max(np.abs(r[:, i, :i])) < 1e-3
    # Cholesky
    spd = np.einsum("nki,nkj->nij", g, g) + np.eye(n, dtype=np.float32) * 0.5
    lc = tdecomp.cholesky(_t(spd))
    _close(np.einsum("nik,njk->nij", _np(lc), _np(lc)), spd, rtol=1e-2,
           atol=1e-3)
    xc = _np(tdecomp.cholesky_solve(lc, _t(b)))
    _close(np.einsum("nij,nj->ni", spd, xc), b, rtol=1e-2, atol=1e-2)
    # symmetric eigen
    sym = (g + np.swapaxes(g, -1, -2)) / 2
    w, v = (_np(x) for x in tdecomp.symmetric_eigen(_t(sym)))
    _close(np.einsum("nik,nk,njk->nij", v, w, v), sym, rtol=1e-2, atol=1e-3)
    _close(w, np.linalg.eigvalsh(sym), rtol=1e-3, atol=1e-3)
    # inverses and determinants
    ai = g + np.eye(n, dtype=np.float32) * n
    _close(tinv.inv(_t(ai)), np.linalg.inv(ai), rtol=5e-3, atol=1e-3)
    _close(getattr(tinv, f"det{n}")(_t(ai)), np.linalg.det(ai), rtol=5e-3,
           atol=1e-3)
    if n == 4:
        return
    # SVD
    us, s, vt = (_np(x) for x in tdecomp.svd(_t(g)))
    _close(us @ (s[..., None] * vt), g, rtol=1e-2, atol=1e-3)
    _close(np.einsum("nij,nik->njk", us, us),
           np.broadcast_to(np.eye(n), (B, n, n)), rtol=1e-3, atol=2e-3)
    _close(s, np.linalg.svd(g, compute_uv=False), rtol=1e-3, atol=1e-3)
    assert np.all(np.diff(s, axis=-1) <= 1e-5)


def test_svd_degenerate_residuals():
    """``test_geometry.test_svd_degenerate``'s rank-1 and zero matrices."""
    col = np.array([1.0, 2.0, 3.0], np.float32)
    a = np.stack([np.outer(col, col), np.zeros((3, 3), np.float32)])
    u, s, vt = (_np(x) for x in tdecomp.svd(_t(a)))
    _close(u @ (s[..., None] * vt), a, rtol=1e-2, atol=1e-3)
    _close(np.einsum("nij,nik->njk", u, u),
           np.broadcast_to(np.eye(3), (2, 3, 3)), rtol=1e-3, atol=2e-3)


@pytest.mark.parametrize("mod", ["geometry.inv", "geometry.decomp",
                                 "dynamics.body"])
def test_entry_points_run_on_the_cpu(mod):
    want = {"geometry.inv": ["inv2", "inv3", "inv4"],
            "dynamics.body": ["update_mprops", "integrate"],
            "geometry.decomp": [f"{k}{n}" for k in ("lu", "qr", "cholesky",
                                                     "eig")
                                for n in (2, 3, 4)] + ["svd2", "svd3"]}[mod]
    assert compile_check(mod, device="cpu") == want


# --- the surface ---------------------------------------------------------------


def _registries():
    from wgmath_tpu.core import module as jmod
    from wgmath_tpu_torch.core import module as tmod
    for m in MODULES:
        importlib.import_module("wgmath_tpu." + m)
        importlib.import_module("wgmath_tpu_torch." + m)
    return jmod.all_modules(), tmod.all_modules()


def test_registries_match():
    """The same 15 kernel modules with the same deps, provides and entry
    points in both packages (the library twin of the GEMM is provided as
    ``gemm_torch`` for ``gemm_xla``, as ``test_torch_core`` holds)."""
    jm, tm = _registries()
    assert len(jm) == 15
    assert sorted(jm) == sorted(tm)
    rename = {"gemm_xla": "gemm_torch"}
    for name in jm:
        j, t = jm[name], tm[name]
        assert j.deps == t.deps, name
        assert list(t.provides) == [rename.get(k, k) for k in j.provides]
        assert list(j.entries) == list(t.entries), name


def test_grid_names_an_unregistered_dependency_in_both():
    """``broad_phase.grid`` depends on ``broad_phase.brute_force``, which
    neither package registers: resolving its dependencies raises
    ``KeyError`` in both."""
    from wgmath_tpu.core import module as jmod
    from wgmath_tpu_torch.core import module as tmod
    _registries()
    for mod in (jmod, tmod):
        assert mod.get_module("broad_phase.grid").deps == (
            "broad_phase.brute_force",)
        with pytest.raises(KeyError, match="brute_force"):
            mod.dependency_order("broad_phase.grid")


def test_pipeline_config_matches():
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert tf == jf


def test_geometry_exports_match():
    names = [k for k in vars(jgeo) if not k.startswith("_")
             and k not in ("annotations",)]
    for k in names:
        assert hasattr(tgeo, k), k
    assert {"lu", "svd", "inv4", "det4", "stable_atan2", "Sim"} <= set(names)


@pytest.fixture(scope="module")
def example_runs():
    """Every example run with ``--device cpu`` in one fresh process (one
    PyTorch import for the five), as ``__main__``: name -> the error it
    raised, or "" where it ran to its end. The process loads no JAX."""
    code = ("import json, runpy, sys, traceback\n"
            "out = {}\n"
            f"for name in {list(EXAMPLES)!r}:\n"
            f"    path = {ROOT!r} + f'/examples/torch_core_{{name}}.py'\n"
            "    sys.argv = [path, '--device', 'cpu']\n"
            "    try:\n"
            "        runpy.run_path(path, run_name='__main__')\n"
            "        out[name] = ''\n"
            "    except BaseException:\n"
            "        out[name] = traceback.format_exc()\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', "
            "'wgmath_tpu'))\n"
            "out['jax modules'] = ' '.join(bad)\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr
    return json.loads(got.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(example_runs, name):
    """Each example runs to its end with ``--device cpu``, and none loads
    JAX or the JAX package."""
    assert example_runs[name] == "", example_runs[name]
    assert example_runs["jax modules"] == ""
