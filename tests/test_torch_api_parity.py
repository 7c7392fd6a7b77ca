"""The port's public surface against the JAX package's.

Name parity: the public names of every module of ``wgmath_tpu`` (read from
its source with ``ast``, so no JAX program is traced or compiled) exist in
the port's module of the same path, and every public function (and every
public method of a class of the same name) takes the JAX package's
keyword arguments. A module's public names are its ``__all__`` where it
has one, else its top-level functions, classes and assignments without a
leading underscore, and, in an ``__init__.py``, the names it imports (the
package's exports). ``EXEMPT`` lists what the port leaves out on purpose,
one reason each; an entry that no longer names a gap fails too.

Function parity: the functions the JAX package runs in XLA and the port
has as plain PyTorch (the unsorted reference solver, the constraint
helpers, ``length_mask``, ``random_sim3``, the narrow phase's two return
forms, ``cso_support`` with a triangle margin, the pair-key guard) on the
same seeded inputs: impulses and velocities within 1e-5, integers
exactly."""

import ast
import dataclasses
import importlib
import inspect
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "wgmath_tpu")

# module path -> the port's module of another name (same names inside)
RENAMED = {
    "dynamics/gs_pallas": "dynamics/gs_math",
    "dynamics/build_pallas": "dynamics/build_fused",
}
# (module, name) or (module, function, argument) -> why the port lacks it
# (a renamed module is named by its JAX path)
EXEMPT = {
    ("core/hostmem", "*"): "raises the host's memory-map limit for the TPU "
                           "runtime's mappings; the port maps nothing",
    ("core/dispatch", "on_tpu"): "a TPU backend probe: the port runs on the "
                                 "card unless asked for the CPU "
                                 "(resolve_device)",
    ("core/dispatch", "pallas_interpret"): "Pallas interpret mode off the "
                                           "TPU; the port's kernels have "
                                           "plain twins for CPU tensors",
    ("core/dispatch", "lane_pad"): "pads to the TPU's 128-wide lanes",
    ("core/__init__", "on_tpu"): "as core/dispatch.on_tpu",
    ("core/__init__", "pallas_interpret"): "as core/dispatch.pallas_interpret",
    ("dynamics/build_pallas", "CHUNK"): "the Pallas kernel's lane chunk; "
                                        "the CUDA build sizes its blocks "
                                        "itself",
    ("dynamics/solver", "GS_CM_KERNEL"): "an A/B switch between the Pallas "
                                         "kernel and XLA on the TPU; the "
                                         "port has one kernel a path",
    ("dynamics/solver", "solve", "fused_pallas"): "chose between two TPU "
                                                  "lowerings; the port has "
                                                  "one",
    ("dynamics/gs_fused", "fused_sweep", "use_pallas"): "Pallas or XLA; the "
                                                        "port dispatches on "
                                                        "the tensor's device",
    ("dynamics/gs_fused", "fused_substep1", "use_pallas"): "as fused_sweep",
    ("dynamics/gs_fused", "fused_integrate", "use_pallas"): "as fused_sweep",
    ("dynamics/gs_pallas", "gs_math_block", "use_pallas"): "as fused_sweep",
    ("dynamics/gs_pallas", "gs_math_block_rhs", "use_pallas"): "as "
                                                               "fused_sweep",
    ("dynamics/build_pallas", "build_constraints_fused", "use_pallas"): (
        "as fused_sweep"),
    ("dynamics/solver", "gs_color_major_pass", "layout"): (
        "the port's sweep takes the layout as host ints (layout_host) and "
        "the rung ladder (windows): one kernel launch a sweep"),
    ("dynamics/solver", "gs_color_major_pass", "num_colors"): "in windows",
    ("dynamics/solver", "gs_color_major_pass", "cmax"): "in windows",
    ("dynamics/solver", "gs_color_major_pass", "dim"): "read from the rows",
    ("dynamics/solver", "gs_color_major_pass", "color_lo"): "in the plan",
    ("ops/__init__", "gemm_xla"): "the library twin is gemm_torch",
    ("ops/gemm", "gemm_xla"): "the library twin is gemm_torch",
    ("ops/gemm", "Impl"): "Pallas or XLA; the port's impl is a string "
                          "('auto', 'cuda', 'torch')",
    ("ops/gemm", "gemm_split", "bm"): "Pallas block sizes; the CUDA kernel "
                                      "tiles itself",
    ("ops/gemm", "gemm_split", "bn"): "as bm",
    ("ops/gemm", "gemm_split", "bk"): "as bm",
    ("ops/__init__", "op_assign_pallas"): "the kernel is op_assign_kernel",
    ("ops/elementwise", "op_assign_pallas"): "the kernel is "
                                             "op_assign_kernel (Triton)",
    ("core/testing", "check_lowers"): "traces and lowers with jax.jit; "
                                      "eager PyTorch lowers nothing "
                                      "(core.module.compile_check runs the "
                                      "entries)",
    ("core/module", "EntryPoint.static_argnames"): "jax.jit's static "
                                                   "arguments; nothing is "
                                                   "jitted",
    ("utils/checkpoint", "save_orbax"): "Orbax is JAX's checkpointer; the "
                                        "port saves with torch.save",
    ("parallel/sharded", "body_mesh", "devices"): "a JAX device mesh; the "
                                                  "port takes a "
                                                  "torch.distributed group",
    ("parallel/sharded_pipeline", "replicate_state", "mesh"): "as "
                                                              "body_mesh",
    ("parallel/sharded_pipeline", "make_sharded_step", "mesh"): "as "
                                                                "body_mesh",
}
# pytree registration: JAX flattens these classes, PyTorch has no pytrees
PYTREE_METHODS = ("tree_flatten", "tree_unflatten")


def _modules():
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                out.append(rel[:-3].replace(os.sep, "/"))
    return sorted(out)


def _args(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _public(mod: str) -> dict:
    """name -> ('def', args) | ('class', {member: args or None}) |
    ('name', None) for the JAX module ``mod``."""
    tree = ast.parse(open(os.path.join(JAX_PKG, mod + ".py")).read())
    names, exported = {}, None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            names[node.name] = ("def", _args(node))
        elif isinstance(node, ast.ClassDef):
            members = {}
            for b in node.body:
                if isinstance(b, ast.FunctionDef):
                    prop = any(isinstance(d, ast.Name) and d.id == "property"
                               for d in b.decorator_list)
                    members[b.name] = None if prop else _args(b)
                elif isinstance(b, ast.AnnAssign):
                    members[b.target.id] = None
            names[node.name] = ("class", {
                k: v for k, v in members.items()
                if not k.startswith("_") and k not in PYTREE_METHODS})
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    names[t.id] = ("name", None)
                    if t.id == "__all__":
                        exported = [ast.literal_eval(e) for e in
                                    node.value.elts]
        elif (isinstance(node, ast.ImportFrom)
              and mod.endswith("__init__")):
            for a in node.names:
                names[a.asname or a.name] = ("name", None)
    if exported is not None:
        return {k: names.get(k, ("name", None)) for k in exported}
    return {k: v for k, v in names.items() if not k.startswith("_")
            or k == "__version__"}


def _port_module(mod: str):
    path = RENAMED.get(mod, mod)
    dotted = "wgmath_tpu_torch." + path.replace("/", ".")
    return importlib.import_module(dotted.removesuffix(".__init__"))


def _params(obj) -> set:
    return set(inspect.signature(obj).parameters)


def _gaps(mod: str) -> list:
    """Every (module, name) / (module, function, argument) the port lacks."""
    if (mod, "*") in EXEMPT:
        return [(mod, "*")]
    port = _port_module(mod)
    gaps = []
    for name, (kind, info) in _public(mod).items():
        if not hasattr(port, name):
            gaps.append((mod, name))
            continue
        obj = getattr(port, name)
        if kind == "def":
            have = _params(obj)
            gaps += [(mod, name, a) for a in info if a not in have]
        elif kind == "class":
            for member, args in info.items():
                if not hasattr(obj, member) and not any(
                        f.name == member for f in (
                            dataclasses.fields(obj)
                            if dataclasses.is_dataclass(obj) else ())):
                    gaps.append((mod, f"{name}.{member}"))
                elif args is not None:
                    have = _params(getattr(obj, member))
                    gaps += [(mod, f"{name}.{member}", a) for a in args
                             if a not in have]
    return gaps


@pytest.mark.parametrize("mod", _modules())
def test_public_names_and_arguments(mod):
    missing = [g for g in _gaps(mod) if g not in EXEMPT]
    assert not missing, missing


def test_exemptions_name_gaps():
    """Each exemption names a public name or argument of the JAX package
    that the port really lacks, with a reason."""
    gaps = {g for mod in _modules() for g in _gaps(mod)}
    stale = [k for k in EXEMPT if k not in gaps]
    assert not stale, stale
    assert all(isinstance(r, str) and r for r in EXEMPT.values())


def test_import_is_jax_free_and_lazy():
    """Importing the port with its package exports loads neither JAX nor
    the JAX package, nor Triton (kernels build at their first launch)."""
    import subprocess
    import sys

    code = ("import sys, wgmath_tpu_torch, wgmath_tpu_torch.dynamics, "
            "wgmath_tpu_torch.shapes, wgmath_tpu_torch.broad_phase, "
            "wgmath_tpu_torch.queries, wgmath_tpu_torch.core\n"
            "from wgmath_tpu_torch.dynamics import SimParams\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'wgmath_tpu', 'triton')]\n"
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# ---------------------------------------------------------------------------
# the functions of the JAX package's XLA code, held on seeded inputs
# ---------------------------------------------------------------------------

ATOL = 1e-5


def _random_constraints(rng, c: int, n: int, dim: int, p: int):
    """Seeded constraint fields as numpy arrays (the JAX package's
    layouts): ``c`` rows between ``n`` bodies, body 0 static."""
    s = 2 if dim == 3 else 1
    ang = (3,) if dim == 3 else ()
    f32 = np.float32

    def normal(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(f32)

    def unit(*shape):
        v = rng.normal(size=shape + (dim,))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(f32)

    a = rng.integers(0, n, c)
    b = (a + 1 + rng.integers(0, n - 1, c)) % n
    im = np.repeat(rng.uniform(0.5, 2.0, (n, 1)), dim, 1).astype(f32)
    im[0] = 0.0  # the static body
    fields = dict(
        body_a=a.astype(np.int32), body_b=b.astype(np.int32),
        valid=rng.random(c) < 0.85,
        num_points=rng.integers(1, p + 1, c).astype(np.int32),
        dir_a=unit(c), tangent_a=unit(c, s), im_a=im[a], im_b=im[b],
        cfm_factor=rng.uniform(0.6, 1.0, c).astype(f32),
        limit=rng.uniform(0.2, 0.8, c).astype(f32),
        n_torque_a=normal(c, p, *ang, scale=0.3),
        n_ii_torque_a=normal(c, p, *ang, scale=0.3),
        n_torque_b=normal(c, p, *ang, scale=0.3),
        n_ii_torque_b=normal(c, p, *ang, scale=0.3),
        n_rhs=normal(c, p), n_rhs_wo_bias=normal(c, p),
        n_impulse=np.abs(normal(c, p, scale=0.5)),
        n_impulse_jacobi=np.abs(normal(c, p, scale=0.5)),
        n_r=rng.uniform(0.2, 1.0, (c, p)).astype(f32),
        t_torque_a=normal(c, p, s, *ang, scale=0.3),
        t_ii_torque_a=normal(c, p, s, *ang, scale=0.3),
        t_torque_b=normal(c, p, s, *ang, scale=0.3),
        t_ii_torque_b=normal(c, p, s, *ang, scale=0.3),
        t_rhs=normal(c, p, s), t_rhs_wo_bias=normal(c, p, s),
        t_impulse=normal(c, p, s, scale=0.2),
        t_impulse_jacobi=normal(c, p, s, scale=0.2),
        t_r=(rng.uniform(0.2, 1.0, (c, p, 3)).astype(f32) if dim == 3
             else rng.uniform(0.2, 1.0, (c, p, 1)).astype(f32)),
        local_pt_a=normal(c, p, dim), local_pt_b=normal(c, p, dim),
        info_dist=normal(c, p, scale=0.01),
        info_normal_vel=normal(c, p))
    vels = (normal(n, dim), normal(n, *ang) if dim == 3 else normal(n))
    return fields, vels


def _both_constraints(fields):
    from wgmath_tpu.dynamics.constraint import ContactConstraints as JC
    from wgmath_tpu_torch.dynamics.constraint import ContactConstraints

    names = [f.name for f in dataclasses.fields(ContactConstraints)]
    jc = JC(**{k: jnp.asarray(fields[k]) for k in names})
    tc = ContactConstraints(**{
        k: torch.from_numpy(fields[k].astype(np.int64)
                            if fields[k].dtype == np.int32
                            else fields[k]) for k in names})
    return jc, tc


def _both_vels(vels):
    from wgmath_tpu.dynamics.body import Velocity as JV
    from wgmath_tpu_torch.dynamics.body import Velocity

    return (JV(jnp.asarray(vels[0]), jnp.asarray(vels[1])),
            Velocity(torch.from_numpy(vels[0]), torch.from_numpy(vels[1])))


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol, err_msg=what)


SOLVER_CASES = {"3d_p4": (3, 4), "3d_p1": (3, 1), "2d_p2": (2, 2)}


@pytest.fixture(scope="module", params=list(SOLVER_CASES))
def solver_inputs(request):
    dim, p = SOLVER_CASES[request.param]
    rng = np.random.default_rng(21 + dim * 10 + p)
    fields, vels = _random_constraints(rng, 96, 24, dim, p)
    colors = rng.integers(1, 6, 96).astype(np.int32)
    return fields, vels, colors


def test_warmstart_apply_matches_jax(solver_inputs):
    from wgmath_tpu.dynamics.solver import warmstart_apply as jax_ws
    from wgmath_tpu_torch.dynamics.solver import warmstart_apply

    fields, vels, _ = solver_inputs
    jc, tc = _both_constraints(fields)
    jv, tv = _both_vels(vels)
    want = jax.jit(jax_ws)(jc, jv)
    got = warmstart_apply(tc, tv)
    _close(got.linear, want.linear, what="linear")
    _close(got.angular, want.angular, what="angular")
    assert float(np.abs(np.asarray(want.linear) - vels[0]).max()) > 0.1


def test_gs_colored_pass_matches_jax(solver_inputs):
    from wgmath_tpu.dynamics.solver import gs_colored_pass as jax_pass
    from wgmath_tpu_torch.dynamics.solver import gs_colored_pass

    fields, vels, colors = solver_inputs
    jc, tc = _both_constraints(fields)
    jv, tv = _both_vels(vels)
    want_v, want_c = jax.jit(jax_pass)(jc, jv, jnp.asarray(colors))
    got_v, got_c = gs_colored_pass(tc, tv, torch.from_numpy(
        colors.astype(np.int64)))
    _close(got_v.linear, want_v.linear, what="linear")
    _close(got_v.angular, want_v.angular, what="angular")
    _close(got_c.n_impulse, want_c.n_impulse, what="n_impulse")
    _close(got_c.t_impulse, want_c.t_impulse, what="t_impulse")
    moved = np.abs(np.asarray(want_c.n_impulse) - fields["n_impulse"])
    assert float(moved.max()) > 0.1
    # an explicit colour count: the first two colours only
    want_2 = jax.jit(jax_pass)(jc, jv, jnp.asarray(colors),
                               num_colors=jnp.int32(2))[1]
    got_2 = gs_colored_pass(tc, tv, torch.from_numpy(colors.astype(
        np.int64)), num_colors=torch.tensor(2))[1]
    _close(got_2.n_impulse, want_2.n_impulse, what="n_impulse, 2 colours")
    assert not np.allclose(np.asarray(want_2.n_impulse),
                           np.asarray(want_c.n_impulse))


def test_sort_solver_fields_matches_jax(solver_inputs):
    from wgmath_tpu.dynamics.solver import (
        _SORT_FIELDS,
        build_color_layout as jax_layout,
        sort_solver_fields as jax_sort,
    )
    from wgmath_tpu_torch.dynamics.solver import (
        SORT_FIELDS,
        sort_solver_fields,
    )

    fields, _, colors = solver_inputs
    assert tuple(SORT_FIELDS) == tuple(_SORT_FIELDS)
    jc, tc = _both_constraints(fields)
    order = jax_layout(jnp.asarray(colors), jc.valid, max_colors=8,
                       cmax=32)[0]
    want = jax_sort(jc, order)
    got = sort_solver_fields(tc, torch.from_numpy(np.asarray(
        order).astype(np.int64)))
    assert isinstance(got, SimpleNamespace)
    assert int(np.asarray(order).max()) == 96  # padding rows present
    for f in SORT_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_constraint_helpers_match_jax():
    from wgmath_tpu.dynamics import constraint as jcon
    from wgmath_tpu_torch.dynamics import constraint as tcon

    for dim in (2, 3):
        assert tcon.max_points(dim) == jcon.max_points(dim)
    rng = np.random.default_rng(5)
    x = rng.normal(size=200).astype(np.float32)
    x[:20] = 0.0
    x[20:40] *= 1e-21
    got = tcon.maybe_inv(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcon.maybe_inv(jnp.asarray(x))))
    v = rng.normal(size=(200, 3)).astype(np.float32)
    v[:10] = 0.0
    lim = rng.uniform(0.0, 2.0, 200).astype(np.float32)
    got = tcon.cap_magnitude(torch.from_numpy(v), torch.from_numpy(lim))
    want = jcon.cap_magnitude(jnp.asarray(v), jnp.asarray(lim))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    for dim in (2, 3):
        te = tcon.Contacts.empty(16, dim, device="cpu")
        je = jcon.Contacts.empty(16, dim)
        assert te.dim == je.dim == dim and te.capacity == 16
        for f in dataclasses.fields(tcon.Contacts):
            g, w = getattr(te, f.name), np.asarray(getattr(je, f.name))
            assert g.shape == w.shape, f.name
            np.testing.assert_array_equal(g.numpy(), w, f.name)
        fields, _ = _random_constraints(rng, 8, 4, dim, 2)
        jc, tc = _both_constraints(fields)
        assert tc.dim == jc.dim == dim


def test_length_mask_and_random_sim3_match_jax():
    from wgmath_tpu.core import dispatch as jdisp
    from wgmath_tpu.core import testing as jtest
    from wgmath_tpu_torch.core import dispatch as tdisp
    from wgmath_tpu_torch.core import testing as ttest

    for count in (0, 5, 64, 99):
        got = tdisp.length_mask(64, torch.tensor(count))
        want = jdisp.length_mask(64, jnp.asarray(count))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(ttest.random_sim3(np.random.default_rng(3), 50),
                    jtest.random_sim3(np.random.default_rng(3), 50)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_narrow_phase_return_forms_match_jax():
    """Contacts alone by default, ``(contacts, demands)`` with
    ``with_overflow``; the default width is ``max_points(dim)``."""
    from tests.test_torch_broad_narrow import PRED, _scene
    from wgmath_tpu.queries.narrow_phase import narrow_phase as jax_narrow
    from wgmath_tpu_torch.dynamics.constraint import Contacts
    from wgmath_tpu_torch.queries.narrow_phase import narrow_phase

    js, ts, jp, tp = _scene(7, n=40)

    def jax_run(**kw):  # one jitted call (eager JAX takes ~15 s here)
        return jax.jit(lambda poses, pairs: jax_narrow(
            poses, js.shapes, pairs, PRED, bc_capacity=32, **kw))(
                js.bodies.poses, jp)

    want = jax_run()
    got = narrow_phase(ts.bodies.poses, ts.shapes, tp, PRED, bc_capacity=32)
    assert isinstance(got, Contacts) and got.points_a.shape[1] == 4
    want_w, want_need = jax_run(with_overflow=True)
    got_w, got_need = narrow_phase(ts.bodies.poses, ts.shapes, tp, PRED,
                                   bc_capacity=32, with_overflow=True)
    np.testing.assert_array_equal(got_need.numpy(), np.asarray(want_need))
    assert int(want.valid.sum()) > 10
    for g, w in ((got, want), (got_w, want_w)):
        for f in ("body_a", "body_b", "num_points", "valid"):
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)), f)
        v = np.asarray(w.valid)
        for f in ("normal_a", "points_a", "dist"):
            _close(getattr(g, f).numpy()[v], np.asarray(getattr(w, f))[v],
                   atol=1e-5, what=f)


def test_cso_support_with_tri_margin_matches_jax():
    """A triangle A (its vertices given per row) against a ball, a cuboid
    and a capsule, with a margin: the core samples are the margin-free
    ones in both packages."""
    from wgmath_tpu.queries.gjk import cso_support as jax_cso
    from wgmath_tpu.shapes import shape as jshp
    from wgmath_tpu_torch.queries.gjk import cso_support

    rng = np.random.default_rng(11)
    m = 12
    tag_a = np.full(m, jshp.TRIANGLE, np.int32)
    tag_b = np.asarray([jshp.BALL, jshp.CUBOID, jshp.CAPSULE] * 4, np.int32)
    par = rng.uniform(0.2, 1.0, (m, jshp.NUM_PARAMS)).astype(np.float32)
    par_a = np.zeros_like(par)
    q = rng.normal(size=(m, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, zq, w = q.T
    r_ab = np.stack([
        1 - 2 * (y * y + zq * zq), 2 * (x * y - zq * w), 2 * (x * zq + y * w),
        2 * (x * y + zq * w), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - x * w),
        2 * (x * zq - y * w), 2 * (y * zq + x * w), 1 - 2 * (x * x + y * y),
    ], -1).reshape(m, 3, 3).astype(np.float32)
    t_ab = rng.normal(size=(m, 3)).astype(np.float32)
    d = rng.normal(size=(m, 3)).astype(np.float32)
    tri = rng.normal(size=(m, 3, 3)).astype(np.float32)
    verts = np.zeros((1, 3), np.float32)
    for margin in (0.0, 0.05):
        want = jax_cso(*(jnp.asarray(v) for v in
                         (tag_a, par_a, tag_b, par, r_ab, t_ab, d, verts,
                          tri)), tri_margin=margin)
        got = cso_support(*(torch.from_numpy(v) for v in
                            (tag_a.astype(np.int64), par_a,
                             tag_b.astype(np.int64), par, r_ab, t_ab, d,
                             verts, tri)), tri_margin=margin)
        for g, w, f in zip(got, want, ("w", "p_a", "p_b")):
            _close(g.numpy(), np.asarray(w), atol=1e-5, what=f)


def test_pair_key_guard_matches_jax():
    from wgmath_tpu.dynamics.solver import pair_key as jax_key
    from wgmath_tpu_torch.dynamics.solver import pair_key

    rng = np.random.default_rng(2)
    a = rng.integers(0, 65535, 64)
    b = rng.integers(0, 65535, 64)
    v = rng.random(64) < 0.8
    got = pair_key(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(v), num_bodies=65535)
    want = jax_key(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                   jnp.asarray(v), num_bodies=65535)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(want).astype(np.int64))
    with pytest.raises(AssertionError):
        jax_key(jnp.asarray(a, jnp.int32), jnp.asarray(b, jnp.int32),
                jnp.asarray(v), num_bodies=1 << 16)
    with pytest.raises(ValueError, match="65536"):
        pair_key(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(v), num_bodies=1 << 16)
