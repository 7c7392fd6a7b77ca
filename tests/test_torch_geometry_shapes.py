"""The port's geometry, shapes, bodies and scene builder against the JAX
package on the same seeded inputs, plus the port's package rules: it
imports no JAX and runs on the card unless asked for the CPU."""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from wgmath_tpu.core import dispatch as jdispatch
from wgmath_tpu.dynamics import SimParams as JaxSimParams
from wgmath_tpu.pipeline import fine_bucket as jax_fine_bucket
from wgmath_tpu.dynamics import body as jbody
from wgmath_tpu.geometry import quat as jquat
from wgmath_tpu.geometry import sim as jsim
from wgmath_tpu.scenes.builders import ball_pit as jax_ball_pit
from wgmath_tpu.shapes import shape as jshape
from wgmath_tpu_torch import ops
from wgmath_tpu_torch.core import dispatch as tdispatch
from wgmath_tpu_torch.core import compile_check, view_of
from wgmath_tpu_torch.dynamics import body as tbody
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import quat as tquat
from wgmath_tpu_torch.geometry import sim as tsim
from wgmath_tpu_torch.pipeline import fine_bucket
from wgmath_tpu_torch.scenes.builders import ball_pit
from wgmath_tpu_torch.shapes import shape as tshape
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# float32 elementwise math in another association order
RTOL, ATOL = 1e-5, 1e-6


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol)


def _poses(rng, n):
    q = _unit_quats(rng, n)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return (tsim.Sim(*(torch.from_numpy(x) for x in (q, t, s))),
            jsim.Sim(*(jnp.asarray(x) for x in (q, t, s))))


def test_quat_ops_match_jax():
    rng = np.random.default_rng(0)
    a, b = _unit_quats(rng, 64), _unit_quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    w = np.concatenate([rng.normal(size=(60, 3)) * 0.3,
                        np.zeros((4, 3))]).astype(np.float32)  # small angles
    ta, tb, tv, tw = (torch.from_numpy(x) for x in (a, b, v, w))
    _close(tquat.mul(ta, tb), jquat.mul(jnp.asarray(a), jnp.asarray(b)))
    _close(tquat.mul_vec(ta, tv), jquat.mul_vec(jnp.asarray(a),
                                                jnp.asarray(v)))
    _close(tquat.inv_mul_vec(ta, tv), jquat.inv_mul_vec(jnp.asarray(a),
                                                        jnp.asarray(v)))
    _close(tquat.normalize(ta * 3.0), jquat.normalize(jnp.asarray(a) * 3.0))
    _close(tquat.from_scaled_axis(tw), jquat.from_scaled_axis(jnp.asarray(w)))
    _close(tquat.to_matrix(ta), jquat.to_matrix(jnp.asarray(a)))


def test_sim_ops_match_jax():
    rng = np.random.default_rng(1)
    ta, ja = _poses(rng, 64)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    _close(tsim.mul_pt(ta, tp), jsim.mul_pt(ja, jp))
    _close(tsim.inv_mul_pt(ta, tp), jsim.inv_mul_pt(ja, jp))
    _close(tsim.mul_unit_vec(ta, tp), jsim.mul_unit_vec(ja, jp))
    _close(tsim.inv_mul_unit_vec(ta, tp), jsim.inv_mul_unit_vec(ja, jp))


def test_ball_pit_scene_matches_jax():
    """Same numpy-seeded jitter, same statics-first layout: bitwise."""
    ts, js = ball_pit(96, device="cpu"), jax_ball_pit(96)
    tb, jb = ts.bodies, js.bodies
    pairs = [(tb.poses.rotation, jb.poses.rotation),
             (tb.poses.translation, jb.poses.translation),
             (tb.poses.scale, jb.poses.scale),
             (tb.vels.linear, jb.vels.linear),
             (ts.shapes.params, js.shapes.params)]
    pairs += [(getattr(tb.local_mprops, f), getattr(jb.local_mprops, f))
              for f in ("inv_mass", "com", "inertia_ref_frame",
                        "inv_principal_inertia")]
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ts.shapes.tag.numpy(),
                                  np.asarray(js.shapes.tag))
    assert ts.shapes.kinds == js.shapes.kinds
    np.testing.assert_array_equal(tb.is_dynamic().numpy(),
                                  np.asarray(jb.is_dynamic()))


def test_aabbs_radii_and_mass_props_match_jax():
    ts, js = ball_pit(96, device="cpu"), jax_ball_pit(96)
    rng = np.random.default_rng(2)
    q = _unit_quats(rng, ts.bodies.num_bodies)
    ts.bodies.poses.rotation = torch.from_numpy(q)
    js.bodies.poses.rotation = jnp.asarray(q)
    for got, want in zip(
            tshape.world_aabbs(ts.shapes, ts.bodies.poses, margin=0.002),
            jshape.world_aabbs(js.shapes, js.bodies.poses, margin=0.002)):
        _close(got, want)
    np.testing.assert_array_equal(
        tshape.ball_radii_or_nan(ts.shapes, ts.bodies.poses).numpy(),
        np.asarray(jshape.ball_radii_or_nan(js.shapes, js.bodies.poses)))
    tm = tbody.update_mprops(ts.bodies.poses, ts.bodies.local_mprops)
    jm = jbody.update_mprops(js.bodies.poses, js.bodies.local_mprops)
    _close(tm.com, jm.com)
    # entries are ~19 on the diagonal; off-diagonal ones are the rounding
    # residue (~1e-6) of R diag(i) R^T with an isotropic i
    _close(tm.inv_inertia, jm.inv_inertia, rtol=1e-5, atol=1e-5)


def test_integrate_velocity_matches_jax():
    rng = np.random.default_rng(3)
    tp, jp = _poses(rng, 64)
    lin = rng.normal(size=(64, 3)).astype(np.float32)
    ang = rng.normal(size=(64, 3)).astype(np.float32)
    com = rng.normal(scale=0.1, size=(64, 3)).astype(np.float32)
    got = tbody.integrate_velocity(
        tp, tbody.Velocity(torch.from_numpy(lin), torch.from_numpy(ang)),
        torch.from_numpy(com), 1.0 / 240.0)
    want = jbody.integrate_velocity(
        jp, jbody.Velocity(jnp.asarray(lin), jnp.asarray(ang)),
        jnp.asarray(com), 1.0 / 240.0)
    _close(got.rotation, want.rotation)
    _close(got.translation, want.translation)


def test_sim_params_substep_constants_match_jax():
    t, j = SimParams().substep(), JaxSimParams().substep()
    for name in ("dt", "inv_dt", "contact_erp_inv_dt", "contact_cfm_factor",
                 "allowed_linear_error", "max_corrective_velocity",
                 "prediction_distance", "warmstart_coefficient"):
        assert getattr(t, name) == pytest.approx(getattr(j, name),
                                                 rel=1e-12), name


def test_dispatch_and_buckets_match_jax():
    for n in list(range(0, 70)) + [1023, 1024, 1025, 1537, 3000, 37058,
                                   49153]:
        for m in (1, 3, 128, 256):
            assert tdispatch.cdiv(n, m) == jdispatch.cdiv(n, m)
            assert tdispatch.round_up(n, m) == jdispatch.round_up(n, m)
        assert (tdispatch.next_power_of_two(n)
                == jdispatch.next_power_of_two(n))
        for floor in (256, 1024):
            assert (tdispatch.capacity_bucket(n, floor=floor)
                    == jdispatch.capacity_bucket(n, floor=floor))
        assert fine_bucket(n) == jax_fine_bucket(n)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        ball_pit(8)
    # the linear-algebra entry points: an array that is not yet a tensor
    # goes to the card, and compile_check runs there unless told otherwise
    eye = np.eye(4, dtype=np.float32)
    for call in (lambda: ops.gemm(eye, eye),
                 lambda: ops.gemv(eye, eye[0]),
                 lambda: ops.reduce(eye, "sum"),
                 lambda: ops.op_assign_kernel(eye, eye, "add"),
                 lambda: compile_check("linalg.gemm"),
                 lambda: view_of(eye)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    # a CPU tensor, or device="cpu", is the way to ask for the CPU
    assert float(ops.reduce(torch.from_numpy(eye), "sum")) == 4.0
    assert compile_check("linalg.reduce", device="cpu")


def test_port_and_chip_smoke_import_no_jax():
    """Every module of the port and chip_smoke.py's helpers load without
    JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import wgmath_tpu_torch\n"
        "for m in pkgutil.walk_packages(wgmath_tpu_torch.__path__,\n"
        "                               'wgmath_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "chip_smoke.gs_math_inputs, chip_smoke.gs_math_work\n"
        "chip_smoke.linalg_kernel_phase, chip_smoke.linalg_path_phase\n"
        "chip_smoke.gemv_path_phase, chip_smoke.geometry_path_phase\n"
        "chip_smoke.ray_path_phase, chip_smoke.ray_bench_arrays(64)\n"
        "chip_smoke.box_phase, chip_smoke.box_kernel_checks\n"
        "chip_smoke.primitives_phase, chip_smoke.primitives_kernel_checks\n"
        "for m in ('core.module', 'core.tensor', 'core.testing',\n"
        "          'ops.gemm', 'ops.reduce', 'ops.elementwise', 'ops.gemv',\n"
        "          'geometry.rot2', 'queries.ray', 'queries.projection',\n"
        "          'queries.sat', 'queries.gjk', 'queries.epa',\n"
        "          'queries.pfm_manifold', 'scenes.builders'):\n"
        "    assert 'wgmath_tpu_torch.' + m in sys.modules, m\n"
        "assert 'triton' not in sys.modules\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'wgmath_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("clean")
