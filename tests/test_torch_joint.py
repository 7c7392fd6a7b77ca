"""The port's impulse joints (``wgmath_tpu_torch.dynamics.joint``) against
the JAX package's, on the CPU.

- Every constructor's ``JointSet`` (fixed, spherical with and without the
  swing cone, revolute with limits and a motor, prismatic with limits)
  equals JAX's field by field, and carries its host values.
- On 68 mixed joints over 40 seeded bodies (every slot family: locks,
  per-axis and coupled limits, position and velocity motors of both
  models, coupled linear motors, and a star of 12 joints on one dynamic
  body, so colours pass ``max_colors``): every field of
  ``build_joint_constraints`` (orthogonalized) and ``joint_gs_pass``'s
  velocities and impulses, biased and after ``remove_joint_bias``. JAX's
  outputs, each function one jitted call on the inputs this file builds,
  are stored by ``scripts/export_joints_npz.py --only unit`` (group
  ``unit``, ``artifacts/joints_jax.npz``): a cold compile of them took
  ~40 s.
- ``convert`` carries a JAX state with joints across and back.

The joints nearly meet (anchors within 2 cm, frames within 0.1 rad), as
in a running scene. Tolerances, each a share of the array's largest
magnitude: integers, masks and the bounds (±1e20 or the limits) exact;
the build's reals and the passes from the port's own build within 5e-5,
the gap XLA's CPU contraction of ``a*b+c`` into one rounding leaves
against PyTorch's two roundings (ROADMAP C4): the rhs is 240·(the
millimetre gap between two world points of ~1.5 m), so an ulp of the
points is ~3e-5 of it; the passes from JAX's own constraints within 2e-6
(the same arithmetic, only sums rounded apart)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from wgmath_tpu.dynamics import joint as jj
from wgmath_tpu.scenes import builders as jax_builders
from wgmath_tpu_torch.convert import (
    joints_from_arrays,
    joints_to_arrays,
    state_from_arrays,
    state_to_arrays,
)
from wgmath_tpu_torch.dynamics import joint as tj
from wgmath_tpu_torch.dynamics.body import Velocity, WorldMassProperties
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry.sim import Sim
from tests.torch_threads import one_torch_thread  # noqa: F401

NPZ = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "artifacts", "joints_jax.npz")
BUILD_TOL = 5e-5
PASS_TOL = 2e-6
MAX_COLORS = 8
N_BODIES, N_STATIC = 40, 4
SUB = SimParams().substep()
CONS_FIELDS = tuple(f.name for f in dataclasses.fields(tj.JointConstraints)
                    )[:-2]
# JAX's two passes (biased, then without bias): velocities and impulses
PASS_KEYS = ("linear1", "angular1", "impulse1", "linear2", "angular2",
             "impulse2")


def _close(got, want, what, tol=BUILD_TOL):
    """Integers, masks and bounds exactly; other reals within ``tol`` of
    the array's largest magnitude."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if (want.dtype == np.bool_ or np.issubdtype(want.dtype, np.integer)
            or what.startswith("bounds")):
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=tol * np.abs(want).max(),
                                   err_msg=what)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _qmul(a, b):
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw,
                     aw * bw - ax * bx - ay * by - az * bz], -1)


def _qconj(q):
    return q * np.asarray([-1.0, -1.0, -1.0, 1.0])


def _qrot(q, v):
    u, w = q[..., :3], q[..., 3:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _mixed_arrays():
    """The mixed joint set's inputs (numpy), frames at random rotations."""
    rng = np.random.default_rng(15)
    rows = []  # (locked, limit, motor, coupled)
    lmin = np.full((68, 6), -tj.MAX, np.float32)
    lmax = np.full((68, 6), tj.MAX, np.float32)
    tvel = np.zeros((68, 6), np.float32)
    tpos = np.zeros((68, 6), np.float32)
    stiff = np.zeros((68, 6), np.float32)
    damp = np.zeros((68, 6), np.float32)
    force = np.full((68, 6), tj.MAX, np.float32)
    model = np.zeros((68, 6), np.int32)
    k = 0
    for _ in range(8):  # fixed
        rows.append((0b111111, 0, 0, 0))
        k += 1
    for i in range(16):  # spherical, half of them with the swing cone
        if i % 2:
            rows.append((0b000111, 1 << 4, 0, 0b110000))
            lmin[k, 4], lmax[k, 4] = -0.3, 0.3
        else:
            rows.append((0b000111, 0, 0, 0))
        k += 1
    for i in range(8):  # revolute, limits and a velocity motor
        rows.append((0b110111, 1 << 3, 1 << 3, 0))
        lmin[k, 3], lmax[k, 3] = -0.2 - 0.1 * i, 0.1 + 0.05 * i
        tvel[k, 3], damp[k, 3] = 1.5 - 0.4 * i, 2.0 + i
        k += 1
    for i in range(8):  # prismatic, limits
        rows.append((0b111110, 1, 0, 0))
        lmin[k, 0], lmax[k, 0] = -0.05 * (i + 1), 0.04 * (i + 1)
        k += 1
    for i in range(8):  # coupled linear x / y or y / z: motor and limit
        pair, axis = (0b011, 0) if i % 2 else (0b110, 1)
        rows.append((0b111111 & ~pair, pair, pair, pair))
        lmax[k, axis] = 0.05 + 0.03 * i
        tvel[k, axis], tpos[k, axis] = 0.3 * i - 1.0, 0.02 * i
        stiff[k, axis], damp[k, axis] = 50.0 * (i % 3), 1.0 + i
        force[k, axis] = 5.0 if i % 4 < 2 else tj.MAX
        model[k, axis] = (i // 2) % 2
        k += 1
    for i in range(8):  # angular position motors (both models) and limits,
        # linear locks on x / y, a limited velocity motor on linear z
        rows.append((0b000011, 0b100 | (0b001000 << (i % 3)), 0b111100, 0))
        lmin[k, 3 + i % 3], lmax[k, 3 + i % 3] = -0.4, 0.3
        lmin[k, 2], lmax[k, 2] = -0.1, 0.2
        tvel[k, 2], damp[k, 2] = 0.5 - 0.2 * i, 3.0
        for ax in (3, 4, 5):
            tpos[k, ax] = 0.1 * (ax - 3) - 0.05 * i
            tvel[k, ax] = 0.2 * i
            stiff[k, ax] = 10.0 + 5.0 * ax
            damp[k, ax] = 0.5 + 0.1 * i
            force[k, ax] = 2.0 + i
            model[k, ax] = (i + ax) % 2
        k += 1
    for _ in range(12):  # the star: colours past MAX_COLORS
        rows.append((0b000111, 0, 0, 0))
        k += 1
    assert k == 68
    body_a = rng.integers(0, N_BODIES, k)
    body_b = rng.integers(0, N_BODIES - 1, k)
    body_b = np.where(body_b >= body_a, body_b + 1, body_b)
    body_a[-12:] = N_STATIC + 1  # a dynamic hub
    body_b[-12:] = np.arange(N_STATIC + 2, N_STATIC + 14)
    masks = np.asarray(rows, np.int32).T
    # frames that nearly meet: b's is a's carried into b's body, off by up
    # to 2 cm and 0.1 rad
    w = _world()
    qa, ta = w["rot"][body_a], w["tra"][body_a]
    qb, tb = w["rot"][body_b], w["tra"][body_b]
    rot_a = _unit_quats(rng, k)
    anchor_a = rng.uniform(-0.6, 0.6, (k, 3)).astype(np.float32)
    world_rot = _qmul(qa, rot_a)
    world_pt = ta + _qrot(qa, anchor_a)
    nudge = np.concatenate([rng.uniform(-0.05, 0.05, (k, 3)),
                            np.ones((k, 1))], -1)
    rot_b = _qmul(_qconj(qb), _qmul(world_rot, nudge / np.linalg.norm(
        nudge, axis=-1, keepdims=True)))
    anchor_b = _qrot(_qconj(qb), world_pt + rng.uniform(-0.02, 0.02, (k, 3))
                     - tb)
    return dict(
        body_a=body_a.astype(np.int32), body_b=body_b.astype(np.int32),
        rot_a=rot_a, rot_b=rot_b.astype(np.float32), anchor_a=anchor_a,
        anchor_b=anchor_b.astype(np.float32),
        locked_axes=masks[0], limit_axes=masks[1], motor_axes=masks[2],
        coupled_axes=masks[3], limit_min=lmin, limit_max=lmax,
        motor_target_vel=tvel, motor_target_pos=tpos,
        motor_stiffness=stiff, motor_damping=damp, motor_max_force=force,
        motor_model=model,
        dynamic=np.arange(N_BODIES) >= N_STATIC)


def _world():
    """Seeded substep poses, frame mass properties and velocities."""
    rng = np.random.default_rng(16)
    n = N_BODIES
    rot = _unit_quats(rng, n)
    tra = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    dyn = np.arange(n) >= N_STATIC
    inv_mass = np.where(dyn[:, None], rng.uniform(0.5, 2.0, (n, 1)),
                        0.0).repeat(3, 1).astype(np.float32)
    com = (tra + rng.uniform(-0.05, 0.05, (n, 3))).astype(np.float32)
    r = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    d = rng.uniform(0.5, 3.0, (n, 3)) * dyn[:, None]
    ii = np.einsum("nij,nj,nkj->nik", r, d, r).astype(np.float32)
    lin = np.where(dyn[:, None], rng.normal(0, 1.0, (n, 3)), 0.0)
    ang = np.where(dyn[:, None], rng.normal(0, 1.0, (n, 3)), 0.0)
    return dict(rot=rot, tra=tra, scale=np.ones(n, np.float32),
                inv_mass=inv_mass, com=com, ii=ii,
                lin=lin.astype(np.float32), ang=ang.astype(np.float32))


@pytest.fixture(scope="module")
def case():
    """The port's inputs and JAX's outputs for the mixed set."""
    with np.load(NPZ) as f:
        z = {k[len("unit."):]: f[k] for k in f.files
             if k.startswith("unit.")}
    w = _world()
    a = _mixed_arrays()
    jset = {k[len("joints."):]: v for k, v in z.items()
            if k.startswith("joints.")}
    np.testing.assert_array_equal(jset["body_a"], a["body_a"])
    port = dict(
        jset=joints_from_arrays(jset, device="cpu"),
        poses=Sim(*(torch.from_numpy(w[k]) for k in ("rot", "tra",
                                                     "scale"))),
        mprops=WorldMassProperties(*(torch.from_numpy(w[k]) for k in (
            "inv_mass", "com", "ii"))),
        vels=Velocity(torch.from_numpy(w["lin"]),
                      torch.from_numpy(w["ang"])))
    return dict(jset=jset, port=port,
                jcons={f: z[f"cons.{f}"] for f in CONS_FIELDS},
                jpass={k: z[f"pass.{k}"] for k in PASS_KEYS})


def test_mixed_set_covers_the_slots(case):
    """The mixed set reaches every slot, and colours past MAX_COLORS."""
    t = case["port"]["jset"]
    assert t.slots == tuple(range(18))
    assert t.max_color > MAX_COLORS
    assert t.max_color == int(case["jset"]["colors"].max())
    np.testing.assert_array_equal(
        tj.active_slots(*(case["jset"][f] for f in (
            "locked_axes", "limit_axes", "motor_axes", "coupled_axes",
            "valid"))), case["jcons"]["active"])


def test_build_joint_constraints_matches_jax(case):
    p = case["port"]
    got = tj.build_joint_constraints(p["jset"], p["poses"], p["mprops"],
                                     SUB)
    for f in CONS_FIELDS:
        _close(getattr(got, f), case["jcons"][f], f)


def _port_cons(jcons, jset):
    return tj.JointConstraints(
        **{f: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                               else v) for f, v in jcons.items()},
        slots=jset.slots, max_color=jset.max_color)


@pytest.mark.parametrize("source", ["jax_build", "port_build"])
def test_joint_gs_pass_matches_jax(case, source):
    """Two passes (biased, then without bias) from JAX's constraints or
    from the port's own build: velocities and impulses. Joints past
    MAX_COLORS keep zero impulses."""
    p = case["port"]
    jset = p["jset"]
    cons = (_port_cons(case["jcons"], jset) if source == "jax_build" else
            tj.build_joint_constraints(jset, p["poses"], p["mprops"], SUB))
    v1, c1 = tj.joint_gs_pass(cons, p["vels"], jset.colors,
                              max_colors=MAX_COLORS)
    v2, c2 = tj.joint_gs_pass(tj.remove_joint_bias(c1), v1, jset.colors,
                              max_colors=MAX_COLORS)
    got = dict(zip(PASS_KEYS, (v1.linear, v1.angular, c1.impulse,
                                v2.linear, v2.angular, c2.impulse)))
    for what in PASS_KEYS:
        _close(got[what], case["jpass"][what], f"{source}: {what}",
               PASS_TOL if source == "jax_build" else BUILD_TOL)
    late = (jset.colors > MAX_COLORS).numpy()
    assert late.any() and (c2.impulse.numpy()[late] == 0).all()
    assert (c2.impulse.numpy()[~late] != 0).any()


CONSTRUCTORS = {
    "fixed": ("fixed_joints", {}),
    "spherical": ("spherical_joints", {}),
    "swing_cone": ("spherical_joints", dict(swing_limit=0.5)),
    "revolute": ("revolute_joints", dict(
        axes=[[0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]],
        limits=(-0.3, 0.7), motor_vel=2.0, motor_damping=300.0)),
    "prismatic": ("prismatic_joints", dict(
        axes=[[0.0, 1.0, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, -1.0]],
        limits=(-0.5, 0.5))),
}


@pytest.mark.parametrize("name", list(CONSTRUCTORS))
def test_constructors_match_jax(name):
    fn, kw = CONSTRUCTORS[name]
    args = ([0, 1, 2], [1, 2, 3], [[0.5, 0.0, 0.0]] * 3,
            [[-0.5, 0.0, 0.1]] * 3)
    dyn = np.asarray([False, True, True, True])
    want = getattr(jj, fn)(*args, **kw, dynamic_mask=dyn)
    got = getattr(tj, fn)(*args, **kw, dynamic_mask=dyn, device="cpu")
    w, g = joints_to_arrays(want), joints_to_arrays(got)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got.max_color == 2 and got.num_joints == 3 and got.dim == 3
    assert got.slots == tuple(int(s) for s in np.flatnonzero(
        tj.active_slots(w["locked_axes"], w["limit_axes"], w["motor_axes"],
                        w["coupled_axes"], w["valid"]).any(0)))


def test_host_values_follow_the_tensors_of_any_made_set(case):
    """``max_color`` and ``slots`` are computed from a set's own tensors
    whenever it is made, ``dataclasses.replace`` included, so they cannot
    disagree with them; a valid joint without a colour is refused."""
    t = case["port"]["jset"]
    colors = torch.where(t.colors > 2, torch.full_like(t.colors, 2),
                         t.colors)
    assert dataclasses.replace(t, colors=colors).max_color == 2
    spherical = torch.full_like(t.locked_axes, 0b000111)
    zero = torch.zeros_like(t.locked_axes)
    s = dataclasses.replace(t, locked_axes=spherical, limit_axes=zero,
                            motor_axes=zero, coupled_axes=zero)
    assert s.slots == (9, 10, 11)
    none = dataclasses.replace(t, valid=torch.zeros_like(t.valid))
    assert (none.max_color, none.slots) == (0, ())
    with pytest.raises(ValueError, match="no colour"):
        dataclasses.replace(t, colors=torch.zeros_like(t.colors))


def test_2d_joints_refused():
    """2D joints, once refused, are built: nine slots, the 2D groups
    (``tests/test_torch_planar.py`` holds their build and pass against
    the JAX package's)."""
    js = tj.fixed_joints([0], [1], [[0.0, 0.0]], [[1.0, 0.0]], dim=2,
                         device="cpu")
    assert js.dim == 2 and js.slots == (3, 4, 5)
    want = jj.fixed_joints([0], [1], [[0.0, 0.0]], [[1.0, 0.0]], dim=2)
    got = joints_to_arrays(js)
    for k, v in joints_to_arrays(want).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_convert_round_trips_a_jax_state_with_joints():
    want = state_to_arrays(jax_builders.pendulum_chain(2,
                                                       joint="revolute"))
    state = state_from_arrays(want, device="cpu")
    assert state.joints.slots == (7, 8, 9, 10, 11)
    assert state.joints.max_color == 2
    back = state_to_arrays(state)
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
