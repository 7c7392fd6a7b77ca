"""The 2D cases of ``artifacts/planar_jax.npz.xz``
(``scripts/export_planar_npz.py``) for the port: each case's scene, mode
and configuration, and its stored JAX states as the port's states. Shared
by ``tests/test_torch_pipeline_planar.py``, ``tests/test_torch_cuda.py``
and ``chip_smoke.py``; torch and numpy only, no JAX."""

from __future__ import annotations

import json
import os

import numpy as np

from wgmath_tpu_torch.shapes.shape import BALL, CAPSULE, CUBOID

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ_PLANAR = os.path.join(ROOT, "artifacts", "planar_jax.npz.xz")
_CACHE: dict = {}


def state_digest(arrays: dict) -> str:
    """SHA-1 of a state's arrays (``convert.state_to_arrays``): each key,
    dtype, shape and bytes, in key order."""
    import hashlib

    h = hashlib.sha1()
    for k in sorted(arrays):
        v = np.ascontiguousarray(arrays[k])
        h.update(f"{k}|{v.dtype.str}|{v.shape}|".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def planar_arrays() -> dict:
    """Every array of the file, read once."""
    if "z" not in _CACHE:
        from wgmath_tpu_torch.convert import load_arrays

        _CACHE["z"] = load_arrays(NPZ_PLANAR)
    return _CACHE["z"]


def small_cases() -> tuple:
    """The stored small cases' names, in file order."""
    z = planar_arrays()
    return tuple(k[:-len(".scene")] for k in z if k.endswith(".scene"))


def case_scene(case: str) -> str:
    return str(planar_arrays()[f"{case}.scene"])


def case_mode(case: str) -> str:
    return str(planar_arrays()[f"{case}.mode"])


def config_of(key: str):
    """The ``PipelineConfig`` stored under ``key`` (a ``config_json``)."""
    from wgmath_tpu_torch.pipeline import PipelineConfig

    return PipelineConfig.from_dict(json.loads(str(planar_arrays()[key])))


def params_of(mode: str):
    from wgmath_tpu_torch.dynamics.sim_params import SimParams

    return SimParams.jacobi() if mode == "jacobi" else SimParams.tgs_soft()


def _warmstart_fill(arrays: dict, dim: int) -> None:
    """Zeros for the fields of ``prev_constraints`` a step does not read
    (the file keeps the keys, validity and impulses only), shaped for
    ``dim``."""
    from wgmath_tpu_torch.dynamics.constraint import ContactConstraints

    pre = "prev_constraints."
    if pre + "body_a" not in arrays:
        return
    c, p = arrays[pre + "n_impulse"].shape
    s = arrays[pre + "t_impulse"].shape[2]
    ang = () if dim == 2 else (3,)
    shapes = {"dir_a": (dim,), "tangent_a": (s, dim), "im_a": (dim,),
              "im_b": (dim,), "cfm_factor": (), "limit": (),
              "num_points": (), "t_r": (p, 1 if dim == 2 else 3),
              "local_pt_a": (p, dim), "local_pt_b": (p, dim)}
    for f in ("n_torque_a", "n_ii_torque_a", "n_torque_b", "n_ii_torque_b"):
        shapes[f] = (p,) + ang
    for f in ("t_torque_a", "t_ii_torque_a", "t_torque_b", "t_ii_torque_b"):
        shapes[f] = (p, s) + ang
    for f in ("n_rhs", "n_rhs_wo_bias", "n_impulse_jacobi", "n_r",
              "info_dist", "info_normal_vel"):
        shapes[f] = (p,)
    for f in ("t_rhs", "t_rhs_wo_bias", "t_impulse_jacobi"):
        shapes[f] = (p, s)
    import dataclasses

    for f in (fl.name for fl in dataclasses.fields(ContactConstraints)):
        if pre + f not in arrays:
            dt = np.int32 if f == "num_points" else np.float32
            arrays[pre + f] = np.zeros((c,) + shapes[f], dt)


def planar_state(case: str, i: int, device="cpu"):
    """The port's state ``s<i>`` of ``case``: the builder's scene with the
    stored JAX arrays laid over it."""
    from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays
    from wgmath_tpu_torch.scenes.builders import SCENES

    z = planar_arrays()
    base = state_to_arrays(SCENES[case_scene(case)](device="cpu"))
    pre = f"{case}.s{i}."
    arrays = dict(base)
    arrays.update({k[len(pre):]: v for k, v in z.items()
                   if k.startswith(pre)})
    _warmstart_fill(arrays, arrays["bodies.poses.translation"].shape[1])
    return state_from_arrays(arrays, device)


def expected(case: str, f: int) -> tuple:
    """(translations [N, 2], pair_count) after JAX's frame ``f`` (0-2) of
    ``case``."""
    z = planar_arrays()
    tr = (z[f"{case}.s{f + 1}.bodies.poses.translation"] if f < 2
          else z[f"{case}.ref.{f}.translation"])
    return tr, z[f"{case}.ref.{f}.pair_count"]


TR_LIMIT = 1e-5  # a body a frame, m
C14_LIMIT = 2e-2  # a body joined by contacts to a C14 row, m
WITNESS_TOL = 1e-5  # a stored JAX row against the witness (m; normal)


def _to_local(rot, t, x):
    """World points ``x`` [N, 2] in the frames (``rot`` = (cos, sin),
    ``t``)."""
    d = x - t
    return np.stack([rot[:, 0] * d[:, 0] + rot[:, 1] * d[:, 1],
                     -rot[:, 1] * d[:, 0] + rot[:, 0] * d[:, 1]], -1)


def _support(tag, par, rot, t, u):
    """Balls, cuboids and capsules (along local y): the support function
    [N, M] along world directions ``u`` [N, M, 2]."""
    lx = rot[:, 0, None] * u[..., 0] + rot[:, 1, None] * u[..., 1]
    ly = -rot[:, 1, None] * u[..., 0] + rot[:, 0, None] * u[..., 1]
    box = np.abs(lx) * par[:, 0, None] + np.abs(ly) * par[:, 1, None]
    cap = np.abs(ly) * par[:, 0, None] + par[:, 1, None]
    own = np.where((tag == BALL)[:, None], par[:, 0, None],
                   np.where((tag == CUBOID)[:, None], box, cap))
    return t[:, None, 0] * u[..., 0] + t[:, None, 1] * u[..., 1] + own


def _surface(tag, par, rot, t, u):
    """The farthest surface point [N, 2] along unit ``u`` [N, 2], and
    whether it is the only one (no face of the shape faces ``u`` within
    1e-6 of the support)."""
    eps = 1e-6
    lx = rot[:, 0] * u[:, 0] + rot[:, 1] * u[:, 1]
    ly = -rot[:, 1] * u[:, 0] + rot[:, 0] * u[:, 1]
    sx, sy = np.where(lx >= 0, 1.0, -1.0), np.where(ly >= 0, 1.0, -1.0)
    zero = np.zeros_like(lx)
    box = np.stack([sx * par[:, 0], sy * par[:, 1]], -1)
    cap = np.stack([zero, sy * par[:, 0]], -1)
    core = np.where((tag == CUBOID)[:, None], box,
                    np.where((tag == CAPSULE)[:, None], cap, 0.0))
    rad = np.where(tag == BALL, par[:, 0],
                   np.where(tag == CAPSULE, par[:, 1], 0.0))
    world = np.stack([rot[:, 0] * core[:, 0] - rot[:, 1] * core[:, 1],
                      rot[:, 1] * core[:, 0] + rot[:, 0] * core[:, 1]], -1)
    only = np.where(tag == CUBOID,
                    (np.abs(lx) > eps) & (np.abs(ly) > eps),
                    np.where(tag == CAPSULE, np.abs(ly) * par[:, 0] > eps,
                             True))
    return world + t + rad[:, None] * u, only


def witness_2d(tag_a, par_a, rot_a, t_a, tag_b, par_b, rot_b, t_b):
    """The exact contact of 2D balls, cuboids and capsules, in float64 and
    without GJK: the signed distance is the largest separation
    ``-h_A(u) - h_B(-u)`` over unit directions ``u`` (h the support
    function; the distance when apart, minus the penetration depth when
    overlapping), found on 4,096 angles and refined around the best eight
    times on a grid 16 times finer. Returns (dist [N], normal [N, 2] and
    point on A [N, 2] both local to A, whether that point is the only one:
    not so where a face of each shape faces the other)."""
    ta, tb = np.asarray(tag_a), np.asarray(tag_b)
    pa, ra, xa, pb, rb, xb = (np.asarray(v, np.float64) for v in (
        par_a, rot_a, t_a, par_b, rot_b, t_b))
    n = ta.shape[0]
    th = np.broadcast_to(np.arange(4096) * (2 * np.pi / 4096), (n, 4096))
    for _ in range(9):
        u = np.stack([np.cos(th), np.sin(th)], -1)
        sep = -_support(ta, pa, ra, xa, u) - _support(tb, pb, rb, xb, -u)
        best = th[np.arange(n), sep.argmax(1)]
        step = th[:, 1] - th[:, 0]
        th = best[:, None] + step[:, None] * np.linspace(-2.0, 2.0, 65)
    u = np.stack([np.cos(best), np.sin(best)], -1)
    dist = (-_support(ta, pa, ra, xa, u[:, None])
            - _support(tb, pb, rb, xb, -u[:, None]))[:, 0]
    on_a, only_a = _surface(ta, pa, ra, xa, u)
    on_b, only_b = _surface(tb, pb, rb, xb, -u)
    point = np.where(only_a[:, None], on_a, on_b - dist[:, None] * u)
    normal = _to_local(ra, np.zeros_like(xa), u)
    return dist, normal, _to_local(ra, xa, point), only_a | only_b


def support_rows(case: str, f: int, state) -> dict:
    """The stored JAX narrow-phase rows of frame ``f`` (``<case>.np<f>``,
    the export's) between support-mapped shapes in live pair slots, with
    the witness (:func:`witness_2d`) on the same state: ``rows`` their
    slots; JAX's and the witness's ``dist`` / ``normal`` / ``point``;
    ``c14`` where JAX's row leaves the witness by more than
    ``WITNESS_TOL`` in distance or normal, or in a point that is the only
    one (ROADMAP C14)."""
    z = planar_arrays()
    pre = f"{case}.np{f}."
    a, b = (z[pre + k].astype(np.int64) for k in ("body_a", "body_b"))
    tag = state.shapes.tag.cpu().numpy()
    par = state.shapes.params.cpu().numpy()
    rot = state.bodies.poses.rotation.cpu().numpy()
    tr = state.bodies.poses.translation.cpu().numpy()
    ta, tb = tag[a], tag[b]
    analytic = (((ta == BALL) | (ta == CUBOID))
                & ((tb == BALL) | (tb == CUBOID)))
    live = np.arange(a.shape[0]) < expected(case, f)[1][0]
    rows = np.nonzero(live & ~analytic & (ta <= CAPSULE)
                      & (tb <= CAPSULE))[0]
    a, b = a[rows], b[rows]
    dist, normal, point, only = witness_2d(
        tag[a], par[a], rot[a], tr[a], tag[b], par[b], rot[b], tr[b])
    jax = {k: z[pre + k][rows] for k in ("dist", "normal", "point")}
    off = ((np.abs(jax["dist"] - dist) > WITNESS_TOL)
           | (np.abs(jax["normal"] - normal).max(1) > WITNESS_TOL)
           | (only & (np.abs(jax["point"] - point).max(1) > WITNESS_TOL)))
    return {"rows": rows, "jax": jax, "dist": dist, "normal": normal,
            "point": point, "only": only, "c14": off}


def c14_bodies(case: str, f: int, state) -> tuple:
    """The dynamic bodies a frame's solve joins to a C14 row (the rows'
    own, and those in contact with them through other dynamic bodies)
    and JAX's contact count with the witness's validity on the C14 rows.
    (mask [N], contacts); no body and JAX's count for a case without
    stored rows."""
    z = planar_arrays()
    n = state.bodies.poses.translation.shape[0]
    contacts = int(expected(case, f)[1][1])
    if f"{case}.np{f}.dist" not in z:
        return np.zeros(n, bool), contacts
    sr = support_rows(case, f, state)
    pre = f"{case}.np{f}."
    valid = z[pre + "valid"].copy()
    pred = params_of("default").prediction_distance
    c14 = sr["rows"][sr["c14"]]
    valid[c14] = sr["dist"][sr["c14"]] < pred
    a, b = (z[pre + k].astype(np.int64) for k in ("body_a", "body_b"))
    dyn = state.bodies.is_dynamic().cpu().numpy()
    link = (valid | z[pre + "valid"]) & dyn[a] & dyn[b]
    mask = np.zeros(n, bool)
    for i in c14:
        mask[[x for x in (a[i], b[i]) if dyn[x]]] = True
    while True:  # spread along the contacts between dynamic bodies
        grown = mask.copy()
        grown[b[link & mask[a]]] = True
        grown[a[link & mask[b]]] = True
        if np.array_equal(grown, mask):
            break
        mask = grown
    return mask, int(valid.sum())


def frame_errors(case: str, f: int, state, new) -> dict:
    """The figures frame ``f`` of ``case`` (``new``, stepped from
    ``state``) is held to: ``counts_ok`` (every count JAX's; where
    C14 rows lie, the pairs and broad-phase path JAX's and the contacts
    :func:`c14_bodies`'s), the largest error of the bodies off C14
    (``max_dx``) and on it (``max_dx_c14``), and how many C14 bodies."""
    tr, pc = expected(case, f)
    got = new.pair_count.cpu().numpy()
    c14, contacts = c14_bodies(case, f, state)
    err = np.abs(new.bodies.poses.translation.cpu().numpy() - tr).max(1)
    if c14.any():
        counts_ok = (got[0] == pc[0] and got[3] == pc[3]
                     and got[1] == contacts)
    else:
        counts_ok = bool(np.array_equal(got, pc))
    return {"counts_ok": bool(counts_ok), "pairs": int(got[0]),
            "contacts": int(got[1]), "max_dx": float(err[~c14].max()),
            "c14_bodies": int(c14.sum()),
            "max_dx_c14": float(err[c14].max()) if c14.any() else 0.0}


def frame_ok(m: dict) -> bool:
    return (m["counts_ok"] and m["max_dx"] <= TR_LIMIT
            and m["max_dx_c14"] <= C14_LIMIT)
