"""Independent CPU physics oracle: a hand-rolled float64 numpy TGS-soft
rigid-body solver, structurally unrelated to the port's pipeline
(counterpart of ``wgmath_tpu/testbed/oracle.py``, whose engine this is, the
same code; :func:`bodies_from_state` reads this package's tensors).

It mirrors the contract of the solver the JAX package was modelled on
(the constraint update, warmstart, Gauss-Seidel step and integration, the
CFM / ERP softness, locked linear joint axes and their orthogonalization)
with scalar Python loops, sequential Gauss-Seidel (no colouring) and
float64 throughout: a different computation whose agreement validates
the physics, not the port. The testbed's ``--backend oracle`` runs a scene
on it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

TWO_PI = 2.0 * math.pi
MAX = 3.4e38


@dataclasses.dataclass
class OracleParams:
    dt: float = 1.0 / 60.0
    contact_damping_ratio: float = 5.0
    contact_natural_frequency: float = 30.0
    joint_natural_frequency: float = 1.0e6
    joint_damping_ratio: float = 1.0
    warmstart_coefficient: float = 1.0
    allowed_linear_error: float = 0.001
    max_corrective_velocity: float = 10.0
    prediction_distance: float = 0.002
    num_solver_iterations: int = 4
    gravity: tuple = (0.0, -9.81, 0.0)
    friction: float = 0.5
    restitution: float = 0.0

    # -- soft-constraint derivation (sim_params.wgsl:109-199) -----------------
    def contact_erp_inv_dt(self, dt):
        w = self.contact_natural_frequency * TWO_PI
        return w / (dt * w + 2.0 * self.contact_damping_ratio)

    def contact_cfm_factor(self, dt):
        erp = dt * self.contact_erp_inv_dt(dt)
        if erp == 0.0:
            return 0.0
        inv_erp_m1 = 1.0 / erp - 1.0
        cfm_coeff = inv_erp_m1 * inv_erp_m1 / (
            (1.0 + inv_erp_m1) * 4.0 * self.contact_damping_ratio ** 2)
        return 1.0 / (1.0 + cfm_coeff)

    def joint_erp_inv_dt(self, dt):
        w = self.joint_natural_frequency * TWO_PI
        return w / (dt * w + 2.0 * self.joint_damping_ratio)

    def joint_cfm_coeff(self, dt):
        erp = dt * self.joint_erp_inv_dt(dt)
        if erp == 0.0:
            return 0.0
        inv_erp_m1 = 1.0 / erp - 1.0
        return inv_erp_m1 * inv_erp_m1 / (
            (1.0 + inv_erp_m1) * 4.0 * self.joint_damping_ratio ** 2)


# -- minimal f64 quaternion algebra (x, y, z, w) ------------------------------


def qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by + ay * bw + az * bx - ax * bz,
        aw * bz + az * bw + ax * by - ay * bx,
        aw * bw - ax * bx - ay * by - az * bz,
    ])


def qrot(q, v):
    u = q[:3]
    w = q[3]
    return v + 2.0 * np.cross(u, np.cross(u, v) + w * v)


def qinv(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def qexp(w_dt):
    th = np.linalg.norm(w_dt)
    if th < 1e-12:
        return np.array([0.5 * w_dt[0], 0.5 * w_dt[1], 0.5 * w_dt[2], 1.0])
    axis = w_dt / th
    s = math.sin(th / 2.0)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s,
                     math.cos(th / 2.0)])


def qnorm(q):
    return q / np.linalg.norm(q)


def qmat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


# -- bodies -------------------------------------------------------------------


@dataclasses.dataclass
class OracleBody:
    pos: np.ndarray  # [3]
    rot: np.ndarray  # quat [4]
    linvel: np.ndarray  # [3]
    angvel: np.ndarray  # [3]
    inv_mass: np.ndarray  # [3] per-axis
    inv_inertia_principal: np.ndarray  # [3] (diagonal local inertia)
    shape: str  # "ball" | "box"
    size: np.ndarray  # ball: [r]; box: half extents [3]
    # one-way coupling (≙ BodyCoupling::OneWay, body.rs:169-192): zero
    # inverse mass but the prescribed velocity is kept through the solve
    # and integrates the pose (matches wgmath_tpu Bodies.kinematic)
    kinematic: bool = False

    @property
    def dynamic(self):
        return bool(np.any(self.inv_mass != 0.0))

    def world_inv_inertia(self):
        r = qmat(self.rot)
        return r @ np.diag(self.inv_inertia_principal) @ r.T


def ball_body(pos, radius, density=1.0, static=False):
    mass = density * 4.0 / 3.0 * math.pi * radius ** 3
    inertia = 0.4 * mass * radius ** 2
    im = 0.0 if static else 1.0 / mass
    ii = 0.0 if static else 1.0 / inertia
    return OracleBody(np.asarray(pos, float), np.array([0.0, 0, 0, 1]),
                      np.zeros(3), np.zeros(3), np.full(3, im),
                      np.full(3, ii), "ball", np.array([radius], float))


def box_body(pos, half_extents, density=1.0, static=False):
    he = np.asarray(half_extents, float)
    s = 2.0 * he
    mass = density * s[0] * s[1] * s[2]
    inertia = mass / 12.0 * np.array([s[1] ** 2 + s[2] ** 2,
                                      s[0] ** 2 + s[2] ** 2,
                                      s[0] ** 2 + s[1] ** 2])
    im = 0.0 if static else 1.0 / mass
    ii = np.zeros(3) if static else 1.0 / inertia
    return OracleBody(np.asarray(pos, float), np.array([0.0, 0, 0, 1]),
                      np.zeros(3), np.zeros(3), np.full(3, im), ii,
                      "box", he)


# -- contact detection (single-point manifolds, exact analytic) ---------------


def _ball_ball_contact(a: OracleBody, b: OracleBody, prediction):
    delta = b.pos - a.pos
    d = np.linalg.norm(delta)
    ra, rb = a.size[0], b.size[0]
    dist = d - ra - rb
    if dist >= prediction:
        return None
    n = delta / d if d > 1e-12 else np.array([0.0, 1.0, 0.0])
    pt = a.pos + n * ra  # on A's surface, world
    return n, pt, dist


def _ball_box_contact(ball: OracleBody, box: OracleBody, prediction):
    """World normal box→ball is built, then reoriented to A→B by caller."""
    r_m = qmat(box.rot)
    local = r_m.T @ (ball.pos - box.pos)
    he = box.size
    clamped = np.clip(local, -he, he)
    if np.all(np.abs(local) < he):  # center inside: push along least axis
        ax = int(np.argmin(he - np.abs(local)))
        sign = 1.0 if local[ax] >= 0 else -1.0
        n_local = np.zeros(3)
        n_local[ax] = sign
        dist = -(he[ax] - abs(local[ax])) - ball.size[0]
        p_local = clamped.copy()
        p_local[ax] = sign * he[ax]
    else:
        delta = local - clamped
        d = np.linalg.norm(delta)
        n_local = delta / d
        dist = d - ball.size[0]
        p_local = clamped
    if dist >= prediction:
        return None
    n_w = r_m @ n_local  # box → ball
    pt_ball = ball.pos - n_w * ball.size[0]
    return n_w, pt_ball, dist


def collect_contacts(bodies, prediction):
    """(ia, ib, n_w A→B, point-on-A world, dist) per touching pair."""
    out = []
    n = len(bodies)
    for i in range(n):
        for j in range(i + 1, n):
            a, b = bodies[i], bodies[j]
            if not (a.dynamic or b.dynamic):
                continue
            if a.shape == "ball" and b.shape == "ball":
                c = _ball_ball_contact(a, b, prediction)
                if c:
                    out.append((i, j) + c)
            elif a.shape == "ball" and b.shape == "box":
                c = _ball_box_contact(a, b, prediction)
                if c:  # n_w is box→ball = B→A; flip to A→B
                    n_w, pt, dist = c
                    out.append((i, j, -n_w, pt, dist))
            elif a.shape == "box" and b.shape == "ball":
                c = _ball_box_contact(b, a, prediction)
                if c:
                    n_w, pt_ball, dist = c
                    # A = box: normal A→B = box→ball = n_w; point on box
                    pt_box = pt_ball - n_w * dist
                    out.append((i, j, n_w, pt_box, dist))
    return out


# -- constraints (solver.wgsl:701-832 semantics, f64 scalars) -----------------


class ContactConstraint:
    def __init__(self, ia, ib, n_w, pt_a, dist, bodies, p: OracleParams,
                 dt_sub):
        a, b = bodies[ia], bodies[ib]
        self.ia, self.ib = ia, ib
        self.force_dir = -n_w  # force on A (pushes A away from B)
        pt = pt_a + n_w * dist / 2.0  # builder midpoint convention
        com_a, com_b = a.pos, b.pos  # com offset is 0 for ball/box here
        self.dp1 = pt - com_a
        self.dp2 = pt - com_b
        ii_a = a.world_inv_inertia()
        ii_b = b.world_inv_inertia()
        im = a.inv_mass + b.inv_mass
        d = self.force_dir
        self.td_a = np.cross(self.dp1, d)
        self.td_b = np.cross(self.dp2, -d)
        self.iitd_a = ii_a @ self.td_a
        self.iitd_b = ii_b @ self.td_b
        r = (d @ (im * d) + self.iitd_a @ self.td_a + self.iitd_b @ self.td_b)
        self.r = 1.0 / r if r != 0.0 else 0.0
        cvel1 = a.linvel + np.cross(a.angvel, self.dp1)
        cvel2 = b.linvel + np.cross(b.angvel, self.dp2)
        self.rhs_wo_bias0 = (p.restitution * (cvel1 - cvel2) @ d
                             + max(dist, 0.0) / dt_sub)
        self.dist0 = dist
        # friction basis from relative velocity (tangent_directions)
        rel = a.linvel - b.linvel
        t = rel - d * (d @ rel)
        nt = np.linalg.norm(t)
        if nt < 1e-4:
            sign = 1.0 if d[2] >= 0 else -1.0
            ainv = -1.0 / (sign + d[2])
            bb = d[0] * d[1] * ainv
            t1 = np.array([bb, sign + d[1] ** 2 * ainv, -d[1]])
        else:
            t1 = t / nt
        t2 = np.cross(d, t1)
        self.tangents = [t1, t2]
        self.t_td_a = [np.cross(self.dp1, tj) for tj in self.tangents]
        self.t_td_b = [np.cross(self.dp2, -tj) for tj in self.tangents]
        self.t_iitd_a = [ii_a @ x for x in self.t_td_a]
        self.t_iitd_b = [ii_b @ x for x in self.t_td_b]
        t_r = [tj @ (im * tj) + iia @ ta + iib @ tb
               for tj, ta, tb, iia, iib in zip(
                   self.tangents, self.t_td_a, self.t_td_b,
                   self.t_iitd_a, self.t_iitd_b)]
        r_cross = 2.0 * (self.t_td_a[0] @ self.t_iitd_a[1]
                         + self.t_td_b[0] @ self.t_iitd_b[1])
        self.t_r = t_r + [r_cross]
        self.im_a, self.im_b = a.inv_mass, b.inv_mass
        # local anchors for relinearization
        self.lpa = qrot(qinv(a.rot), pt - a.pos)
        self.lpb = qrot(qinv(b.rot), pt - b.pos)
        self.n_imp = 0.0
        self.t_imp = np.zeros(2)
        self.n_rhs = 0.0
        self.t_rhs = np.zeros(2)
        self.rhs_wo_bias = 0.0

    def key(self):
        return (self.ia, self.ib)

    def relinearize(self, bodies, p: OracleParams, dt_sub):
        """update_constraints (solver.wgsl:103-170)."""
        a, b = bodies[self.ia], bodies[self.ib]
        p1 = a.pos + qrot(a.rot, self.lpa)
        p2 = b.pos + qrot(b.rot, self.lpb)
        dist = self.dist0 + (p1 - p2) @ self.force_dir
        rhs_wo_bias = self.rhs_wo_bias0 + max(dist, 0.0) / dt_sub
        erp_inv_dt = p.contact_erp_inv_dt(dt_sub)
        rhs_bias = np.clip((dist + p.allowed_linear_error) * erp_inv_dt,
                           -p.max_corrective_velocity, 0.0)
        self.n_rhs = rhs_wo_bias + rhs_bias
        self.rhs_wo_bias = rhs_wo_bias
        drift = p1 - p2
        self.t_rhs = np.array([drift @ t / dt_sub for t in self.tangents])
        self.t_rhs_wo_bias = np.zeros(2)

    def warmstart(self, bodies):
        """Apply stored impulses to body velocities (warmstart:464-524)."""
        a, b = bodies[self.ia], bodies[self.ib]
        d = self.force_dir
        imp = self.n_imp
        a.linvel = a.linvel + d * (self.im_a * imp)
        a.angvel = a.angvel + self.iitd_a * imp
        b.linvel = b.linvel - d * (self.im_b * imp)
        b.angvel = b.angvel + self.iitd_b * imp
        for j in range(2):
            timp = self.t_imp[j]
            tj = self.tangents[j]
            a.linvel = a.linvel + tj * (self.im_a * timp)
            a.angvel = a.angvel + self.t_iitd_a[j] * timp
            b.linvel = b.linvel - tj * (self.im_b * timp)
            b.angvel = b.angvel + self.t_iitd_b[j] * timp

    def solve(self, bodies, cfm, friction, biased=True):
        """One sequential GS update (step_gauss_seidel:551-660)."""
        a, b = bodies[self.ia], bodies[self.ib]
        d = self.force_dir
        rhs = self.n_rhs if biased else self.rhs_wo_bias
        dvel = (d @ a.linvel + self.td_a @ a.angvel
                - d @ b.linvel + self.td_b @ b.angvel + rhs)
        new_imp = cfm * max(self.n_imp - self.r * dvel, 0.0)
        di = new_imp - self.n_imp
        self.n_imp = new_imp
        a.linvel = a.linvel + d * (self.im_a * di)
        a.angvel = a.angvel + self.iitd_a * di
        b.linvel = b.linvel - d * (self.im_b * di)
        b.angvel = b.angvel + self.iitd_b * di
        limit = new_imp * friction
        # coupled 2-tangent friction update
        dv = []
        for j in range(2):
            tj = self.tangents[j]
            t_rhs = self.t_rhs[j] if biased else 0.0
            dv.append(tj @ a.linvel + self.t_td_a[j] @ a.angvel
                      - tj @ b.linvel + self.t_td_b[j] @ b.angvel + t_rhs)
        d0, d1 = dv
        d00, d11, d01 = d0 * d0, d1 * d1, d0 * d1
        denom = d00 * self.t_r[0] + d11 * self.t_r[1] + d01 * self.t_r[2]
        inv_lhs = (d00 + d11) / denom if abs(denom) > 1e-20 else 0.0
        delta = np.array([inv_lhs * d0, inv_lhs * d1])
        cand = self.t_imp - delta
        nc = np.linalg.norm(cand)
        if nc > limit:
            cand = cand * (limit / nc if nc > 1e-30 else 0.0)
        dl = cand - self.t_imp
        self.t_imp = cand
        lin = self.tangents[0] * dl[0] + self.tangents[1] * dl[1]
        a.linvel = a.linvel + lin * self.im_a
        a.angvel = (a.angvel + self.t_iitd_a[0] * dl[0]
                    + self.t_iitd_a[1] * dl[1])
        b.linvel = b.linvel - lin * self.im_b
        b.angvel = (b.angvel + self.t_iitd_b[0] * dl[0]
                    + self.t_iitd_b[1] * dl[1])


# -- spherical joint (locked linear axes; joint_constraint_builder.wgsl) ------


class SphericalJoint:
    """Locked 3 linear axes between anchor points (frames at identity
    rotation): slots ≙ linear locks 9-11 with Gram-Schmidt elimination."""

    def __init__(self, ia, ib, anchor_a, anchor_b):
        self.ia, self.ib = ia, ib
        self.la = np.asarray(anchor_a, float)
        self.lb = np.asarray(anchor_b, float)
        self.imp = np.zeros(3)

    def build(self, bodies, p: OracleParams, dt_sub):
        a, b = bodies[self.ia], bodies[self.ib]
        f1 = a.pos + qrot(a.rot, self.la)
        f2 = b.pos + qrot(b.rot, self.lb)
        basis = qmat(a.rot)  # joint axes = frame1 axes (identity local rot)
        lin_err = f2 - f1
        # anchor snapped along locked axes → t1 = f1; r1/r2 about coms
        r1 = f1 - a.pos
        r2 = f2 - b.pos
        ii_a = a.world_inv_inertia()
        ii_b = b.world_inv_inertia()
        im = a.inv_mass + b.inv_mass
        erp_inv_dt = p.joint_erp_inv_dt(dt_sub)
        cfm_coeff = p.joint_cfm_coeff(dt_sub)
        rows = []
        for i in range(3):
            lj = basis[:, i]
            aa = np.cross(r1, lj)
            ab = np.cross(r2, lj)
            rhs_bias = (lj @ lin_err) * erp_inv_dt
            rows.append(dict(lj=lj, aa=aa, ab=ab, rhs=rhs_bias, rhs_wo=0.0,
                             cfm_coeff=cfm_coeff, cfm_gain=0.0,
                             iia=ii_a @ aa, iib=ii_b @ ab))
        # orthogonalize (unbounded slots eliminate into later rows)
        for j in range(3):
            rj = rows[j]
            dot_jj = (rj["lj"] @ (im * rj["lj"]) + rj["iia"] @ rj["aa"]
                      + rj["iib"] @ rj["ab"])
            new_gain = dot_jj * rj["cfm_coeff"] + rj["cfm_gain"]
            inv_dot_jj = 1.0 / dot_jj if abs(dot_jj) > 1e-20 else 0.0
            rj["inv_lhs"] = (1.0 / (dot_jj + new_gain)
                             if abs(dot_jj + new_gain) > 1e-20 else 0.0)
            rj["cfm_gain"] = new_gain
            for i2 in range(j + 1, 3):
                ri = rows[i2]
                dot_ij = (ri["lj"] @ (im * rj["lj"]) + ri["iia"] @ rj["aa"]
                          + ri["iib"] @ rj["ab"])
                coeff = dot_ij * inv_dot_jj
                for k_ in ("lj", "aa", "ab", "iia", "iib"):
                    ri[k_] = ri[k_] - rj[k_] * coeff
                ri["rhs"] = ri["rhs"] - rj["rhs"] * coeff
                ri["rhs_wo"] = ri["rhs_wo"] - rj["rhs_wo"] * coeff
        self.rows = rows
        self.im_a, self.im_b = a.inv_mass, b.inv_mass
        # rebuilt constraints start from zero impulse each substep (the
        # biased→unbiased pair within a substep shares the accumulator)
        self.imp = np.zeros(3)

    def solve(self, bodies, biased=True):
        a, b = bodies[self.ia], bodies[self.ib]
        for s, row in enumerate(self.rows):
            dlin = row["lj"] @ (b.linvel - a.linvel)
            dang = row["ab"] @ b.angvel - row["aa"] @ a.angvel
            total = dlin + dang + (row["rhs"] if biased else row["rhs_wo"])
            new_imp = self.imp[s] + row["inv_lhs"] * (
                total - row["cfm_gain"] * self.imp[s])
            d = new_imp - self.imp[s]
            self.imp[s] = new_imp
            lin = row["lj"] * d
            a.linvel = a.linvel + lin * self.im_a
            a.angvel = a.angvel + row["iia"] * d
            b.linvel = b.linvel - lin * self.im_b
            b.angvel = b.angvel - row["iib"] * d


# -- the full frame step (pipeline ≙ solver.rs:238-460 sequence) --------------


def oracle_step(bodies, p: OracleParams, joints=(), prev_impulses=None):
    """One frame: detect contacts, build constraints, TGS-soft solve with
    ``num_solver_iterations`` substeps × (biased + unbiased) sequential GS.
    Returns the impulse map for next-frame warmstarting."""
    dt_sub = p.dt / p.num_solver_iterations
    contacts = collect_contacts(bodies, p.prediction_distance)
    cons = [ContactConstraint(ia, ib, n, pt, dist, bodies, p, dt_sub)
            for ia, ib, n, pt, dist in contacts]
    if prev_impulses:
        for c in cons:
            if c.key() in prev_impulses:
                ni, ti = prev_impulses[c.key()]
                c.n_imp = ni * p.warmstart_coefficient
                c.t_imp = ti * p.warmstart_coefficient
    # statics start from zero velocity (solver.wgsl cleanup:194-208);
    # kinematic bodies KEEP their prescribed velocity (one-way coupling)
    for b in bodies:
        if not b.dynamic and not b.kinematic:
            b.linvel = np.zeros(3)
            b.angvel = np.zeros(3)
    g = np.asarray(p.gravity, float)
    cfm = p.contact_cfm_factor(dt_sub)
    for _ in range(p.num_solver_iterations):
        for b in bodies:
            if b.dynamic:
                b.linvel = b.linvel + g * dt_sub
        for c in cons:
            c.relinearize(bodies, p, dt_sub)
            c.n_imp *= p.warmstart_coefficient
            c.t_imp = c.t_imp * p.warmstart_coefficient
            c.warmstart(bodies)
        for j in joints:
            j.build(bodies, p, dt_sub)
            j.solve(bodies, biased=True)
        for c in cons:
            c.solve(bodies, cfm, p.friction, biased=True)
        # integrate (body.wgsl integrateVelocity; com == pos for ball/box)
        for b in bodies:
            if b.dynamic or b.kinematic:
                b.pos = b.pos + b.linvel * dt_sub
                b.rot = qnorm(qmul(qexp(b.angvel * dt_sub), b.rot))
        for j in joints:
            j.solve(bodies, biased=False)
        for c in cons:
            c.solve(bodies, 1.0, p.friction, biased=False)
    return {c.key(): (c.n_imp, c.t_imp.copy()) for c in cons}


# -- live independent-engine backend (≙ backend/cpu.rs:27) --------------------


def bodies_from_state(state):
    """Oracle bodies of a ``pipeline.PhysicsState`` (balls and cuboids;
    other shapes have no oracle kernels and raise), read from its tensors
    on whatever device they lie."""
    from wgmath_tpu_torch.shapes import shape as shp

    def host(x, dtype=None):
        a = x.detach().cpu().numpy()
        return a if dtype is None else a.astype(dtype)

    tag = host(state.shapes.tag)
    prm = host(state.shapes.params)
    pos = host(state.bodies.poses.translation, np.float64)
    rot = host(state.bodies.poses.rotation, np.float64)
    linv = host(state.bodies.vels.linear, np.float64)
    angv = host(state.bodies.vels.angular, np.float64)
    im = host(state.bodies.local_mprops.inv_mass, np.float64)
    ii = host(state.bodies.local_mprops.inv_principal_inertia, np.float64)
    kin = host(state.bodies.is_kinematic())
    if pos.shape[-1] != 3:
        raise NotImplementedError("oracle backend is 3D-only")
    out = []
    for i in range(pos.shape[0]):
        if tag[i] == shp.BALL:
            shape, size = "ball", np.array([prm[i, 0]])
        elif tag[i] == shp.CUBOID:
            shape, size = "box", prm[i, :3].astype(np.float64)
        else:
            raise NotImplementedError(
                f"oracle backend supports ball/cuboid only (tag {tag[i]})")
        out.append(OracleBody(pos[i].copy(), rot[i].copy(), linv[i].copy(),
                              angv[i].copy(), im[i].copy(), ii[i].copy(),
                              shape, size, kinematic=bool(kin[i])))
    return out


def run_oracle_backend(state, frames: int, *, params=None, on_frame=None):
    """Step ``frames`` of the f64 oracle engine from a PhysicsState.

    Returns the final (positions, rotations). ``on_frame(f, bodies)`` is
    the render/stats hook."""
    if state.joints is not None:
        raise NotImplementedError(
            "oracle backend does not solve the joint pytree (use the "
            "oracle's SphericalJoint API directly in tests)")
    p = params or OracleParams()
    bodies = bodies_from_state(state)
    prev = None
    for f in range(frames):
        prev = oracle_step(bodies, p, prev_impulses=prev)
        if on_frame is not None:
            on_frame(f, bodies)
    return (np.stack([b.pos for b in bodies]),
            np.stack([b.rot for b in bodies]))
