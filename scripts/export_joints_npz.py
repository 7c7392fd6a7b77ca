"""Export the JAX package's jointed frames as a JAX-free ``.npz``:
``artifacts/joints_jax.npz``, read by ``tests/test_torch_pipeline_joints.py``
and ``chip_smoke.py``.

Cases (``<case>.*``):

- ``joint_ball3``, ``joint_revolute3``, ``joint_fixed3``,
  ``joint_prismatic3``: the four chains of ``SCENES`` under
  ``tests/test_joints.py``'s ``CFG``, warmed by 20 ``step_checked``
  frames;
- ``drape_ladder``, ``drape_chained_rr``, ``drape_chained_ps``:
  ``tests/test_joints.py``'s drape scene (a five-ball chain anchored 1.2 m
  up over a ground slab) under that test's three configurations, warmed by
  40 frames (``step``, no warmstart on the first, as the test steps it),
  by when the free end rests on the ground;
- ``net16``: ``ball_net3(16, 16)`` (``SCENES["ball_net3"]``) under the
  windowless default (``PipelineConfig()``: colouring in
  the solve, uniform windows), warmed by 40 frames, onto the dome;
- ``unit`` (``tests/test_torch_joint.py``): that file's 68 mixed joints
  over 40 seeded bodies (``_mixed_arrays``, ``_world``): the set
  (``unit.joints.*``), ``build_joint_constraints`` at the default
  substep (``unit.cons.*``) and two ``joint_gs_pass`` with
  ``max_colors`` 8, the second after ``remove_joint_bias``
  (``unit.pass.{linear,angular,impulse}{1,2}``), each one jitted call;
- ``net100``: ``ball_net3(100, 100)`` (10,002 bodies, 19,800 spherical
  joints) after ``scripts/run_jointed10k.py``'s drape configuration for
  ``NET_DRAPE`` frames (the net reaches the dome at about frame 36):
  ``net100.drape.*`` (its solve bundle dropped), ``net100.joints.*``,
  ``net100.drape_config_json``, ``net100.params_json``;
  ``net100_ladder``, ``net100_chained_ps``: that script's ``ladder`` /
  ``chained_ps`` steady configuration with the ladder regrown by 6
  ``step_checked`` frames from the drape state (``<case>.config_json``),
  then ``NET_RUN`` ``step_checked`` frames from the drape state under it:
  the first frame's ``translation``, ``pair_count`` and ``config_json``
  (``<case>.ref.0.*``) and the largest joint stretch (distance between a
  joint's two world anchors) after each frame (``<case>.stretch``).

Each small case keeps its warmed state (``<case>.warmed.*``,
``state_to_arrays`` names without the joints), its joints once
(``<case>.joints.*``), the configuration (``<case>.config_json``), its
``SimParams`` as JSON (``<case>.params_json``), and the next 3
``step_checked`` frames
(``<case>.ref.<f>.{translation,linear,angular,pair_count,config_json}``);
the states after frames 0 and 1 are kept whole (``<case>.ref.<f>.state.*``)
so that each frame can start from JAX's state before it. A 10k state is
~0.5 MB compressed, so the net keeps one. The fields of
``prev_constraints`` a step does not read are zeros
(``export_box_npz.slim``). Reals are float32, integers int32.

Runs on the CPU, the small cases, the unit case and the two 10k
configurations in four processes at once::

    JAX_PLATFORMS=cpu python scripts/export_joints_npz.py [--only GROUP]

``--only`` rewrites one group's cases and keeps the file's others.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from export_box_npz import slim  # noqa: E402
from wgmath_tpu.dynamics import SimParams  # noqa: E402
from wgmath_tpu.pipeline import (  # noqa: E402
    PipelineConfig,
    auto_manifold_points,
    fine_bucket,
    step,
    step_checked,
)
from wgmath_tpu.scenes import builders  # noqa: E402
from wgmath_tpu_torch.convert import (  # noqa: E402
    joints_to_arrays,
    state_to_arrays,
)

OUT = os.path.join(ROOT, "artifacts", "joints_jax.npz")
REF_FRAMES = 3
CHAIN_WARM = 20
DRAPE_WARM = 40
NET16_WARM = 40
NET_DRAPE = 60
NET_REGROW = 6
NET_RUN = 20
# tests/test_joints.py's CFG and its drape test's base configuration
CHAIN_CFG = dict(pair_capacity=64, max_colors=8, broad_phase_block=64)
DRAPE_BASE = dict(pair_capacity=128, contact_capacity=64, max_colors=4,
                  manifold_points=1, bp_algo="grid", bp_slack=0.03,
                  gs_cmax=64, gs_windows=(64,) * 4, broad_phase_block=64)
DRAPE_CFGS = {
    "ladder": DRAPE_BASE,
    "chained_rr": dict(DRAPE_BASE, gs_chained=True, gs_rhs_in_rung=True),
    "chained_ps": dict(DRAPE_BASE, gs_chained=True, gs_rhs_in_rung=True,
                       gs_pair_slots=True),
}
NET16_CFG = {}  # PipelineConfig()'s defaults
CHAINS = ("joint_ball3", "joint_revolute3", "joint_fixed3",
          "joint_prismatic3")


def _json(x) -> np.ndarray:
    return np.asarray(json.dumps(dataclasses.asdict(x)))


def _put_state(arrays: dict, prefix: str, state) -> None:
    for k, v in state_to_arrays(state).items():
        if not k.startswith("joints."):
            arrays[f"{prefix}.{k}"] = v


def joint_stretch(state) -> float:
    """The largest distance between a joint's two world anchors."""
    from wgmath_tpu.geometry import sim as sim_ops

    j, p = state.joints, state.bodies.poses

    def anchor(body, frame):
        pose = sim_ops.Sim(p.rotation[body], p.translation[body],
                           p.scale[body])
        return sim_ops.mul_pt(pose, frame.translation)

    d = anchor(j.body_a, j.local_frame_a) - anchor(j.body_b, j.local_frame_b)
    return float(jnp.max(jnp.linalg.norm(d, axis=-1)))


def export_case(name: str, state, params, cfg, arrays: dict,
                t0: float) -> None:
    """The warmed ``state`` under ``cfg`` and the next frames."""
    arrays[f"{name}.config_json"] = _json(cfg)
    arrays[f"{name}.params_json"] = _json(params)
    for k, v in state_to_arrays(state).items():
        if k.startswith("joints."):
            arrays[f"{name}.{k}"] = v
    _put_state(arrays, f"{name}.warmed", state)
    st, c = state, cfg
    for f in range(REF_FRAMES):
        st, c = step_checked(st, params, c)
        p = f"{name}.ref.{f}"
        if f < REF_FRAMES - 1:
            _put_state(arrays, f"{p}.state", st)
        b = st.bodies
        arrays[f"{p}.translation"] = np.asarray(b.poses.translation)
        arrays[f"{p}.linear"] = np.asarray(b.vels.linear)
        arrays[f"{p}.angular"] = np.asarray(b.vels.angular)
        arrays[f"{p}.pair_count"] = np.asarray(st.pair_count, np.int32)
        arrays[f"{p}.config_json"] = _json(c)
    print(f"{name}: ref pair_count {np.asarray(st.pair_count)[:5].tolist()}"
          f" stretch {joint_stretch(st):.3e} ({time.time() - t0:.0f} s)",
          flush=True)


def drape_scene():
    """tests/test_joints.py's drape scene: a ground slab, then a five-ball
    chain whose first ball is static 1.2 m up."""
    from wgmath_tpu.dynamics import (
        Bodies,
        Velocity,
        ball_local_mprops,
        cuboid_local_mprops,
    )
    from wgmath_tpu.dynamics.body import LocalMassProperties
    from wgmath_tpu.dynamics.joint import spherical_joints
    from wgmath_tpu.geometry import sim as sim_ops
    from wgmath_tpu.pipeline import new_state
    from wgmath_tpu.shapes import ShapeSet

    n_links, r = 4, 0.2
    n = n_links + 2
    shapes = ShapeSet.concat(
        ShapeSet.cuboids(jnp.asarray([[10.0, 0.5, 10.0]])),
        ShapeSet.balls(jnp.full((n_links + 1,), r)))
    trans = np.zeros((n, 3), np.float32)
    trans[0] = (0.0, -0.5, 0.0)
    trans[1] = (0.0, 1.2, 0.0)
    for i in range(n_links):
        trans[2 + i] = ((i + 1) * 0.5, 1.2, 0.0)
    poses = sim_ops.from_parts(jnp.tile(jnp.asarray([0.0, 0, 0, 1]), (n, 1)),
                               jnp.asarray(trans))
    dynamic = np.ones(n, bool)
    dynamic[:2] = False
    gm = cuboid_local_mprops(jnp.asarray([[10.0, 0.5, 10.0]]),
                             dynamic=jnp.asarray([False]))
    bm = ball_local_mprops(jnp.full((n_links + 1,), r),
                           dynamic=jnp.asarray(dynamic[1:]))
    mp = LocalMassProperties(*(jnp.concatenate([getattr(gm, f),
                                                getattr(bm, f)])
                               for f in ("inv_mass", "com",
                                         "inertia_ref_frame",
                                         "inv_principal_inertia")))
    joints = spherical_joints(
        list(range(1, n_links + 1)), list(range(2, n_links + 2)),
        [[0.25, 0.0, 0.0]] * n_links, [[-0.25, 0.0, 0.0]] * n_links,
        dynamic_mask=dynamic)
    return new_state(Bodies(poses, Velocity.zero(n, 3), mp), shapes, joints)


def small_group() -> dict:
    t0 = time.time()
    arrays = {}
    params = SimParams()
    for name in CHAINS:
        cfg = PipelineConfig(**CHAIN_CFG)
        st = builders.SCENES[name]()
        for _ in range(CHAIN_WARM):
            st, cfg = step_checked(st, params, cfg)
        export_case(name, st, params, cfg, arrays, t0)
    for mode, kw in DRAPE_CFGS.items():
        cfg = PipelineConfig(**kw)
        st = drape_scene()
        for f in range(DRAPE_WARM):
            st = step(st, params, cfg, warmstart=f > 0)
        export_case(f"drape_{mode}", st, params, cfg, arrays, t0)
    cfg = PipelineConfig(**NET16_CFG)
    st = builders.SCENES["ball_net3"]()
    for _ in range(NET16_WARM):
        st, cfg = step_checked(st, params, cfg)
    export_case("net16", st, params, cfg, arrays, t0)
    return slim(arrays)


def unit_group() -> dict:
    """JAX's build and passes on tests/test_torch_joint.py's mixed set."""
    from test_torch_joint import MAX_COLORS, _mixed_arrays, _world

    from wgmath_tpu.dynamics import joint as jj
    from wgmath_tpu.dynamics.body import Velocity, WorldMassProperties
    from wgmath_tpu.geometry.sim import Sim

    t0 = time.time()
    a, w = _mixed_arrays(), _world()
    ones = jnp.ones(len(a["body_a"]))
    jset = jj.make_joint_set(
        a["body_a"], a["body_b"],
        Sim(jnp.asarray(a["rot_a"]), jnp.asarray(a["anchor_a"]), ones),
        Sim(jnp.asarray(a["rot_b"]), jnp.asarray(a["anchor_b"]), ones),
        **{k: a[k] for k in (
            "locked_axes", "limit_axes", "motor_axes", "coupled_axes",
            "limit_min", "limit_max", "motor_target_vel", "motor_target_pos",
            "motor_stiffness", "motor_damping", "motor_max_force",
            "motor_model")}, dynamic_mask=a["dynamic"])
    poses = Sim(*(jnp.asarray(w[k]) for k in ("rot", "tra", "scale")))
    mprops = WorldMassProperties(*(jnp.asarray(w[k]) for k in (
        "inv_mass", "com", "ii")))
    vels = Velocity(jnp.asarray(w["lin"]), jnp.asarray(w["ang"]))
    sub = SimParams().substep()
    cons = jax.jit(lambda js, p, m: jj.build_joint_constraints(
        js, p, m, sub))(jset, poses, mprops)

    @jax.jit
    def passes(c, v, colors):
        v1, c1 = jj.joint_gs_pass(c, v, colors, max_colors=MAX_COLORS)
        v2, c2 = jj.joint_gs_pass(jj.remove_joint_bias(c1), v1, colors,
                                  max_colors=MAX_COLORS)
        return v1.linear, v1.angular, c1.impulse, v2.linear, v2.angular, \
            c2.impulse

    out = passes(cons, vels, jset.colors)
    arrays = {f"unit.joints.{k}": v
              for k, v in joints_to_arrays(jset).items()}
    for f in dataclasses.fields(cons):
        v = np.asarray(getattr(cons, f.name))
        arrays[f"unit.cons.{f.name}"] = (
            v.astype(np.int32) if np.issubdtype(v.dtype, np.integer) else v)
    for k, v in zip(("linear1", "angular1", "impulse1", "linear2",
                     "angular2", "impulse2"), out):
        arrays[f"unit.pass.{k}"] = np.asarray(v)
    print(f"unit: {len(a['body_a'])} joints, colours up to "
          f"{int(np.asarray(jset.colors).max())} ({time.time() - t0:.0f} s)",
          flush=True)
    return arrays


def net_configs(state, drape_cfg):
    """``scripts/run_jointed10k.py``'s steady ``ladder`` and ``chained_ps``
    configurations from the drape's counts."""
    cnt = np.asarray(state.pair_count)
    steady = dataclasses.replace(
        drape_cfg, bp_slack=0.035, gs_cmax=8192, fine_capacities=True,
        gs_rung_quantum=128, gs_rung_headroom=1.08,
        pair_capacity=fine_bucket(int(cnt[0]) * 13 // 10),
        contact_capacity=fine_bucket(int(cnt[1])))
    ladder = dataclasses.replace(steady,
                                 gs_windows=(128,) * steady.max_colors)
    return {"ladder": ladder,
            "chained_ps": dataclasses.replace(
                ladder, gs_chained=True, gs_rhs_in_rung=True,
                gs_pair_slots=True)}


def net_drape_config(state) -> PipelineConfig:
    """``scripts/run_jointed10k.py``'s drape configuration."""
    return PipelineConfig(
        pair_capacity=65536, contact_capacity=32768, max_colors=24,
        broad_phase_block=512, gs_cmax=4096, bp_slack=0.0,
        manifold_points=auto_manifold_points(
            state.shapes, 3, dynamic=np.asarray(state.bodies.is_dynamic())))


def net_group(mode: str) -> dict:
    """The 10k net's drape state and, under ``mode``'s steady
    configuration with the ladder regrown, ``NET_RUN`` frames from it."""
    t0 = time.time()
    arrays = {}
    params = SimParams()
    st = builders.ball_net3(100, 100)
    cfg = net_drape_config(st)
    for f in range(NET_DRAPE):
        st, cfg = step_checked(st, params, cfg)
        if f % 10 == 9:
            print(f"net100 {mode} drape frame {f + 1}: pair_count "
                  f"{np.asarray(st.pair_count)[:5].tolist()} "
                  f"({time.time() - t0:.0f} s)", flush=True)
    # the drape keeps no broad-phase cache (bp_slack 0); its solve bundle
    # is dropped, so a frame from the stored state rebuilds it
    drape = dataclasses.replace(st, solve_cache=None)
    arrays["net100.drape_config_json"] = _json(cfg)
    arrays["net100.params_json"] = _json(params)
    for k, v in state_to_arrays(drape).items():
        arrays[f"net100.{k if k.startswith('joints.') else 'drape.' + k}"] = v
    warm, steady = drape, net_configs(drape, cfg)[mode]
    for _ in range(NET_REGROW):
        warm, steady = step_checked(warm, params, steady)
    name = f"net100_{mode}"
    arrays[f"{name}.config_json"] = _json(steady)
    stretch = []
    s, c = drape, steady
    for f in range(NET_RUN):
        s, c = step_checked(s, params, c)
        stretch.append(joint_stretch(s))
        if f == 0:
            arrays[f"{name}.ref.0.translation"] = np.asarray(
                s.bodies.poses.translation)
            arrays[f"{name}.ref.0.pair_count"] = np.asarray(s.pair_count,
                                                            np.int32)
            arrays[f"{name}.ref.0.config_json"] = _json(c)
            print(f"{name} ref frame: pair_count "
                  f"{np.asarray(s.pair_count)[:5].tolist()}", flush=True)
    arrays[f"{name}.stretch"] = np.asarray(stretch, np.float32)
    print(f"{name}: stretch over {NET_RUN} frames {stretch} "
          f"({time.time() - t0:.0f} s)", flush=True)
    return slim(arrays)


JOBS = {"small": ((small_group, ()),), "unit": ((unit_group, ()),),
        "net": ((net_group, ("ladder",)), (net_group, ("chained_ps",)))}
PREFIXES = {"small": CHAINS + tuple(f"drape_{m}" for m in DRAPE_CFGS)
            + ("net16",), "unit": ("unit",),
            "net": ("net100", "net100_ladder", "net100_chained_ps")}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=tuple(JOBS), default=None,
                    help="rewrite this group only (default: every group)")
    only = ap.parse_args().only
    t0 = time.time()
    groups = [g for g in JOBS if only in (None, g)]
    arrays = {}
    if only is not None and os.path.exists(OUT):
        with np.load(OUT) as z:
            arrays = {k: z[k] for k in z.files
                      if k.split(".", 1)[0] not in PREFIXES[only]}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(4) as pool:
        jobs = [pool.apply_async(fn, args) for g in groups
                for fn, args in JOBS[g]]
        for job in jobs:
            arrays.update(job.get())
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT) / 1e6:.2f} MB, "
          f"{time.time() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
