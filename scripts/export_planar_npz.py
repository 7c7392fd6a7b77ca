"""Export the JAX package's 2D results as a JAX-free file,
``artifacts/planar_jax.npz.xz`` (``export_box_npz.savez_xz``), read by
``tests/test_torch_pipeline_planar.py``, ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.

Groups (``--only`` rewrites one, keeping the others' arrays):

- ``small``: each 2D ``SCENES`` entry under the testbed's configuration
  (``testbed_config``), ``pyramid2``
  also under ``jacobi`` and ``boxes_and_balls2`` under ``chained`` and
  ``fused``: ``WARM`` ``step_checked`` frames from the built state, then
  three frames. ``<case>.s0.*`` is the warmed state, ``<case>.s1.*`` /
  ``<case>.s2.*`` the states after the first two frames, each holding
  only what changes from the built state (poses, velocities, the pair
  count, the warmstart's constraint fields (``WARMSTART_FIELDS``), last
  frame's colours, the broad-phase cache; the shapes, mass properties and
  joints are the builder's, which the port equals bit for bit);
  ``<case>.ref.<f>.{pair_count,config_json}`` the results of the three
  frames (the translations after the first two are ``s1``'s and ``s2``'s,
  after the third ``<case>.ref.2.translation``), ``<case>.config_json``
  the configuration the warm frames ended on. ``fused`` is checked here to give the frames of the
  same configuration without ``gs_fused`` bit for bit (the JAX package
  runs the fused solver in 3D only).
- ``net``: ``joint_net2(100, 100)`` (10,000 balls, 19,800 revolute
  joints) under the testbed's configuration, three frames from the built
  state: each frame's pair count, configuration, largest joint stretch
  and the translations of a seeded sample of ``NET_SAMPLE`` bodies
  (``net.sample_ids``).
- ``mix``: ``boxes_and_balls(10_000, dim=2)`` under the testbed's
  configuration, ``MIX_FRAMES`` frames from the built state; every
  ``MIX_EVERY`` frames the kinetic-energy proxy (sum |v|²), the deepest
  live contact point of the frame's constraints, the 99th and 90th
  percentiles and the mean of their depths, the lowest dynamic centre and
  the pair count (``mix.envelope``: rows of frame, energy, deepest, p99,
  p90, mean, lowest).

Runs on the CPU, the small cases and the two 10k groups in parallel
processes::

    JAX_PLATFORMS=cpu python scripts/export_planar_npz.py [--only GROUP]

``small`` takes ~10 min, ``net`` ~5 min, ``mix`` ~15 min.
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

import numpy as np  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "planar_jax.npz.xz")
WARM = 60
REF_FRAMES = 3
SMALL_CASES = {
    "balls2": ("balls2", "default"),
    "pyramid2": ("pyramid2", "default"),
    "pyramid2_jacobi": ("pyramid2", "jacobi"),
    "boxes_and_balls2": ("boxes_and_balls2", "default"),
    "boxes_and_balls2_chained": ("boxes_and_balls2", "chained"),
    "boxes_and_balls2_fused": ("boxes_and_balls2", "fused"),
    "capsules2": ("capsules2", "default"),
    "polyline2": ("polyline2", "default"),
    "joint_ball2": ("joint_ball2", "default"),
    "joint_fixed2": ("joint_fixed2", "default"),
    "joint_prismatic2": ("joint_prismatic2", "default"),
}
NET_SHAPE = (100, 100)
NET_FRAMES = 3
NET_SAMPLE = 1000
NET_SEED = 18
MIX_BODIES = 10_000
MIX_FRAMES = 120
MIX_EVERY = 10
# what a state keeps besides the builder's: everything a step reads that
# changes from frame to frame
DYNAMIC_PREFIXES = ("bodies.poses.", "bodies.vels.", "pair_count",
                    "prev_constraints.", "prev_colors", "bp_pairs.",
                    "bp_ref.", "bp_colors.")


# the constraint fields the warmstart reads (the Jacobi copies only where
# a Jacobi solve wrote them)
WARMSTART_FIELDS = ("body_a", "body_b", "valid", "n_impulse", "t_impulse",
                    "n_impulse_jacobi", "t_impulse_jacobi")
NP_ROWS = 256  # the pair slots whose JAX narrow phase is kept (capsules2)


# the testbed's configurations (``wgmath_tpu/testbed/runner.py``'s
# ``BackendConfig``) as the changes each makes to its default,
# ``PipelineConfig(pair_capacity=16384)`` with the scene's
# ``auto_manifold_points``: ``--solver jacobi``, ``--gs-chained`` (the
# window ladder), and that ladder with ``gs_fused`` and the broad-phase
# cache, which a 2D scene runs unfused
TESTBED_MODES = {
    "default": {},
    "jacobi": {"use_jacobi": True},
    "chained": {"gs_chained": True, "max_colors": 16,
                "gs_windows": (256,) * 16, "gs_cmax": 1024},
    "fused": {"gs_chained": True, "max_colors": 16,
              "gs_windows": (256,) * 16, "gs_cmax": 1024, "gs_fused": True,
              "bp_slack": 0.02},
}


def testbed_config(mode: str, manifold_points: int) -> dict:
    """The ``PipelineConfig`` fields of the testbed's ``mode`` (a key of
    ``TESTBED_MODES``) for a scene of that manifold width; its solver's
    parameters are ``SimParams.jacobi()`` under ``jacobi``, else
    ``SimParams.tgs_soft()``."""
    return dict(pair_capacity=16384, manifold_points=manifold_points,
                **TESTBED_MODES[mode])


def dynamic_arrays(state) -> dict:
    from wgmath_tpu_torch.convert import state_to_arrays

    out = {}
    for k, v in state_to_arrays(state).items():
        if not k.startswith(DYNAMIC_PREFIXES):
            continue
        field = k.rsplit("prev_constraints.", 1)[-1]
        if "prev_constraints." in k and (
                field not in WARMSTART_FIELDS
                or (field.endswith("_jacobi") and not np.any(v))):
            continue  # tests/planar_inputs.py fills these with zeros
        out[k] = v
    return out


def narrow_rows(state, cfg, params) -> dict:
    """The JAX narrow phase's first point over the first ``NP_ROWS`` pair
    slots of the step's broad phase (the brute force under 1,024 bodies):
    its distance, normal and point (local to A) and validity."""
    from wgmath_tpu.broad_phase.brute_force import find_pairs
    from wgmath_tpu.queries.narrow_phase import narrow_phase
    from wgmath_tpu.shapes.shape import ball_radii_or_nan, world_aabbs

    b = state.bodies
    mins, maxs = world_aabbs(state.shapes, b.poses,
                             margin=params.prediction_distance)
    pairs = find_pairs(mins, maxs, capacity=cfg.pair_capacity,
                       block=cfg.broad_phase_block,
                       max_per_row=cfg.broad_phase_max_per_row,
                       ball_radius=ball_radii_or_nan(state.shapes, b.poses),
                       margin=params.prediction_distance,
                       dynamic=b.is_dynamic())
    c = narrow_phase(b.poses, state.shapes, pairs,
                     params.prediction_distance,
                     p_max=cfg.manifold_points)
    return {"dist": np.asarray(c.dist)[:NP_ROWS, 0],
            "normal": np.asarray(c.normal_a)[:NP_ROWS],
            "point": np.asarray(c.points_a)[:NP_ROWS, 0],
            "valid": np.asarray(c.valid)[:NP_ROWS],
            "body_a": np.asarray(c.body_a, np.int32)[:NP_ROWS],
            "body_b": np.asarray(c.body_b, np.int32)[:NP_ROWS]}


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(ROOT, ".jax_cache_cpu"))
    return jax


def setup(scene_state, mode: str):
    """(config, params) of the testbed's ``mode`` for a JAX state."""
    from wgmath_tpu.dynamics import SimParams
    from wgmath_tpu.pipeline import PipelineConfig, auto_manifold_points

    dim = scene_state.bodies.poses.translation.shape[-1]
    mp = auto_manifold_points(scene_state.shapes, dim)
    cfg = PipelineConfig(**testbed_config(mode, mp))
    params = SimParams.jacobi() if mode == "jacobi" else SimParams.tgs_soft()
    return cfg, params


def _json(cfg) -> np.ndarray:
    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def small_case(name: str) -> dict:
    _jax()
    from wgmath_tpu.pipeline import step_checked
    from wgmath_tpu.scenes.builders import SCENES

    scene, mode = SMALL_CASES[name]
    t0 = time.time()
    st = SCENES[scene]()
    cfg, params = setup(st, mode)
    for _ in range(WARM):
        st, cfg = step_checked(st, params, cfg)
    out = {f"{name}.config_json": _json(cfg),
           f"{name}.mode": np.asarray(mode), f"{name}.scene":
           np.asarray(scene)}
    states = [st]
    c = cfg
    for f in range(REF_FRAMES):
        st, c = step_checked(st, params, c)
        states.append(st)
        p = f"{name}.ref.{f}"
        if f == REF_FRAMES - 1:  # the earlier ones are s1, s2's
            out[f"{p}.translation"] = np.asarray(
                st.bodies.poses.translation)
        out[f"{p}.pair_count"] = np.asarray(st.pair_count, np.int32)
        out[f"{p}.config_json"] = _json(c)
    for i in range(REF_FRAMES):
        for k, v in dynamic_arrays(states[i]).items():
            out[f"{name}.s{i}.{k}"] = v
        if scene == "capsules2":
            cfg_i = cfg if i == 0 else dataclasses.replace(
                cfg, **json.loads(str(out[f"{name}.ref.{i - 1}.config_json"])))
            for k, v in narrow_rows(states[i], cfg_i, params).items():
                out[f"{name}.np{i}.{k}"] = v
    if mode == "fused":
        # the same frames without gs_fused, bit for bit
        st2, c2 = states[0], dataclasses.replace(cfg, gs_fused=False)
        for f in range(REF_FRAMES):
            st2, c2 = step_checked(st2, params, c2)
            same = np.array_equal(
                np.asarray(st2.bodies.poses.translation),
                np.asarray(states[f + 1].bodies.poses.translation))
            assert same, f"{name}: gs_fused changed frame {f} in 2D"
    pc = out[f"{name}.ref.{REF_FRAMES - 1}.pair_count"]
    print(f"{name}: pair_count {pc[:5].tolist()} ({time.time() - t0:.0f} s)",
          flush=True)
    return out


def joint_stretch_np(state) -> float:
    from wgmath_tpu.geometry import sim as sim_ops

    j, p = state.joints, state.bodies.poses

    def take(i):
        from wgmath_tpu.geometry.sim import Sim

        return Sim(p.rotation[i], p.translation[i], p.scale[i])

    a = sim_ops.mul_pt(take(j.body_a), j.local_frame_a.translation)
    b = sim_ops.mul_pt(take(j.body_b), j.local_frame_b.translation)
    return float(np.max(np.linalg.norm(np.asarray(a) - np.asarray(b),
                                       axis=-1)))


def net_sample_ids(n: int) -> np.ndarray:
    return np.sort(np.random.default_rng(NET_SEED).choice(
        n, NET_SAMPLE, replace=False)).astype(np.int32)


def net_group() -> dict:
    _jax()
    from wgmath_tpu.pipeline import step_checked
    from wgmath_tpu.scenes.builders import joint_net2

    t0 = time.time()
    st = joint_net2(*NET_SHAPE)
    cfg, params = setup(st, "default")
    ids = net_sample_ids(st.bodies.num_bodies)
    out = {"net.sample_ids": ids, "net.config_json": _json(cfg)}
    for f in range(NET_FRAMES):
        st, cfg = step_checked(st, params, cfg)
        p = f"net.ref.{f}"
        out[f"{p}.sample"] = np.asarray(st.bodies.poses.translation)[ids]
        out[f"{p}.pair_count"] = np.asarray(st.pair_count, np.int32)
        out[f"{p}.config_json"] = _json(cfg)
        out[f"{p}.stretch"] = np.asarray(joint_stretch_np(st), np.float32)
        print(f"net frame {f}: {out[f'{p}.pair_count'][:5].tolist()}, "
              f"stretch {float(out[f'{p}.stretch']):.3e} "
              f"({time.time() - t0:.0f} s)", flush=True)
    return out


def mix_envelope(state) -> tuple:
    """(sum |v|², deepest live contact point, :func:`depth_figures`,
    lowest dynamic centre) from the state's arrays: the last frame's
    constraints' points."""
    vel = np.asarray(state.bodies.vels.linear)
    cons = state.prev_constraints
    nump = np.asarray(cons.num_points)
    live = (np.asarray(cons.valid)[:, None]
            & (np.arange(np.asarray(cons.info_dist).shape[1])[None, :]
               < nump[:, None]))
    depth = -np.asarray(cons.info_dist)[live]
    y = np.asarray(state.bodies.poses.translation)[1:, 1]
    return (float((vel * vel).sum()),
            max(float(depth.max()) if depth.size else 0.0, 0.0),
            *depth_figures(depth), float(y.min()))


def depth_figures(depth) -> tuple:
    """The 99th and 90th percentiles (numpy's linear rule) and the mean of
    contact depths, 0 for none: a pile's deeper contacts, which the frame
    in which one impact is first seen cannot move as it moves the deepest
    one."""
    if not depth.size:
        return 0.0, 0.0, 0.0
    return (float(np.percentile(depth, 99.0)),
            float(np.percentile(depth, 90.0)), float(depth.mean()))


def mix_group() -> dict:
    _jax()
    from wgmath_tpu.pipeline import step_checked
    from wgmath_tpu.scenes.builders import boxes_and_balls

    t0 = time.time()
    st = boxes_and_balls(MIX_BODIES, dim=2)
    cfg, params = setup(st, "default")
    out = {"mix.config_json": _json(cfg)}
    rec = []
    for f in range(1, MIX_FRAMES + 1):
        st, cfg = step_checked(st, params, cfg)
        if f % MIX_EVERY == 0:
            ke, pen, p99, p90, mean, low = mix_envelope(st)
            pc = np.asarray(st.pair_count, np.int32)
            rec.append([f, ke, pen, p99, p90, mean, low])
            out[f"mix.ref.{f}.pair_count"] = pc
            print(f"mix frame {f}: ke {ke:.4f} pen {pen:.4e} p99 "
                  f"{p99:.4e} p90 {p90:.4e} mean {mean:.4e} low {low:.4f} "
                  f"pairs {pc[:3].tolist()} ({time.time() - t0:.0f} s)",
                  flush=True)
    out["mix.envelope"] = np.asarray(rec, np.float64)
    out["mix.end_config_json"] = _json(cfg)
    return out


def builder_group() -> dict:
    """Each 2D scene's built state as a digest and its
    ``auto_manifold_points``."""
    _jax()
    from wgmath_tpu.pipeline import auto_manifold_points
    from wgmath_tpu.scenes.builders import SCENES

    from tests.planar_inputs import state_digest
    from wgmath_tpu_torch.convert import state_to_arrays
    from wgmath_tpu_torch.scenes.builders import PLANAR_SCENES

    out = {}
    for name in PLANAR_SCENES:
        st = SCENES[name]()
        out[f"built.{name}.digest"] = np.asarray(
            state_digest(state_to_arrays(st)))
        out[f"built.{name}.manifold_points"] = np.asarray(
            auto_manifold_points(st.shapes, 2), np.int32)
    return out


def _run(task: str) -> dict:
    try:
        if task == "net":
            return net_group()
        if task == "mix":
            return mix_group()
        if task == "built":
            return builder_group()
        return small_case(task)
    except Exception:  # one task's failure keeps the others' results
        import traceback

        print(f"{task} FAILED:\n{traceback.format_exc()}", flush=True)
        return {}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("small", "net", "mix"))
    ap.add_argument("--jobs", type=int, default=4)
    args = ap.parse_args()
    from export_box_npz import savez_xz

    from wgmath_tpu_torch.convert import load_arrays

    tasks = []
    if args.only in (None, "mix"):
        tasks.append("mix")
    if args.only in (None, "net"):
        tasks.append("net")
    if args.only in (None, "small"):
        tasks += ["built"] + list(SMALL_CASES)
    keep = {}
    if args.only and os.path.exists(OUT):
        drop = set(tasks)
        keep = {k: v for k, v in load_arrays(OUT).items()
                if k.split(".")[0] not in drop}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(args.jobs, len(tasks))) as pool:
        results = pool.map(_run, tasks, chunksize=1)
    arrays = dict(keep)
    for r in results:
        arrays.update(r)
    savez_xz(OUT, arrays)
    print(f"wrote {OUT}: {os.path.getsize(OUT)} bytes, {len(arrays)} arrays")


if __name__ == "__main__":
    main()
