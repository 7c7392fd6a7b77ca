"""Testbed: the scene runner, its backend switch and its statistics
(counterpart of ``wgmath_tpu/testbed/runner.py``).

``python -m wgmath_tpu_torch.testbed.runner`` takes the JAX package's
flags. ``--backend torch`` (the default) steps a scene with
``pipeline.step_checked``; ``--backend oracle`` runs it on the
independent float64 numpy engine (``testbed/oracle.py``: balls and
cuboids, 3D, no joints). ``--device`` picks the card (``cuda``, the
default: the run raises without one) or the CPU (``cpu``, the plain
PyTorch path). A run prints per-phase statistics, or one JSON line a scene
with ``--json`` (its phase times, its counters and whether every final
pose is finite).

    python -m wgmath_tpu_torch.testbed.runner --list
    python -m wgmath_tpu_torch.testbed.runner --example balls3 --frames 60
    python -m wgmath_tpu_torch.testbed.runner --run-all --frames 3 --json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.core.profiling import PhaseTimer, RunStats
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import (
    PipelineConfig,
    auto_manifold_points,
    step_checked,
)
from wgmath_tpu_torch.scenes.builders import SCENES


@dataclasses.dataclass
class BackendConfig:
    """The solver choice (TGS or Jacobi) and its variants."""

    solver: str = "tgs"  # "tgs" | "jacobi"
    bp_slack: float = 0.0  # temporal-coherence broad phase (0 = off)
    gs_chained: bool = False  # the chained Gauss-Seidel sweep

    def pipeline_config(self, pair_capacity=16384,
                        manifold_points=0) -> PipelineConfig:
        extra = {}
        if self.gs_chained:
            # the chained sweep needs the per-colour window ladder; small
            # rungs to start, which step_checked regrows
            extra = dict(gs_chained=True, max_colors=16,
                         gs_windows=(256,) * 16, gs_cmax=1024)
        return PipelineConfig(pair_capacity=pair_capacity,
                              use_jacobi=self.solver == "jacobi",
                              bp_slack=self.bp_slack,
                              manifold_points=manifold_points, **extra)


def _positions(state) -> np.ndarray:
    return state.bodies.poses.translation.detach().cpu().numpy()


def _dump(frame: int, pos: np.ndarray) -> None:
    print(f"frame {frame}: y[min/mean/max] = {pos[:, 1].min():.3f}/"
          f"{pos[:, 1].mean():.3f}/{pos[:, 1].max():.3f}", flush=True)


def _run_oracle(state, frames: int, *, verify: bool, dump_every: int,
                record, record_every: int, final) -> RunStats:
    from wgmath_tpu_torch.testbed.oracle import run_oracle_backend

    stats = RunStats()
    recorder = None
    if record:
        from wgmath_tpu_torch.testbed.viewer import Recorder

        recorder = Recorder(state)
        recorder.record(state)
    dev = state.bodies.poses.translation.device

    def on_frame(f, bodies):
        pos = np.stack([b.pos for b in bodies])
        if verify and not np.all(np.isfinite(pos)):
            raise AssertionError(f"oracle NaN/Inf at frame {f}")
        if recorder is not None and f % max(record_every, 1) == 0:
            rot = np.stack([b.rot for b in bodies])
            poses = dataclasses.replace(
                state.bodies.poses,
                translation=torch.tensor(pos, dtype=torch.float32,
                                         device=dev),
                rotation=torch.tensor(rot, dtype=torch.float32, device=dev))
            recorder.record(dataclasses.replace(
                state, bodies=dataclasses.replace(state.bodies,
                                                  poses=poses)))
        if dump_every and f % dump_every == 0:
            _dump(f, pos)

    t0 = time.perf_counter()
    pos, _ = run_oracle_backend(state, frames, on_frame=on_frame)
    stats.add_phase("step", (time.perf_counter() - t0) * 1e3)
    stats.counters["steps"] = frames
    per_step = stats.phase_ms["step"] / max(frames, 1)
    stats.counters["steps_per_second"] = int(1000.0 / max(per_step, 1e-9))
    if final is not None:
        final["positions"] = pos
    if recorder is not None:
        recorder.save(record)
        print(f"recorded {len(recorder.frames)} frames -> {record}")
    return stats


def run_scene(name: str, *, frames: int = 300, solver: str = "tgs",
              dump_every: int = 0, verify: bool = False,
              bp_slack: float = 0.0, record: str | None = None,
              record_every: int = 1, gs_chained: bool = False,
              backend: str = "torch", device=None,
              final: dict | None = None) -> RunStats:
    """Step the scene ``name`` ``frames`` frames, printing what
    ``dump_every`` asks for, and return its statistics. ``record`` writes
    the pose trajectory for ``testbed.viewer``; ``verify`` checks every
    frame (:func:`debug_validate`). ``backend="oracle"`` runs the scene on
    the independent float64 engine instead. ``device`` (``None``: the
    card) is where the scene is built and stepped. ``final``, where given,
    receives the last frame's body positions as ``"positions"``."""
    dev = resolve_device(device)
    state = SCENES[name](device=dev)
    if backend == "oracle":
        return _run_oracle(state, frames, verify=verify,
                           dump_every=dump_every, record=record,
                           record_every=record_every, final=final)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    params = SimParams.jacobi() if solver == "jacobi" else SimParams.tgs_soft()
    config = BackendConfig(solver, bp_slack, gs_chained).pipeline_config(
        manifold_points=auto_manifold_points(state.shapes, state.bodies.dim))
    stats = RunStats()
    timer = PhaseTimer(stats)
    recorder = None
    if record:
        from wgmath_tpu_torch.testbed.viewer import Recorder

        recorder = Recorder(state)
        recorder.record(state)

    with timer.phase("first_step") as h:
        state, config = step_checked(state, params, config, stats)
        h.append(state.bodies.poses.translation)
    for frame in range(1, frames):
        with timer.phase("step") as h:
            state, config = step_checked(state, params, config, stats)
            h.append(state.bodies.poses.translation)
        if verify:
            debug_validate(state)
        if recorder is not None and frame % max(record_every, 1) == 0:
            recorder.record(state)
        if dump_every and frame % dump_every == 0:
            _dump(frame, _positions(state))
    if recorder is not None:
        recorder.save(record)
        print(f"recorded {len(recorder.frames)} frames -> {record}")
    per_step = stats.phase_ms.get("step", 0.0) / max(frames - 1, 1)
    stats.counters["steps_per_second"] = int(1000.0 / max(per_step, 1e-9))
    if final is not None:
        final["positions"] = _positions(state)
    return stats


def debug_validate(state) -> None:
    """A NaN scan of the poses and a range check of the constraints' body
    indices (the reference's debug-only pair-list validator)."""
    pos = _positions(state)
    if not np.all(np.isfinite(pos)):
        raise AssertionError("NaN/Inf in body poses")
    if state.prev_constraints is not None:
        cons = state.prev_constraints
        valid = cons.valid.cpu().numpy()
        a = cons.body_a.cpu().numpy()[valid]
        b = cons.body_b.cpu().numpy()[valid]
        n = pos.shape[0]
        if valid.any() and (a.max(initial=0) >= n or b.max(initial=0) >= n):
            raise AssertionError("constraint body index out of range")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="wgmath_tpu_torch testbed: step the demo scenes")
    ap.add_argument("--example", default=None, help="scene name")
    ap.add_argument("--list", action="store_true", help="list scenes")
    ap.add_argument("--run-all", action="store_true")
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--solver", choices=["tgs", "jacobi"], default="tgs")
    ap.add_argument("--dump-every", type=int, default=0)
    ap.add_argument("--verify", action="store_true",
                    help="per-frame NaN/constraint validation")
    ap.add_argument("--record", default=None, metavar="PATH.npz",
                    help="record the pose trajectory for testbed.viewer "
                         "(render: python -m wgmath_tpu_torch.testbed.viewer "
                         "PATH.npz --out-dir frames --gif out.gif)")
    ap.add_argument("--record-every", type=int, default=1)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--live", action="store_true",
                    help="interactive matplotlib window: live scatter, "
                         "runtime solver switch on 't'/'c', pause on space")
    ap.add_argument("--gs-chained", action="store_true",
                    help="the chained Gauss-Seidel sweep (window ladder)")
    ap.add_argument("--bp-slack", type=float, default=0.0,
                    help="broad-phase temporal-coherence slack (0 = off; "
                         "pairs are cached until a body's AABB drifts past "
                         "the slack; the narrow phase re-tests them)")
    ap.add_argument("--backend", choices=["torch", "oracle"],
                    default="torch",
                    help="'oracle' runs the scene on the independent "
                         "float64 numpy engine (ball/cuboid scenes, 3D, "
                         "no joints)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the scene is built and stepped (the card "
                         "by default; 'cpu' runs the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.list:
        for name in SCENES:
            print(name)
        return 0
    if args.bp_slack < 0:
        ap.error(f"--bp-slack must be >= 0 (got {args.bp_slack}); negative "
                 "slack would deflate the cached AABBs and miss pairs")
    names = list(SCENES) if args.run_all else [args.example or "balls3"]
    unknown = [n for n in names if n not in SCENES]
    if unknown:
        print(f"unknown scene(s): {', '.join(unknown)}", file=sys.stderr)
        print(f"available: {', '.join(SCENES)}", file=sys.stderr)
        return 2
    device = resolve_device(args.device)
    if args.live:
        from wgmath_tpu_torch.testbed.live import LiveViewer

        stats = LiveViewer(names[0], solver=args.solver,
                           bp_slack=args.bp_slack,
                           gs_chained=args.gs_chained, frames=args.frames,
                           device=device).run()
        print(stats.summary())
        return 0
    for name in names:
        final = {}
        stats = run_scene(name, frames=args.frames, solver=args.solver,
                          dump_every=args.dump_every, verify=args.verify,
                          bp_slack=args.bp_slack, record=args.record,
                          record_every=args.record_every,
                          gs_chained=args.gs_chained, backend=args.backend,
                          device=device, final=final)
        if args.json:
            print(json.dumps({
                "scene": name, "phase_ms": stats.phase_ms,
                "counters": stats.counters,
                "finite": bool(np.all(np.isfinite(final["positions"]))),
                "bodies": int(final["positions"].shape[0])}), flush=True)
        else:
            print(f"=== {name} ===")
            print(stats.summary())
    return 0


if __name__ == "__main__":
    sys.exit(main())
