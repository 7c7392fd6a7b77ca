"""Interactive live viewer for the testbed (counterpart of
``wgmath_tpu/testbed/live.py``).

A matplotlib window animates the running scene, with these keys:

  space  pause / resume
  t      switch the solver TGS <-> Jacobi
  c      toggle the chained Gauss-Seidel sweep
  m      toggle instanced 3D meshes <-> scatter (3D scenes)
  [ / ]  previous / next demo scene
  n      one step while paused
  r      reset the scene
  q      close

The solver switch happens live: the pipeline configuration is swapped
between frames and the next ``step_checked`` runs the new one on the same
state (the solve cache, the colours and the broad-phase cache are
dropped, their shapes depend on the configuration).

Needs an interactive matplotlib backend (TkAgg, QtAgg, ...); under the
headless Agg backend the per-frame drawing still works (the tests use it)
but ``run()`` warns that no window can be shown. matplotlib is imported
inside the functions that draw.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.core.profiling import RunStats, sync
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import auto_manifold_points, step_checked
from wgmath_tpu_torch.scenes.builders import SCENES
from wgmath_tpu_torch.testbed.runner import BackendConfig
from wgmath_tpu_torch.testbed.viewer import _render_scatter, body_draw_meta


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class LiveViewer:
    """Owns the simulation loop and the matplotlib figure. ``device``
    (``None``: the card) is where the scenes are built and stepped."""

    def __init__(self, scene: str, *, solver: str = "tgs",
                 bp_slack: float = 0.0, gs_chained: bool = False,
                 frames: int | None = None, pair_capacity: int = 16384,
                 device=None):
        self.device = resolve_device(device)
        self.scene = scene
        self.backend = BackendConfig(solver, bp_slack, gs_chained)
        self.pair_capacity = pair_capacity
        self.frames = frames
        self.paused = False
        self.closed = False
        self.stats = RunStats()
        self.mesh_mode = False  # instanced 3D meshes vs scatter blobs
        self._inst = None
        self._load()

    # -- simulation ----------------------------------------------------------

    def _load(self):
        self.state = SCENES[self.scene](device=self.device)
        dim = self.state.bodies.poses.translation.shape[-1]
        self.dim = dim
        self.params = (SimParams.jacobi() if self.backend.solver == "jacobi"
                       else SimParams.tgs_soft())
        self.config = self.backend.pipeline_config(
            pair_capacity=self.pair_capacity,
            manifold_points=auto_manifold_points(self.state.shapes, dim))
        self.size, self.dynamic = body_draw_meta(self.state)
        pos = _host(self.state.bodies.poses.translation)
        span = float(np.abs(pos).max() + self.size.max() * 2.0 + 1.0)
        self.lims = (-span, span)
        self.frame = 0
        self._times: list[float] = []
        self._inst = None  # instanced meshes rebuild lazily per scene

    def _swap_backend(self, **changes):
        """Runtime solver switch: a new configuration, the same physics
        state. The caches whose shapes depend on the configuration (the
        solve bundle, the colours, the broad-phase cache) are dropped."""
        self.backend = dataclasses.replace(self.backend, **changes)
        self.params = (SimParams.jacobi() if self.backend.solver == "jacobi"
                       else SimParams.tgs_soft())
        self.config = self.backend.pipeline_config(
            pair_capacity=self.pair_capacity,
            manifold_points=self.config.manifold_points)
        self.state = dataclasses.replace(
            self.state, solve_cache=None, prev_colors=None,
            bp_pairs=None, bp_ref=None, bp_colors=None)

    def advance(self) -> None:
        t0 = time.perf_counter()
        self.state, self.config = step_checked(
            self.state, self.params, self.config, self.stats)
        sync(self.state.bodies.poses.translation)  # the frame's own time
        self._times.append(time.perf_counter() - t0)
        if len(self._times) > 30:
            self._times.pop(0)
        self.frame += 1

    # -- UI ------------------------------------------------------------------

    def on_key(self, event) -> None:
        key = getattr(event, "key", event)
        if key == " ":
            self.paused = not self.paused
        elif key == "t":
            new = "jacobi" if self.backend.solver == "tgs" else "tgs"
            self._swap_backend(solver=new)
        elif key == "c":
            self._swap_backend(gs_chained=not self.backend.gs_chained,
                               solver="tgs")
        elif key == "m" and self.dim == 3:
            self.mesh_mode = not self.mesh_mode
        elif key in ("[", "]"):
            names = sorted(SCENES)
            i = names.index(self.scene) if self.scene in names else 0
            self.scene = names[(i + (1 if key == "]" else -1)) % len(names)]
            self._load()
        elif key == "n" and self.paused:
            self.advance()
        elif key == "r":
            self._load()
        elif key == "q":
            self.closed = True

    def status(self) -> str:
        fps = (len(self._times) / sum(self._times)) if self._times else 0.0
        counts = _host(self.state.pair_count)
        mode = self.backend.solver + (
            "+chained" if self.backend.gs_chained else "")
        return (f"{self.scene}  [{mode}]  frame {self.frame}  "
                f"{fps:5.1f} fps  pairs {int(counts[0])}  "
                f"contacts {int(counts[1])}  "
                f"{'PAUSED' if self.paused else ''}\n"
                "space pause | t solver | c chained | m mesh | [/] scene | "
                "n step | r reset | q quit")

    def draw(self, fig, ax) -> None:
        ax.clear()
        pos = _host(self.state.bodies.poses.translation)
        if self.mesh_mode and self.dim == 3:
            from wgmath_tpu_torch.testbed.instanced import (
                InstancedScene,
                render_instanced,
            )

            if self._inst is None:
                self._inst = InstancedScene(self.state)
            rot = _host(self.state.bodies.poses.rotation)
            render_instanced(ax, self._inst, rot, pos, self.dynamic,
                             self.lims)
        else:
            _render_scatter(ax, pos, self.size, self.dynamic, self.lims,
                            self.dim)
        ax.set_title(self.status(), fontsize=9, loc="left")

    def run(self) -> RunStats:
        import matplotlib

        if matplotlib.get_backend().lower() == "agg":
            import warnings

            warnings.warn("matplotlib backend is Agg (headless): no window "
                          "will be shown; stepping without display")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(7, 7))
        ax = (fig.add_subplot(111, projection="3d") if self.dim == 3
              else fig.add_subplot(111))
        fig.canvas.mpl_connect("key_press_event", self.on_key)
        fig.canvas.mpl_connect("close_event",
                               lambda e: setattr(self, "closed", True))
        plt.ion()
        plt.show(block=False)
        while not self.closed:
            if self.frames is not None and self.frame >= self.frames:
                break
            if not self.paused:
                self.advance()
            self.draw(fig, ax)
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
            plt.pause(0.001)
        plt.ioff()
        plt.close(fig)
        per = (sum(self._times) / len(self._times)) if self._times else 0.0
        self.stats.counters["steps_per_second"] = (
            int(1.0 / per) if per else 0)
        return self.stats
