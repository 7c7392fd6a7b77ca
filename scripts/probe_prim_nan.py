"""Where the primitive rain first turns a pose non-finite. From
``primitives3(per_kind)``'s first state under ``primitive_configs``'
``ladder`` and ``fused``, for ``--frames`` frames, the port's default path
(the support-mapped kernel replayed as a CUDA graph on the card): after
every narrow phase, the live contacts' normals (finite and unit within
1e-3), points (finite and within ``WILD`` of A's origin) and distances are
checked, and after every solve the poses and velocities. The first failure names its stage and frame, and the state
before that frame and its configuration go to
``<out>/prim_nan_<per_kind>_<config>_cap<epa_cap>.npz``
(``scripts/replay_prim_nan.py`` steps it again, on either device). Run from the repository root on a
machine with the card::

    python3 scripts/probe_prim_nan.py --sizes 100 150 300

``--device cpu`` runs the same on the CPU; ``--from-cpu`` builds the scene
on the CPU and moves it to the device, as ``chip_smoke.py`` does;
``--epa-cap`` raises the EPA
batch of ``pfm_contact`` above the reference's 256 (not the reference's
semantics).
"""

from __future__ import annotations

import importlib
import argparse
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wgmath_tpu_torch import pipeline  # noqa: E402
from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked  # noqa: E402
from wgmath_tpu_torch.queries import gjk  # noqa: E402
narrow_mod = importlib.import_module(
    "wgmath_tpu_torch.queries.narrow_phase")
from wgmath_tpu_torch.scenes.builders import (  # noqa: E402
    primitive_configs,
    primitives3,
)

UNIT_TOL = 1e-3
WILD = 1e3  # m; every shape of the scene lies within 100 m of its origin


def _finite(*ts) -> torch.Tensor:
    ok = torch.ones(ts[0].shape[0], dtype=torch.bool, device=ts[0].device)
    for t in ts:
        ok &= torch.isfinite(t.reshape(t.shape[0], -1)).all(-1)
    return ok


class Checks:
    """Wraps the pipeline's ``narrow_phase`` and ``solve``; ``failure``
    is the first (stage, detail) that went wrong."""

    def __init__(self):
        self.failure = None
        self.context = None  # (poses, shapes, [(body_a, body_b)]) of it

    def narrow_phase(self, poses, shapes, pairs, pred, **kw):
        c, need = self.real_np(poses, shapes, pairs, pred, **kw)
        if self.failure is None:
            n_len = torch.sqrt((c.normal_a * c.normal_a).sum(-1))
            slot = torch.arange(c.dist.shape[1], device=c.dist.device)
            live = slot[None, :] < c.num_points[:, None]
            pts_ok = ((torch.isfinite(c.points_a).all(-1)
                       & (c.points_a.abs().amax(-1) <= WILD))
                      | ~live).all(-1)
            d_ok = (torch.isfinite(c.dist) | ~live).all(-1)
            bad = c.valid & ~(torch.isfinite(c.normal_a).all(-1) & pts_ok
                              & d_ok & ((n_len - 1).abs() <= UNIT_TOL))
            if bool(bad.any()):
                rows, bodies = [], []
                for i in torch.nonzero(bad)[:6, 0].tolist():
                    a, b = int(c.body_a[i]), int(c.body_b[i])
                    bodies.append((a, b))
                    rows.append(
                        f"pair {i} bodies {a}/{b} tags "
                        f"{int(shapes.tag[a])}/{int(shapes.tag[b])} normal "
                        f"{c.normal_a[i].tolist()} |n| {float(n_len[i])} "
                        f"dist {c.dist[i].tolist()} points "
                        f"{int(c.num_points[i])}: "
                        f"{c.points_a[i].tolist()}")
                self.failure = ("narrow_phase", int(bad.sum()), rows)
                self.context = (poses, shapes, bodies)
        return c, need

    def solve(self, bodies, mprops, contacts, params, **kw):
        out = self.real_solve(bodies, mprops, contacts, params, **kw)
        if self.failure is None:
            poses, vels = out[0], out[1]
            ok = _finite(poses.rotation, poses.translation, vels.linear,
                         vels.angular)
            if not bool(ok.all()):
                bad = torch.nonzero(~ok)[:, 0]
                self.failure = ("solve", int(bad.numel()),
                                [f"bodies {bad[:10].tolist()}"])
        return out

    def __enter__(self):
        self.real_np, self.real_solve = pipeline.narrow_phase, pipeline.solve
        pipeline.narrow_phase, pipeline.solve = self.narrow_phase, self.solve
        return self

    def __exit__(self, *exc):
        pipeline.narrow_phase, pipeline.solve = self.real_np, self.real_solve


def probe(per_kind: int, name: str, frames: int, dev: str, out: str,
          params, cap: int, from_cpu: bool) -> None:
    if from_cpu:
        state = state_from_arrays(state_to_arrays(
            primitives3(per_kind, device="cpu")), device=dev)
    else:
        state = primitives3(per_kind, device=dev)
    n = int(state.bodies.poses.translation.shape[0])
    cfg = PipelineConfig(**primitive_configs(n)[name])
    t0 = time.perf_counter()
    with Checks() as checks:
        for f in range(frames):
            prev, prev_cfg = state, cfg
            state, cfg = step_checked(state, params, cfg)
            if checks.failure is not None:
                stage, count, rows = checks.failure
                path = os.path.join(out, f"prim_nan_{per_kind}_{name}"
                                    f"_cap{cap}.npz")
                np.savez_compressed(path, frame=np.int64(f),
                                    epa_cap=np.int64(cap), **{
                    "config_json": np.asarray(json.dumps(
                        dataclasses.asdict(prev_cfg)))},
                    **state_to_arrays(prev))
                print(f"  primitives3({per_kind}) {name}: frame {f}, "
                      f"{stage}: {count} bad; state before saved to {path}",
                      flush=True)
                for r in rows:
                    print(f"    {r}", flush=True)
                return
    y = state.bodies.poses.translation[1:, 1]
    print(f"  primitives3({per_kind}) {name}: {frames} frames clean, lowest "
          f"centre {float(y.min()):.4f}, {time.perf_counter() - t0:.1f} s",
          flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--sizes", type=int, nargs="*", default=[100, 150, 300])
    ap.add_argument("--configs", nargs="*", default=["ladder", "fused"])
    ap.add_argument("--epa-cap", type=int, default=256)
    ap.add_argument("--from-cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    args = ap.parse_args()
    if args.epa_cap != 256:
        narrow_mod.pfm_contact = functools.partial(gjk.pfm_contact,
                                                   epa_cap=args.epa_cap)
    os.makedirs(args.out, exist_ok=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    params = SimParams()
    for per_kind in args.sizes:
        for name in args.configs:
            probe(per_kind, name, args.frames, args.device, args.out, params,
                  args.epa_cap, args.from_cpu)


if __name__ == "__main__":
    main()
