"""The primitive rain's EPA batch at 10,000 bodies, and what a larger one
gives (ROADMAP C8). From ``primitives3``'s first state under
``primitive_configs``' ``fused``, the support-mapped kernel run eagerly so
that each batch can be read:

1. ``primitives3(2000)`` under the reference's ``epa_cap`` of 256 for
   ``--frames`` frames: per frame the EPA demand, the lowest centre and the
   bodies below the ground. At ``--dump-frame`` the EPA inputs of every
   core-overlapping pair EPA ran on, and the port's EPA outputs on them, go
   to ``<out>/epa10k_pairs.npz`` (``scripts/check_epa_10k.py`` runs the
   JAX package's EPA on them on the CPU).
2. The same run with ``epa_cap`` 16,384, above the demand (not the
   reference's semantics). After every support-mapped batch the EPA,
   ``pfm_contact`` and manifold outputs of the active pairs are checked;
   the first non-finite one stops the run, and that batch's inputs go to
   ``<out>/epa10k_nonfinite.npz``. Otherwise the same figures as in 1.
3. ``primitives3(per_kind)`` for each of ``--sizes`` under the reference's
   cap, the kernel replayed as a CUDA graph (the port's default): the
   largest EPA demand, the bodies below the ground and the share of contact
   points deeper than 0.1 m after ``--frames`` frames.

Run from the repository root on a machine with the card::

    python3 scripts/probe_epa_10k.py

``--device cpu --per-kind 8 --frames 6 --dump-frame 4 --sizes 4`` runs the
same logic at a small size on the CPU.
"""

from __future__ import annotations

import importlib
import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from wgmath_tpu_torch.convert import state_from_arrays, state_to_arrays  # noqa: E402
from wgmath_tpu_torch.dynamics.sim_params import SimParams  # noqa: E402
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked  # noqa: E402
from wgmath_tpu_torch.queries import epa as epa_mod  # noqa: E402
from wgmath_tpu_torch.queries import gjk  # noqa: E402
narrow_mod = importlib.import_module(
    "wgmath_tpu_torch.queries.narrow_phase")
from wgmath_tpu_torch.scenes.builders import (  # noqa: E402
    primitive_configs,
    primitives3,
)

REF_CAP, BIG_CAP = 256, 16384
DEEP = 0.1


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


class Probe:
    """Wraps the narrow phase's ``pfm_contact`` and ``pfm_manifold`` and
    the EPA with ``epa_cap`` set to ``cap``; keeps the last batch's inputs
    and outputs, and (``check``) stops at the first non-finite output of an
    active pair."""

    def __init__(self, cap: int, check: bool, out: str):
        self.cap, self.check, self.out = cap, check, out
        self.last_epa = None
        self.last_pfm = None
        self.demands = []
        self.bad = None

    def epa(self, *args, **kw):
        res = self.real_epa(*args, **kw)
        self.last_epa = (args, res)
        return res

    def pfm_contact(self, tag_a, par_a, pose_a, tag_b, par_b, pose_b,
                    mask=None, **kw):
        res = self.real_pfm(tag_a, par_a, pose_a, tag_b, par_b, pose_b,
                            mask=mask, epa_cap=self.cap, **kw)
        demand = int(res[3])
        self.demands.append(demand)
        self.last_pfm = (tag_a, par_a, pose_a, tag_b, par_b, pose_b, mask)
        if self.check and self.bad is None:
            active = min(demand, self.cap)
            (e_args, (e_n, e_d, e_p)) = self.last_epa
            bad_e = ~(torch.isfinite(e_n).all(-1) & torch.isfinite(e_d)
                      & torch.isfinite(e_p).all(-1))[:active]
            m = mask if mask is not None else torch.ones_like(tag_a, bool)
            bad_c = m & ~(torch.isfinite(res[0]).all(-1)
                          & torch.isfinite(res[1]).all(-1)
                          & torch.isfinite(res[2]))
            if bool(bad_e.any()) or bool(bad_c.any()):
                self.bad = ("epa" if bool(bad_e.any()) else "pfm_contact",
                            int(bad_e.sum()), int(bad_c.sum()))
                self._dump_bad(e_args, (e_n, e_d, e_p), active, bad_e, bad_c)
        return res

    def manifold(self, *args, **kw):
        res = self.real_manifold(*args, **kw)
        if self.check and self.bad is None:
            pts, dist, _ = res
            mask = self.last_pfm[6]
            bad = mask & ~(torch.isfinite(pts).all(-1).all(-1)
                           & torch.isfinite(dist).all(-1))
            if bool(bad.any()):
                self.bad = ("manifold", 0, int(bad.sum()))
                self._dump_bad(*self.last_epa, 0,
                               torch.zeros(0, dtype=torch.bool), bad)
        return res

    def _dump_bad(self, e_args, e_out, active, bad_e, bad_c):
        tag_a, par_a, pose_a, tag_b, par_b, pose_b, mask = self.last_pfm
        ta, pa, tb, pb, r_ab, t_ab = e_args[:6]
        out = {"active": np.int64(active), "bad_epa": _np(bad_e),
               "bad_contact": _np(bad_c)}
        for k, v in (("epa.tag_a", ta), ("epa.par_a", pa), ("epa.tag_b", tb),
                     ("epa.par_b", pb), ("epa.r_ab", r_ab),
                     ("epa.t_ab", t_ab), ("epa.normal", e_out[0]),
                     ("epa.depth", e_out[1]), ("epa.point_a", e_out[2]),
                     ("pfm.tag_a", tag_a), ("pfm.par_a", par_a),
                     ("pfm.tag_b", tag_b), ("pfm.par_b", par_b),
                     ("pfm.mask", mask)):
            out[k] = _np(v)[:active] if k.startswith("epa.") else _np(v)
        for side, pose in (("a", pose_a), ("b", pose_b)):
            out[f"pfm.rot_{side}"] = _np(pose.rotation)
            out[f"pfm.tr_{side}"] = _np(pose.translation)
            out[f"pfm.scale_{side}"] = _np(pose.scale)
        path = os.path.join(self.out, "epa10k_nonfinite.npz")
        np.savez_compressed(path, **out)
        print(f"  non-finite {self.bad}: batch saved to {path}", flush=True)

    def dump_pairs(self, path: str) -> int:
        """The last batch's EPA inputs and outputs on its active slots."""
        (args, (n, d, p)) = self.last_epa
        active = min(self.demands[-1], self.cap)
        keys = ("tag_a", "par_a", "tag_b", "par_b", "r_ab", "t_ab")
        out = {k: _np(v)[:active] for k, v in zip(keys, args[:6])}
        out.update(normal=_np(n)[:active], depth=_np(d)[:active],
                   point_a=_np(p)[:active])
        np.savez_compressed(path, **out)
        return active

    def __enter__(self):
        self.real_epa = epa_mod.epa_penetration
        self.real_pfm = gjk.pfm_contact
        self.real_manifold = narrow_mod.pfm_manifold
        self.real_call = narrow_mod._pfm_call
        epa_mod.epa_penetration = self.epa
        narrow_mod.pfm_contact = self.pfm_contact
        narrow_mod.pfm_manifold = self.manifold
        narrow_mod._pfm_call = narrow_mod._pfm  # eager: batches readable
        return self

    def __exit__(self, *exc):
        epa_mod.epa_penetration = self.real_epa
        narrow_mod.pfm_contact = self.real_pfm
        narrow_mod.pfm_manifold = self.real_manifold
        narrow_mod._pfm_call = self.real_call


def figures(state, depths: bool = False) -> dict:
    """Lowest dynamic centre, bodies below y = 0, all finite, and
    (``depths``) the share of the live contact points of the state's cached
    pairs deeper than ``DEEP``."""
    tr = state.bodies.poses.translation[1:]
    finite = bool(torch.isfinite(state.bodies.poses.translation).all()
                  and torch.isfinite(state.bodies.vels.linear).all())
    out = {"finite": finite, "min_y": float(tr[:, 1].min()),
           "below": int((tr[:, 1] < 0).sum()), "deep_share": float("nan")}
    if depths and finite:
        c, _ = narrow_mod.narrow_phase(state.bodies.poses, state.shapes,
                                       state.bp_pairs,
                                       SimParams().prediction_distance,
                                       p_max=4, with_overflow=True)
        slot = torch.arange(4, device=c.dist.device)
        live = c.valid[:, None] & (slot[None, :] < c.num_points[:, None])
        depth = -c.dist[live]
        out["deep_share"] = (float((depth > DEEP).float().mean())
                             if depth.numel() else 0.0)
    return out


def run_probe(name: str, per_kind: int, cap: int, frames: int, dev: str,
              out: str, params, dump_frame: int = -1, check: bool = False):
    state = state_from_arrays(state_to_arrays(primitives3(per_kind,
                                                          device="cpu")),
                              device=dev)
    n = int(state.bodies.poses.translation.shape[0])
    cfg = PipelineConfig(**primitive_configs(n)["fused"])
    t0 = time.perf_counter()
    with Probe(cap, check, out) as probe:
        for f in range(frames):
            prev = state
            state, cfg = step_checked(state, params, cfg)
            fig = figures(state)
            if f == dump_frame:
                path = os.path.join(out, "epa10k_pairs.npz")
                k = probe.dump_pairs(path)
                print(f"  frame {f}: {k} EPA pairs saved to {path}",
                      flush=True)
            if f % 10 == 9 or probe.bad or not fig["finite"]:
                print(f"  {name} frame {f}: EPA demand "
                      f"{probe.demands[-1]} (cap {cap}), lowest centre "
                      f"{fig['min_y']:.4f}, below ground {fig['below']}, "
                      f"finite {fig['finite']}, "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
            if probe.bad or not fig["finite"]:
                if not fig["finite"] and not probe.bad:
                    np.savez_compressed(
                        os.path.join(out, "epa10k_state_before.npz"),
                        **state_to_arrays(prev))
                print(f"  {name}: stopped at frame {f}: {probe.bad}",
                      flush=True)
                break
    fig = figures(state, depths=True)
    print(f"  {name} end: deeper than {DEEP} m {fig['deep_share']:.4f}, "
          f"EPA demand {min(probe.demands)}..{max(probe.demands)}",
          flush=True)
    return state, probe


def sizes_probe(per_kind: int, frames: int, dev: str, params) -> None:
    for name in ("ladder", "fused"):
        state = primitives3(per_kind, device=dev)
        n = int(state.bodies.poses.translation.shape[0])
        cfg = PipelineConfig(**primitive_configs(n)[name])
        seen = []
        real = narrow_mod._pfm_call

        def wrapped(*a, **kw):
            res = real(*a, **kw)
            seen.append(res[-1])
            return res

        narrow_mod._pfm_call = wrapped
        try:
            t0 = time.perf_counter()
            for _ in range(frames):
                state, cfg = step_checked(state, params, cfg)
        finally:
            narrow_mod._pfm_call = real
        fig = figures(state, depths=True)
        print(f"  primitives3({per_kind}) ({n - 1} bodies) {name}: EPA "
              f"demand at most {int(torch.stack(seen).max())} (cap "
              f"{REF_CAP}), lowest centre {fig['min_y']:.4f}, below ground "
              f"{fig['below']}, deeper than {DEEP} m "
              f"{fig['deep_share']:.4f}, finite {fig['finite']}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--per-kind", type=int, default=2000)
    ap.add_argument("--frames", type=int, default=110)
    ap.add_argument("--dump-frame", type=int, default=90)
    ap.add_argument("--sizes", type=int, nargs="*",
                    default=[40, 100, 150, 200, 300, 400])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out"))
    ap.add_argument("--skip", default="", help="phases to skip, e.g. 12")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), flush=True)
    params = SimParams()
    if "1" not in args.skip:
        print(f"1. primitives3({args.per_kind}), epa_cap {REF_CAP}:",
              flush=True)
        run_probe("ref cap", args.per_kind, REF_CAP, args.frames,
                  args.device, args.out, params, dump_frame=args.dump_frame)
    if "2" not in args.skip:
        print(f"2. primitives3({args.per_kind}), epa_cap {BIG_CAP}:",
              flush=True)
        run_probe("big cap", args.per_kind, BIG_CAP, args.frames,
                  args.device, args.out, params, check=True)
    if "3" not in args.skip:
        print(f"3. sizes under epa_cap {REF_CAP}, {args.frames} frames:",
              flush=True)
        for per_kind in args.sizes:
            sizes_probe(per_kind, args.frames, args.device, params)


if __name__ == "__main__":
    main()
