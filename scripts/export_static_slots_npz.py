"""Export the JAX package's static pair slots (``gs_static_slots``) as a
JAX-free file, ``artifacts/static_slots_jax.npz.xz``
(``export_box_npz.savez_xz``), read by ``tests/test_torch_static_slots.py``
and ``chip_smoke.py``.

Groups (``--only`` rewrites one, keeping the other's arrays):

- ``pit``: the settled 10k pit of ``bench.physics_steady_setup(10_000)``
  under the bench's ``chained_ss`` (its ``ladder`` with the chained sweep,
  the rhs in the rung, pair slots and static slots), warmed by six
  ``step_checked`` frames from the settled state, then three reference
  frames from the settled state under the warmed configuration, as
  ``scripts/export_pit_npz.py`` makes the ``chained_ps`` references:
  ``pit.initial_config_json`` (the bench's, before the warmup),
  ``pit.config_json`` (warmed), ``pit.ref.<f>.offset`` (translations less
  the settled state's), ``pit.ref.<f>.{pair_count,config_json,slot_flag,
  tail_rows}``. JAX's own distances: ``pit.ladder_dp.<f>`` and
  ``pit.ps_dp.<f>`` (max |dp| of reference frame f to the ``ladder`` and
  ``chained_ps`` reference frames in ``ball_pit10k_ladder.npz`` /
  ``ball_pit10k_settled.npz``), and the bench's short gate from the warmed
  ``chained_ss`` state (three ``step`` s of ``chained_ss`` against three
  of the warmed ``ladder`` and of ``chained_ps``):
  ``pit.short_gate.{ladder,chained_ps}``.
- ``balls``: ``tests/test_gs_chained.py``'s ``balls(256)`` A/B
  configuration. ``balls.ss30.translation`` / ``balls.dyn30.translation``:
  30 ``step_checked`` frames from the built scene with static and with
  dynamic pair slots. ``balls.warmed.*`` / ``balls.config_json``: the
  static run's state and configuration after them. Then six frames from
  it, the third forcing a full broad-phase refresh, the fifth a repair and
  the sixth a cache hit: ``balls.frame.<f>.{config_in,config_json,
  pair_count,translation,body_a,body_b,valid,colors,slot_flag}``. Last
  the two edge cases from the warmed state, one ``step`` each and then one
  ``step_checked``: ``balls.narrow.*`` (rungs of 32: classes overflow
  into the tail) and ``balls.overflow.*`` (narrower rungs and the least
  capacity static placement takes, ``overflow_change``: the tail outgrows
  its segment, the pair count turns negative and the capacity regrows),
  each with ``config_in``, the step's ``pair_count``,
  ``body_a``, ``body_b``, ``valid``, ``colors``, ``slot_flag`` and the
  checked frame's ``checked.pair_count`` / ``checked.config_json``.

Runs on the CPU (``pit`` ~10 min, ``balls`` ~3 min)::

    JAX_PLATFORMS=cpu python scripts/export_static_slots_npz.py \
        [--only pit|balls]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_compilation_cache_dir",
                  os.path.join(ROOT, ".jax_cache_cpu"))

import numpy as np  # noqa: E402

from export_box_npz import savez_xz  # noqa: E402
from wgmath_tpu.dynamics import SimParams  # noqa: E402
from wgmath_tpu.pipeline import PipelineConfig, step, step_checked  # noqa: E402
from wgmath_tpu_torch.convert import load_arrays, state_to_arrays  # noqa: E402

OUT = os.path.join(ROOT, "artifacts", "static_slots_jax.npz.xz")
WARM_FRAMES = 6
REF_FRAMES = 3
SHORT_GATE_STEPS = 3
# balls(256): tests/test_gs_chained.py's static-against-dynamic A/B
BALLS_BASE = dict(pair_capacity=4096, contact_capacity=2048, max_colors=16,
                  manifold_points=1, bp_algo="grid", bp_slack=0.03,
                  gs_cmax=2048, gs_windows=(128,) * 16, gs_chained=True,
                  gs_rhs_in_rung=True, gs_pair_slots=True)
BALLS_FRAMES = 30
# the frames after the warmup: None = natural, else the forced path
BALLS_FORCE = (None, None, "miss", None, "repair", "hit")
NARROW = dict(gs_windows=(32,) * 16)


def overflow_change(valid: np.ndarray, colors: np.ndarray,
                    max_colors: int) -> dict:
    """Equal rungs of w and ``pair_capacity`` = 16·w + 256 (the least
    static placement takes) such that the pairs fit the capacity but the
    tail does not fit its segment, from the narrow step's pair list and
    colours: the narrowest such w of 8, 16, 32, 64."""
    n_pairs = int(valid.sum())
    occ = np.bincount(colors[valid], minlength=max_colors + 1)[1:]
    for w in (8, 16, 32, 64):
        total = max_colors * w
        fits = int(np.minimum(occ, w).sum())
        if n_pairs <= total + 256 < n_pairs - fits + total:
            return dict(gs_windows=(w,) * max_colors,
                        pair_capacity=total + 256)
    raise RuntimeError(f"no rung width overflows the tail: {n_pairs} pairs, "
                       f"classes {occ.tolist()}")


def _json(cfg) -> np.ndarray:
    return np.asarray(json.dumps(dataclasses.asdict(cfg)))


def _layout(arrays: dict, prefix: str, state) -> None:
    """The cached pair list and its colour tag, integers."""
    p = state.bp_pairs
    for k, v in (("body_a", p.body_a), ("body_b", p.body_b),
                 ("valid", p.valid), ("colors", state.bp_colors[0])):
        arrays[f"{prefix}.{k}"] = np.asarray(v)
    arrays[f"{prefix}.slot_flag"] = np.asarray(int(state.bp_colors[3]))


def _tail_rows(state, cfg) -> int:
    total = sum(cfg.gs_windows[:cfg.max_colors])
    return int(np.asarray(state.bp_pairs.valid)[total:].sum())


def export_pit(arrays: dict, t0: float) -> None:
    import bench

    state0, params, _, ladder = bench.physics_steady_setup(10_000)
    rep = dataclasses.replace
    cfg = rep(ladder, gs_chained=True, gs_rhs_in_rung=True,
              gs_pair_slots=True, gs_static_slots=True)
    arrays["pit.initial_config_json"] = _json(cfg)
    st = state0
    for f in range(WARM_FRAMES):
        st, cfg = step_checked(st, params, cfg)
        print(f"pit warm frame {f}: pair_count[:5]="
              f"{np.asarray(st.pair_count)[:5].tolist()} pair_capacity "
              f"{cfg.pair_capacity} ({time.time() - t0:.0f} s)", flush=True)
    warm_state, warm_cfg = st, cfg
    arrays["pit.config_json"] = _json(cfg)
    tr0 = np.asarray(state0.bodies.poses.translation)
    z_ps = load_arrays(os.path.join(ROOT, "artifacts",
                                    "ball_pit10k_settled.npz"))
    z_lad = load_arrays(os.path.join(ROOT, "artifacts",
                                     "ball_pit10k_ladder.npz"))
    ref, c = state0, cfg
    for f in range(REF_FRAMES):
        ref, c = step_checked(ref, params, c)
        tr = np.asarray(ref.bodies.poses.translation)
        p = f"pit.ref.{f}"
        arrays[f"{p}.offset"] = tr - tr0
        arrays[f"{p}.pair_count"] = np.asarray(ref.pair_count, np.int32)
        arrays[f"{p}.config_json"] = _json(c)
        arrays[f"{p}.slot_flag"] = np.asarray(int(ref.bp_colors[3]))
        arrays[f"{p}.tail_rows"] = np.asarray(_tail_rows(ref, c))
        for key, z in (("ladder_dp", z_lad), ("ps_dp", z_ps)):
            dp = float(np.abs(tr - z[f"ref.{f}.translation"]).max())
            arrays[f"pit.{key}.{f}"] = np.asarray(dp)
        print(f"pit reference frame {f}: pair_count[:5]="
              f"{np.asarray(ref.pair_count)[:5].tolist()} flag "
              f"{int(ref.bp_colors[3])} tail rows {_tail_rows(ref, c)}; "
              f"max|dp| to ladder {float(arrays[f'pit.ladder_dp.{f}']):.3e}, "
              f"to chained_ps {float(arrays[f'pit.ps_dp.{f}']):.3e} "
              f"({time.time() - t0:.0f} s)", flush=True)
    # the bench's short gate, from the warmed chained_ss state
    lad_st, lad_cfg = state0, ladder
    for _ in range(WARM_FRAMES):
        lad_st, lad_cfg = step_checked(lad_st, params, lad_cfg)
    ps_cfg = PipelineConfig(**{
        k: tuple(v) if k == "gs_windows" else v
        for k, v in json.loads(str(z_ps["config_json"])).items()})

    def run3(c):
        s = warm_state
        for _ in range(SHORT_GATE_STEPS):
            s = step(s, params, c)
        return np.asarray(s.bodies.poses.translation)

    p_ss = run3(warm_cfg)
    for name, c in (("ladder", lad_cfg), ("chained_ps", ps_cfg)):
        err = float(np.abs(p_ss - run3(c)).max())
        arrays[f"pit.short_gate.{name}"] = np.asarray(err)
        print(f"pit short gate: chained_ss vs {name} over "
              f"{SHORT_GATE_STEPS} steps from the warmed chained_ss state: "
              f"max|dp| {err:.3e} ({time.time() - t0:.0f} s)", flush=True)


def export_balls(arrays: dict, t0: float) -> None:
    from wgmath_tpu.scenes.builders import balls

    params = SimParams()
    base = PipelineConfig(**BALLS_BASE)
    cs = dataclasses.replace(base, gs_static_slots=True)
    sa, sb, ca, cb = balls(256), balls(256), base, cs
    for _ in range(BALLS_FRAMES):
        sa, ca = step_checked(sa, params, ca)
        sb, cb = step_checked(sb, params, cb)
    arrays["balls.dyn30.translation"] = np.asarray(
        sa.bodies.poses.translation)
    arrays["balls.ss30.translation"] = np.asarray(sb.bodies.poses.translation)
    for k, v in state_to_arrays(sb).items():
        arrays[f"balls.warmed.{k}"] = v
    arrays["balls.config_json"] = _json(cb)
    dp = np.abs(arrays["balls.dyn30.translation"]
                - arrays["balls.ss30.translation"]).max()
    print(f"balls warmed: pair_count[:5]="
          f"{np.asarray(sb.pair_count)[:5].tolist()} static vs dynamic "
          f"max|dp| {dp:.3e} ({time.time() - t0:.0f} s)", flush=True)
    warm_state, warm_cfg = sb, cb
    s, c = sb, cb
    for f, force in enumerate(BALLS_FORCE):
        c_in = dataclasses.replace(c, bp_force=force)
        s, c = step_checked(s, params, c_in)
        c = dataclasses.replace(c, bp_force=None)
        p = f"balls.frame.{f}"
        arrays[f"{p}.config_in"] = _json(c_in)
        arrays[f"{p}.config_json"] = _json(c)
        arrays[f"{p}.pair_count"] = np.asarray(s.pair_count)
        arrays[f"{p}.translation"] = np.asarray(s.bodies.poses.translation)
        _layout(arrays, p, s)
        print(f"balls frame {f} ({force}): pair_count[:5]="
              f"{np.asarray(s.pair_count)[:5].tolist()} tail rows "
              f"{_tail_rows(s, c)} ({time.time() - t0:.0f} s)", flush=True)
    change = NARROW
    for name in ("narrow", "overflow"):
        if name == "overflow":
            change = overflow_change(arrays["balls.narrow.valid"],
                                     arrays["balls.narrow.colors"],
                                     warm_cfg.max_colors)
        c_in = dataclasses.replace(warm_cfg, bp_force="miss", **change)
        p = f"balls.{name}"
        arrays[f"{p}.config_in"] = _json(c_in)
        s = step(warm_state, params, c_in)
        arrays[f"{p}.pair_count"] = np.asarray(s.pair_count)
        _layout(arrays, p, s)
        s2, c2 = step_checked(warm_state, params, c_in)
        arrays[f"{p}.checked.pair_count"] = np.asarray(s2.pair_count)
        arrays[f"{p}.checked.config_json"] = _json(c2)
        print(f"balls {name}: pair_count[:5]="
              f"{np.asarray(s.pair_count)[:5].tolist()} tail rows "
              f"{_tail_rows(s, c_in)}; checked: pair_capacity "
              f"{c2.pair_capacity} windows {c2.gs_windows[:4]} "
              f"({time.time() - t0:.0f} s)", flush=True)


GROUPS = {"pit": export_pit, "balls": export_balls}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=sorted(GROUPS), default=None)
    only = ap.parse_args().only
    t0 = time.time()
    arrays = {}
    if only is not None and os.path.exists(OUT):
        arrays = {k: v for k, v in load_arrays(OUT).items()
                  if not k.startswith(only + ".")}
    for name, fn in GROUPS.items():
        if only in (None, name):
            fn(arrays, t0)
    savez_xz(OUT, arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
