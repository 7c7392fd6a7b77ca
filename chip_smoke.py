"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Three phases; any failed check ends the run with a non-zero exit:

1. setup: the card's name and power limit, torch/CUDA versions, and the
   build of every hand-written kernel from ``wgmath_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. kernel: each kernel's wrapper against its plain PyTorch version on the
   card, on seeded random inputs at the main path's shapes (max abs error,
   tolerance, device time per launch);
3. path: the settled 10k-body ball pit (``artifacts/ball_pit10k_settled
   .npz``) stepped with ``step_checked`` under its stored ``chained_ps``
   configuration, frame by frame against the JAX package's reference frames
   stored beside it, then timed over further frames.

The last lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.core import cuda_build, dispatch
from wgmath_tpu_torch.dynamics import gs_math
from wgmath_tpu_torch.dynamics.gs_math import pack_meta
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked

ROOT = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(ROOT, "artifacts", "ball_pit10k_settled.npz")

# NVIDIA H100 SXM data sheet: HBM3 rate and dense f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the JAX package's own tolerance for this math (tests/test_physics.py)
RTOL, ATOL = 1e-4, 1e-5
KERNEL_SOURCES = ("gs_math",)
# frame-by-frame limits against the JAX reference: GS sums reorder on the
# card, and a pure reordering alone moves velocities by ~3e-5 after one
# step at 10k and ~3e-4 after two
TRANSLATION_LIMITS = (1e-4, 1e-3, 1e-3)
COUNT_REL_LIMIT = 1e-3
TIMED_FRAMES = 30
N_STATIC = 5  # ground + four walls lead the pit's body table
BALL_RADIUS = 0.5


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def device_times_ms(fn, n: int = 25, warmup: int = 3) -> list[float]:
    """Device time of each of ``n`` calls of ``fn`` by CUDA events. Each
    call is queued behind a busy-wait kernel longer than the call's
    host-side enqueue, so host overhead between its launches does not
    count (one call at a time: a call of many small ops must not fill the
    device's launch queue)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(min(2.0 * (time.perf_counter() - t0) + 2e-4, 1.0) * 2e9)
    pairs = []
    for _ in range(n):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


# ---------------------------------------------------------------------------
# gs_math: inputs, bytes and operations
# ---------------------------------------------------------------------------

# per contact point, counted from the kernel's arithmetic: rhs rebuild
# (two mul_pt, drift, dist, bias, two tangent rhs) and the PGS update
# (normal + coupled 2x2 friction projection); 12 more per row for d1/d2
GS_FLOPS_RHS, GS_FLOPS_UPDATE, GS_FLOPS_ROW = 103, 186, 12


def gs_math_inputs(rng: np.random.Generator, L: int, p_max: int, mode: str,
                   device) -> tuple[tuple, dict]:
    """Seeded random inputs for ``gs_math_block_rhs`` laid out as the
    chained sweep lays them out: the window is a row slice of a wider
    field matrix, both sides' velocities and poses are column views of one
    gathered [2L, 14] stream block, the impulses column views of the merged
    impulse matrix. The fields are a real contact's, as the constraint
    builder makes them: unit normal and tangents, lever arms, torque
    directions, inverse inertias and the effective masses derived from
    them (so each PGS update is the contraction it is in a solve), both
    anchors on nearly the same world point (millimetre drift)."""
    s_len = 2
    meta = pack_meta(p_max, s_len)
    k = sum(int(np.prod(t)) if t else 1 for _, t in meta.values())
    win = rng.normal(size=(L, k + 7)).astype(np.float32)

    def put(name, vals):
        at, _ = meta[name]
        vals = vals.reshape(L, -1)
        win[:, at:at + vals.shape[1]] = vals

    def u(lo, hi, *shape):
        return rng.uniform(lo, hi, (L,) + shape)

    def dot(a, b):
        return np.sum(a * b, axis=-1)

    n = rng.normal(size=(L, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    t0 = np.cross(n, rng.normal(size=(L, 3)))
    t0 /= np.linalg.norm(t0, axis=-1, keepdims=True)
    tang = np.stack([t0, np.cross(n, t0)], 1)  # [L, S, 3]
    im_a = np.repeat(u(0.0, 2.0, 1), 3, 1)
    im_b = np.repeat(u(0.0, 2.0, 1), 3, 1)
    ii_a, ii_b = u(0.0, 3.0, 1, 3), u(0.0, 3.0, 1, 3)
    arm_a, arm_b = u(-0.5, 0.5, p_max, 3), u(-0.5, 0.5, p_max, 3)
    nn = np.broadcast_to(n[:, None], arm_a.shape)
    td_a, td_b = np.cross(arm_a, nn), np.cross(arm_b, -nn)
    iitd_a, iitd_b = ii_a * td_a, ii_b * td_b
    ims = (im_a + im_b)[:, None]
    n_r = 1.0 / (dot(nn, ims * nn) + dot(iitd_a, td_a) + dot(iitd_b, td_b))
    tt = np.broadcast_to(tang[:, None], (L, p_max, s_len, 3))
    ttd_a = np.cross(arm_a[:, :, None], tt)
    ttd_b = np.cross(arm_b[:, :, None], -tt)
    tii_a, tii_b = ii_a[:, :, None] * ttd_a, ii_b[:, :, None] * ttd_b
    r_j = (dot(tt, ims[:, :, None] * tt) + dot(tii_a, ttd_a)
           + dot(tii_b, ttd_b))  # [L, P, S]
    r_x = 2.0 * (dot(ttd_a[:, :, 0], tii_a[:, :, 1])
                 + dot(ttd_b[:, :, 0], tii_b[:, :, 1]))
    for name, vals in (("dir_a", n), ("tangent_a", tang), ("im_a", im_a),
                       ("im_b", im_b), ("limit", u(0.0, 1.0, 1)),
                       ("n_torque_a", td_a), ("n_torque_b", td_b),
                       ("n_ii_torque_a", iitd_a), ("n_ii_torque_b", iitd_b),
                       ("n_r", n_r), ("t_torque_a", ttd_a),
                       ("t_torque_b", ttd_b), ("t_ii_torque_a", tii_a),
                       ("t_ii_torque_b", tii_b),
                       ("t_r", np.concatenate([r_j, r_x[..., None]], -1)),
                       ("t_rhs_wo_bias", u(-0.1, 0.1, p_max, s_len))):
        put(name, vals)
    put("info_dist", u(-0.05, 0.02, p_max))
    put("info_normal_vel", u(-1.0, 1.0, p_max))
    pp = rng.normal(size=(2 * L, 14)).astype(np.float32)
    q = rng.normal(size=(2 * L, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pp[:, 6:10] = q
    pp[:, 10:13] = rng.uniform(-20.0, 20.0, (2 * L, 3))
    pp[:, 13] = 1.0
    # local anchors of one world point per contact point on both bodies
    world = pp[:L, 10:13][:, None] + rng.uniform(-0.5, 0.5, (L, p_max, 3))
    for side, name in ((0, "local_pt_a"), (1, "local_pt_b")):
        rows = slice(side * L, (side + 1) * L)
        qs, ts = q[rows][:, None], pp[rows, 10:13][:, None]
        d = world + rng.normal(scale=1e-3, size=world.shape) - ts
        u_, w_ = -qs[..., :3], qs[..., 3:]  # rotate by the conjugate
        c = np.cross(u_, d)
        put(name, d + 2.0 * (w_ * c + np.cross(u_, c)))
    imp = rng.uniform(0.0, 0.5, (L, p_max * 4)).astype(np.float32)
    num_points = rng.integers(0, p_max + 1, L)
    active = rng.random(L) > 0.2

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    win_t, pp_t, imp_t = t(win), t(pp), t(imp)
    p1, p2 = pp_t[:L], pp_t[L:]
    pt = p_max * s_len
    args = (win_t[:, :k], meta, t(num_points.astype(np.int64)), t(active),
            p1[:, :6], p2[:, :6], imp_t[:, :p_max],
            imp_t[:, p_max:p_max + pt].reshape(L, p_max, s_len))
    kw = dict(mode=mode, consts=(240.0, 175.3, 1e-3, 10.0, 0.93),
              p_max=p_max, s_len=s_len)
    if mode == "biased":
        kw.update(pose1=p1[:, 6:], pose2=p2[:, 6:])
    else:
        kw.update(n_rhs_wo=imp_t[:, p_max + pt:])
    return args, kw


def gs_math_work(L: int, p_max: int, mode: str) -> tuple[int, int]:
    """(bytes, flops) one launch needs: each input read once, each output
    written once."""
    s_len = 2
    biased = mode == "biased"
    pack = sum(int(np.prod(t)) if t else 1
               for _, t in pack_meta(p_max, s_len).values())
    relin = 8 * p_max  # local_pt_a/b, info_dist, info_normal_vel
    cols = pack - (0 if biased else relin)
    row_in = 4 * (cols + 12 + p_max * (1 + s_len)) + 8 + 1
    row_in += 4 * 16 if biased else 4 * p_max
    row_out = 4 * (p_max * (1 + s_len) + 12 + (p_max if biased else 0))
    flops = GS_FLOPS_ROW + p_max * (GS_FLOPS_UPDATE
                                    + (GS_FLOPS_RHS if biased else 0))
    return L * (row_in + row_out), L * flops


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / F32_FLOP_PER_S
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def setup_phase() -> dict:
    smi = nvidia_smi_line()
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # the port's float32 math is plain float32 everywhere
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_build.build_all(KERNEL_SOURCES)
    wall = time.perf_counter() - t0
    for name in KERNEL_SOURCES:
        print(f"built {name}.cu in {cuda_build.BUILD_SECONDS[name]:.2f} s")
        for line in cuda_build.BUILD_LOG.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"kernel build wall time {wall:.2f} s")
    return {"nvidia_smi": smi, "build_s": wall}


def kernel_phase(ladder: tuple) -> dict:
    """gs_math against its plain version at the listed shapes and at every
    rung of the main path's ladder, both modes. Returns the kernel's
    summary over one substep of the ladder (every rung, both modes)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(20260)
    shapes = [(128, 1), (1024, 1), (4096, 1), (1024, 4)]
    shapes += [(w, 1) for w in sorted(set(ladder)) if w
               and (w, 1) not in shapes]
    rows = {}
    max_err = 0.0
    for L, p_max in shapes:
        for mode in ("biased", "unbiased"):
            args, kw = gs_math_inputs(rng, L, p_max, mode, dev)
            got = gs_math.gs_math_block_rhs(*args, **kw)
            want = gs_math._gs_math_rhs_torch(*args, **kw)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            # worst |diff| / (atol + rtol |plain|): allclose holds at <= 1
            ratio = max(float(((g - w).abs() / (ATOL + RTOL * w.abs()))
                              .max()) for g, w in zip(got, want))
            close = ratio <= 1.0
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            max_err = max(max_err, err)
            k_ms = statistics.median(device_times_ms(
                lambda: gs_math.gs_math_block_rhs(*args, **kw)))
            p_ms = statistics.median(device_times_ms(
                lambda: gs_math._gs_math_rhs_torch(*args, **kw)))
            nbytes, flops = gs_math_work(L, p_max, mode)
            b_ms, _ = bound_ms(nbytes, flops)
            rows[(L, p_max, mode)] = (k_ms, p_ms, b_ms, nbytes, flops)
            print(f"gs_math L={L:5d} P={p_max} {mode:8s} max|d|={err:.3e} "
                  f"tol-ratio {ratio:.3f} (rtol {RTOL}, atol {ATOL}) "
                  f"kernel {k_ms * 1e3:8.2f} us "
                  f"plain {p_ms * 1e3:9.2f} us bound {b_ms * 1e3:6.2f} us "
                  f"({nbytes / max(k_ms, 1e-9) / 1e6:7.1f} GB/s)")
            check(close and finite,
                  f"gs_math L={L} P={p_max} {mode}: kernel disagrees with "
                  f"its plain version (max abs diff {err:.3e})")
    rungs = [w for w in ladder if w]
    sub = [rows[(w, 1, m)] for w in rungs for m in ("biased", "unbiased")]
    nbytes = sum(r[3] for r in sub)
    flops = sum(r[4] for r in sub)
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"max_abs_err": max_err, "ms": sum(r[0] for r in sub),
            "plain_ms": sum(r[1] for r in sub), "bound_ms": b_ms,
            "bound_by": b_by, "work": f"one substep of the main path: "
            f"{len(rungs)} rungs ({sum(rungs)} rows) x 2 modes, P=1"}


def _envelopes(state) -> tuple[float, float]:
    """Kinetic-energy proxy (sum |v|^2; the pit's balls share one mass)
    and the deepest ball-ball penetration over the cached pair list."""
    vel = state.bodies.vels.linear
    ke = float((vel * vel).sum())
    tr = state.bodies.poses.translation
    p = state.bp_pairs
    both = p.valid & (p.body_a >= N_STATIC) & (p.body_b >= N_STATIC)
    d = torch.linalg.norm(tr[p.body_a] - tr[p.body_b], dim=-1)
    pen = torch.where(both, 2.0 * BALL_RADIUS - d, torch.zeros_like(d))
    return ke, max(float(pen.max()), 0.0)


def _finite(state) -> bool:
    b = state.bodies
    return all(bool(torch.isfinite(x).all()) for x in
               (b.poses.translation, b.poses.rotation, b.vels.linear,
                b.vels.angular))


def path_phase(frames: int):
    """Reference frames against the JAX package's, then ``frames`` timed
    frames. Returns (metrics, state, config, params)."""
    z = dict(np.load(NPZ))
    params = SimParams()
    cfg = PipelineConfig.from_dict(json.loads(str(z["config_json"])))
    state = state_from_arrays(z, device="cuda")
    n_ref = sum(1 for k in z if k.startswith("ref.")
                and k.endswith(".translation"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # every count starts at 0 just before the main path runs
    gs_math.LAUNCHES = 0
    dispatch.HOST_SYNCS = 0
    for f in range(n_ref):
        t0 = time.perf_counter()
        state, cfg = step_checked(state, params, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        pc = state.pair_count.cpu().numpy()
        ref_pc = z[f"ref.{f}.pair_count"]
        tr = state.bodies.poses.translation.cpu().numpy()
        d_tr = float(np.abs(tr - z[f"ref.{f}.translation"]).max())
        d_v = float(np.abs(state.bodies.vels.linear.cpu().numpy()
                           - z[f"ref.{f}.linear"]).max())
        rel = [abs(int(pc[i]) - int(ref_pc[i])) / max(abs(int(ref_pc[i])), 1)
               for i in (0, 1)]
        print(f"reference frame {f}: pairs {pc[0]} (ref {ref_pc[0]}) "
              f"contacts {pc[1]} (ref {ref_pc[1]}) bp_path {pc[3]} "
              f"max|dx| {d_tr:.3e} (limit {TRANSLATION_LIMITS[f]:.0e}) "
              f"max|dv| {d_v:.3e} host {dt * 1e3:.1f} ms")
        check(_finite(state), f"reference frame {f}: non-finite state")
        check(max(rel) <= COUNT_REL_LIMIT,
              f"reference frame {f}: pair/contact counts off by "
              f"{max(rel):.2e} (limit {COUNT_REL_LIMIT})")
        check(d_tr <= TRANSLATION_LIMITS[f],
              f"reference frame {f}: translations off by {d_tr:.3e}")

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    counts = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(frames):
        state, cfg = step_checked(state, params, cfg)
        counts.append(state.pair_count)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches, syncs = gs_math.LAUNCHES, dispatch.HOST_SYNCS
    total_frames = n_ref + frames
    check(_finite(state), "timed frames: non-finite state")
    check(launches > 0, "gs_math kernel was never launched on the path")
    counts = [c.cpu().numpy() for c in counts]
    mc = cfg.max_colors
    colours = max(int(np.count_nonzero(c[9:9 + mc])) for c in counts)
    ke, pen = _envelopes(state)
    ms = start.elapsed_time(end) / frames
    return {
        "frames_timed": frames, "ms_per_step": ms,
        "steps_per_s": 1e3 / ms, "host_ms_per_step": 1e3 * host_s / frames,
        "pairs": int(counts[-1][0]), "contacts": int(counts[-1][1]),
        "colours_in_use": colours,
        "bp_path_mix": {name: sum(int(c[3]) == i for c in counts)
                        for i, name in enumerate(("hit", "repair", "full"))},
        "host_syncs_per_step": syncs / total_frames,
        "gs_math_launches": launches,
        "gs_math_launches_per_step": launches / total_frames,
        "kinetic_energy": ke, "max_penetration": pen,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ladder": [w for w in cfg.gs_windows if w],
    }, state, cfg, params


def profile_window(state, cfg, params, frames: int = 3) -> dict:
    """Device time by kernel and host time by operator over a short
    steady window (informational: the checked numbers come from the
    phases above)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the profiler's one-cycle notice
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(frames):
                state, cfg = step_checked(state, params, cfg)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        averages = prof.key_averages()
    rows, host = [], []
    for e in averages:
        if getattr(e, "device_type", None) == DeviceType.CUDA:
            # kernels only: an operator's row repeats its kernels' time
            dev_us = getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0.0))
            if dev_us:
                rows.append((dev_us, e.count, e.key))
        elif e.key.startswith("aten::"):
            host.append((e.self_cpu_time_total, e.count, e.key))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    total = sum(r[0] for r in rows)
    return {"device_ms_per_step": total / 1e3 / frames,
            "profiled_wall_ms_per_step": wall_ms / frames,
            "device_busy_share": total / 1e3 / wall_ms,
            "kernels_per_step": sum(r[1] for r in rows) / frames,
            "top": [{"name": k[:60], "ms_per_step": us / 1e3 / frames,
                     "calls_per_step": c / frames}
                    for us, c, k in rows[:12]],
            "host_aten_ms_per_step": sum(h[0] for h in host) / 1e3 / frames,
            "host_top": [{"name": k, "ms_per_step": us / 1e3 / frames,
                          "calls_per_step": c / frames}
                         for us, c, k in host[:10]]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "GPU", file=sys.stderr)
        return 1
    try:
        setup = setup_phase()
        cfg0 = json.loads(str(np.load(NPZ)["config_json"]))
        ladder = tuple(cfg0["gs_windows"][:cfg0["max_colors"]])
        summary = kernel_phase(ladder)
        path, state, cfg, params = path_phase(TIMED_FRAMES)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    try:
        path["profile"] = profile_window(state, cfg, params)
    except Exception as e:  # the profiler is untried on this machine
        path["profile"] = f"not measured ({type(e).__name__}: {e})"
    print(json.dumps({"path": path}))
    print(setup["nvidia_smi"])
    kernels = [{
        "name": "gs_math_rhs", "route": "cuda",
        "source": "wgmath_tpu_torch/csrc/gs_math.cu",
        "replaces": "wgmath_tpu/dynamics/gs_pallas.py:330",
        "tpu_source": "dynamics/gs_pallas.py:_gs_math_rhs_pallas_call",
        "launches": path["gs_math_launches"],
        "launches_per_step": path["gs_math_launches_per_step"],
        "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
        "plain_ms": summary["plain_ms"], "bound_ms": summary["bound_ms"],
        "bound_by": summary["bound_by"], "library_ms": None,
        "work": summary["work"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
