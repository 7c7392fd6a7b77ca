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
   .npz``) stepped with ``step_checked`` under four solver configurations
   of the bench: ``chained_ps`` and ``ladder`` under their stored warmed
   configurations, frame by frame against the JAX package's reference
   frames stored beside them; ``chained`` and ``chained_rr`` warmed on the
   card. Each is warmed by six frames and timed over further frames. Then
   the bench's own gates: ``chained_ps`` against ``ladder`` over three
   steps from one warmed state, ``chained`` / ``chained_rr`` against the
   ladder's end positions, and the kinetic-energy / penetration envelopes
   of ``chained_ps`` against the ladder's.

The last lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from types import SimpleNamespace

import numpy as np
import torch

from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.core import cuda_build, dispatch
from wgmath_tpu_torch.dynamics import gs_math
from wgmath_tpu_torch.dynamics.gs_math import UPDATE_FIELDS, pack_meta
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked

ROOT = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(ROOT, "artifacts", "ball_pit10k_settled.npz")
NPZ_LADDER = os.path.join(ROOT, "artifacts", "ball_pit10k_ladder.npz")

# NVIDIA H100 SXM data sheet: HBM3 rate and dense f32 (non-tensor) rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# the JAX package's own tolerance for this math (tests/test_physics.py)
RTOL, ATOL = 1e-4, 1e-5
KERNEL_SOURCES = ("gs_math", "gs_math_block")
# frame-by-frame limits against the JAX reference: GS sums reorder on the
# card, and a pure reordering alone moves velocities by ~3e-5 after one
# step at 10k and ~3e-4 after two
TRANSLATION_LIMITS = (1e-4, 1e-3, 1e-3)
COUNT_REL_LIMIT = 1e-3
WARM_FRAMES = 6  # the bench warms every candidate by six checked frames
TIMED_FRAMES = 50  # the bench's K
# the bench's gates (bench.py bench_physics): a short-gated candidate
# against the ladder over three steps from one warmed state; a K-gated one
# against the ladder's end positions; the envelope of a short-gated one
# against the ladder's run of the same length
SHORT_GATE_STEPS, SHORT_GATE_LIMIT = 3, 1e-2
END_GATE_LIMIT = 5e-2
ENVELOPE_PEN_SLACK, ENVELOPE_KE_FACTOR, ENVELOPE_KE_SLACK = 5e-3, 2.0, 0.1
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


def gs_block_inputs(rng: np.random.Generator, L: int, p_max: int,
                    device) -> tuple[tuple, dict]:
    """Seeded inputs for ``gs_math_block`` laid out as the ladder sweep lays
    them out: the window a row slice of the wider field matrix (built as
    :func:`gs_math_inputs` builds it), both sides' velocities the halves of
    one gathered [2L, 6] block, the impulses column views of the merged
    impulse matrix, and cfm / n_rhs / t_rhs contiguous as
    ``update_rhs_sorted`` returns them."""
    (win, meta, num_points, active, p1, p2, prev_n, prev_t), _ = \
        gs_math_inputs(rng, L, p_max, "unbiased", device)

    def t(x):
        return torch.from_numpy(x.astype(np.float32)).to(device)

    pp = torch.cat([p1, p2]).contiguous()
    view = SimpleNamespace(
        cfm_factor=t(rng.uniform(0.9, 1.0, L)),
        n_rhs=t(rng.uniform(-1.0, 1.0, (L, p_max))),
        t_rhs=t(rng.uniform(-0.1, 0.1, (L, p_max, 2))),
        num_points=num_points)
    return ((win, meta, view, active, pp[:L], pp[L:], prev_n, prev_t),
            dict(p_max=p_max, s_len=2))


def gs_block_plain(win, meta, view, active, p1, p2, prev_n, prev_t, **kw):
    return gs_math._gs_math_torch(win, meta, view.cfm_factor, view.n_rhs,
                                  view.t_rhs, view.num_points, active, p1,
                                  p2, prev_n, prev_t, **kw)


def gs_block_work(L: int, p_max: int) -> tuple[int, int]:
    """(bytes, flops) one ``gs_math_block`` launch needs: the point
    update's packed fields, cfm, both rhs, both velocity rows, the previous
    impulses, the point count and the active flag read once; the outputs
    written once."""
    s_len = 2
    meta = pack_meta(p_max, s_len)
    cols = sum(int(np.prod(meta[f][1])) if meta[f][1] else 1
               for f in UPDATE_FIELDS)
    imp = p_max * (1 + s_len)
    row_in = 4 * (cols + 1 + imp + 12 + imp) + 8 + 1
    row_out = 4 * (imp + 12)
    return (L * (row_in + row_out),
            L * (GS_FLOPS_ROW + p_max * GS_FLOPS_UPDATE))


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


def _compare(name: str, label: str, fn, plain, args, kw, work) -> tuple:
    """One shape of one kernel: agreement with the plain version and both
    device times. Returns (max abs err, kernel ms, plain ms, bytes,
    flops)."""
    got, want = fn(*args, **kw), plain(*args, **kw)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # worst |diff| / (atol + rtol |plain|): allclose holds at <= 1
    ratio = max(float(((g - w).abs() / (ATOL + RTOL * w.abs())).max())
                for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    k_ms = statistics.median(device_times_ms(lambda: fn(*args, **kw)))
    p_ms = statistics.median(device_times_ms(lambda: plain(*args, **kw)))
    nbytes, flops = work
    b_ms, _ = bound_ms(nbytes, flops)
    print(f"{name} {label} max|d|={err:.3e} "
          f"tol-ratio {ratio:.3f} (rtol {RTOL}, atol {ATOL}) "
          f"kernel {k_ms * 1e3:8.2f} us "
          f"plain {p_ms * 1e3:9.2f} us bound {b_ms * 1e3:6.2f} us "
          f"({nbytes / max(k_ms, 1e-9) / 1e6:7.1f} GB/s)")
    check(ratio <= 1.0 and finite,
          f"{name} {label}: kernel disagrees with its plain version (max "
          f"abs diff {err:.3e}, {ratio:.2f}x the tolerance)")
    return err, k_ms, p_ms, nbytes, flops


def _substep_summary(rows: list, max_err: float, work: str) -> dict:
    nbytes = sum(r[3] for r in rows)
    flops = sum(r[4] for r in rows)
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"max_abs_err": max_err, "ms": sum(r[1] for r in rows),
            "plain_ms": sum(r[2] for r in rows), "bound_ms": b_ms,
            "bound_by": b_by, "work": work}


def kernel_phase(ladders: dict) -> dict:
    """Each kernel against its plain version at the listed shapes and at
    every rung of its path's ladder. Returns each kernel's summary over one
    substep of that ladder (every rung, biased and unbiased sweep)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(20260)
    out = {}

    # gs_math (rhs rebuilt in kernel), both modes
    ladder = ladders["chained_ps"]
    shapes = [(128, 1), (1024, 1), (4096, 1), (1024, 4)]
    shapes += [(w, 1) for w in sorted(set(ladder)) if w
               and (w, 1) not in shapes]
    rows, max_err = {}, 0.0
    for L, p_max in shapes:
        for mode in ("biased", "unbiased"):
            args, kw = gs_math_inputs(rng, L, p_max, mode, dev)
            rows[(L, p_max, mode)] = r = _compare(
                "gs_math", f"L={L:5d} P={p_max} {mode:8s}",
                gs_math.gs_math_block_rhs, gs_math._gs_math_rhs_torch, args,
                kw, gs_math_work(L, p_max, mode))
            max_err = max(max_err, r[0])
    rungs = [w for w in ladder if w]
    out["gs_math_rhs"] = _substep_summary(
        [rows[(w, 1, m)] for w in rungs for m in ("biased", "unbiased")],
        max_err, f"one substep of chained_ps: {len(rungs)} rungs "
        f"({sum(rungs)} rows) x 2 modes, P=1")

    # gs_math_block (rhs passed in): every rung of the ladder path at
    # P = 1, one size at P = 4
    ladder = ladders["ladder"]
    shapes = [(w, 1) for w in sorted(set(ladder), reverse=True) if w]
    shapes.append((1024, 4))
    rows, max_err = {}, 0.0
    for L, p_max in shapes:
        args, kw = gs_block_inputs(rng, L, p_max, dev)
        rows[(L, p_max)] = r = _compare(
            "gs_math_block", f"L={L:5d} P={p_max}", gs_math.gs_math_block,
            gs_block_plain, args, kw, gs_block_work(L, p_max))
        max_err = max(max_err, r[0])
    rungs = [w for w in ladder if w]
    out["gs_math_block"] = _substep_summary(
        [rows[(w, 1)] for w in rungs for _ in range(2)], max_err,
        f"one substep of the ladder: {len(rungs)} rungs ({sum(rungs)} "
        f"rows) x 2 sweeps, P=1")
    return out


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


def run_path(name: str, arrays: dict, cfg: PipelineConfig, params,
             refs: dict | None, expect: tuple) -> dict:
    """One configuration from the settled state: ``WARM_FRAMES`` checked
    frames (the first ones held against the JAX reference frames in
    ``refs`` where there are any), then ``TIMED_FRAMES`` timed frames.
    ``expect`` names the kernel counter this path must move. The counts
    are set to 0 just before the path runs and read just after."""
    state = state_from_arrays(arrays, device="cuda")
    n_ref = 0 if refs is None else sum(
        1 for k in refs if k.startswith("ref.")
        and k.endswith(".translation"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gs_math.LAUNCHES = 0
    gs_math.LAUNCHES_BLOCK = 0
    dispatch.HOST_SYNCS = 0
    trail = []  # translations after each warm frame
    for f in range(WARM_FRAMES):
        t0 = time.perf_counter()
        state, cfg = step_checked(state, params, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        trail.append(state.bodies.poses.translation)
        check(_finite(state), f"{name} warm frame {f}: non-finite state")
        if f >= n_ref:
            continue
        pc = state.pair_count.cpu().numpy()
        ref_pc = refs[f"ref.{f}.pair_count"]
        tr = state.bodies.poses.translation.cpu().numpy()
        d_tr = float(np.abs(tr - refs[f"ref.{f}.translation"]).max())
        d_v = float(np.abs(state.bodies.vels.linear.cpu().numpy()
                           - refs[f"ref.{f}.linear"]).max())
        rel = [abs(int(pc[i]) - int(ref_pc[i])) / max(abs(int(ref_pc[i])), 1)
               for i in (0, 1)]
        print(f"{name} reference frame {f}: pairs {pc[0]} (ref {ref_pc[0]}) "
              f"contacts {pc[1]} (ref {ref_pc[1]}) bp_path {pc[3]} "
              f"max|dx| {d_tr:.3e} (limit {TRANSLATION_LIMITS[f]:.0e}) "
              f"max|dv| {d_v:.3e} host {dt * 1e3:.1f} ms")
        check(max(rel) <= COUNT_REL_LIMIT,
              f"{name} reference frame {f}: pair/contact counts off by "
              f"{max(rel):.2e} (limit {COUNT_REL_LIMIT})")
        check(d_tr <= TRANSLATION_LIMITS[f],
              f"{name} reference frame {f}: translations off by {d_tr:.3e}")
    warmed = (state, cfg)

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    counts = []
    torch.cuda.synchronize()
    warm_launches = (gs_math.LAUNCHES, gs_math.LAUNCHES_BLOCK)
    warm_syncs = dispatch.HOST_SYNCS
    t0 = time.perf_counter()
    start.record()
    for _ in range(TIMED_FRAMES):
        state, cfg = step_checked(state, params, cfg)
        counts.append(state.pair_count)
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = {"gs_math_rhs": gs_math.LAUNCHES,
                "gs_math_block": gs_math.LAUNCHES_BLOCK}
    syncs = dispatch.HOST_SYNCS
    check(_finite(state), f"{name} timed frames: non-finite state")
    for kernel, n in launches.items():
        check((n > 0) == (kernel in expect),
              f"{name}: kernel {kernel} launched {n} times on this path "
              f"(expected {'some' if kernel in expect else 'none'})")
    counts = [c.cpu().numpy() for c in counts]
    mc = cfg.max_colors
    ke, pen = _envelopes(state)
    ms = start.elapsed_time(end) / TIMED_FRAMES
    metrics = {
        "frames_timed": TIMED_FRAMES, "ms_per_step": ms,
        "steps_per_s": 1e3 / ms,
        "host_ms_per_step": 1e3 * host_s / TIMED_FRAMES,
        "pairs": int(counts[-1][0]), "contacts": int(counts[-1][1]),
        "colours_in_use": max(int(np.count_nonzero(c[9:9 + mc]))
                              for c in counts),
        "bp_path_mix": {nm: sum(int(c[3]) == i for c in counts)
                        for i, nm in enumerate(("hit", "repair", "full"))},
        "host_syncs_per_step": (syncs - warm_syncs) / TIMED_FRAMES,
        "launches": launches,
        "gs_math_rhs_launches_per_step":
            (launches["gs_math_rhs"] - warm_launches[0]) / TIMED_FRAMES,
        "gs_math_block_launches_per_step":
            (launches["gs_math_block"] - warm_launches[1]) / TIMED_FRAMES,
        "kinetic_energy": ke, "max_penetration": pen,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ladder": [w for w in cfg.gs_windows if w],
    }
    print(f"config {name}: {ms:.2f} ms/step ({1e3 / ms:.2f} steps/s) over "
          f"{TIMED_FRAMES} frames by CUDA events; gs_math_rhs "
          f"{metrics['gs_math_rhs_launches_per_step']:.1f} and "
          f"gs_math_block "
          f"{metrics['gs_math_block_launches_per_step']:.1f} launches/step; "
          f"{metrics['host_syncs_per_step']:.2f} host syncs/step; KE "
          f"{ke:.4f}, max penetration {pen:.5f}")
    return {"metrics": metrics, "warmed": warmed, "end": (state, cfg),
            "trail": trail}


def _max_dp(a, b) -> float:
    return float((a - b).abs().max())


def gates(runs: dict, params) -> dict:
    """The bench's candidate gates, run by the port on the card."""
    out = {}
    lad = runs["ladder"]
    lad_end = lad["end"][0].bodies.poses.translation
    # short gate: the candidate and the ladder, three plain steps each from
    # the candidate's warmed state
    st, cfg_ps = runs["chained_ps"]["warmed"]
    lad_cfg = lad["warmed"][1]
    ends = []
    for cfg in (cfg_ps, lad_cfg):
        s = st
        for _ in range(SHORT_GATE_STEPS):
            s = step(s, params, cfg)
        ends.append(s.bodies.poses.translation)
    err = _max_dp(*ends)
    out["chained_ps_vs_ladder_3_steps"] = err
    print(f"gate chained_ps vs ladder over {SHORT_GATE_STEPS} steps from "
          f"one warmed state: max|dp| {err:.3e} (limit {SHORT_GATE_LIMIT})")
    check(np.isfinite(err) and err <= SHORT_GATE_LIMIT,
          f"chained_ps diverges from the ladder by {err:.3e} m over "
          f"{SHORT_GATE_STEPS} steps")
    # end-position gate after WARM_FRAMES + TIMED_FRAMES frames
    for name in ("chained", "chained_rr"):
        err = _max_dp(runs[name]["end"][0].bodies.poses.translation, lad_end)
        first = _max_dp(runs[name]["trail"][0], lad["trail"][0])
        warm = _max_dp(runs[name]["trail"][-1], lad["trail"][-1])
        out[f"{name}_vs_ladder"] = {
            "after_1_frame": first, f"after_{WARM_FRAMES}_frames": warm,
            f"after_{WARM_FRAMES + TIMED_FRAMES}_frames": err}
        print(f"gate {name} vs ladder: max|dp| {first:.3e} after 1 frame, "
              f"{warm:.3e} after {WARM_FRAMES}, {err:.3e} after "
              f"{WARM_FRAMES + TIMED_FRAMES} (limit {END_GATE_LIMIT})")
        check(np.isfinite(err) and err <= END_GATE_LIMIT,
              f"{name} diverges from the ladder by {err:.3e} m after "
              f"{WARM_FRAMES + TIMED_FRAMES} frames")
    # envelope gate: trajectories diverge chaotically, the settled pile's
    # aggregates must not
    m_ps = runs["chained_ps"]["metrics"]
    m_lad = lad["metrics"]
    ke_c, pen_c = m_ps["kinetic_energy"], m_ps["max_penetration"]
    ke_l, pen_l = m_lad["kinetic_energy"], m_lad["max_penetration"]
    out["envelopes"] = {"chained_ps": {"ke": ke_c, "pen": pen_c},
                        "ladder": {"ke": ke_l, "pen": pen_l}}
    print(f"gate chained_ps envelopes after {WARM_FRAMES + TIMED_FRAMES} "
          f"frames: KE {ke_c:.4f} vs ladder {ke_l:.4f}, max penetration "
          f"{pen_c:.5f} vs {pen_l:.5f}")
    check(pen_c <= pen_l + ENVELOPE_PEN_SLACK
          and ke_c <= ENVELOPE_KE_FACTOR * ke_l + ENVELOPE_KE_SLACK,
          "chained_ps envelope exceeds the ladder's (drift)")
    return out


def path_phase() -> dict:
    """The four configurations, then the gates. Returns name → run."""
    z = dict(np.load(NPZ))
    zl = dict(np.load(NPZ_LADDER))
    params = SimParams()
    cfg_ps = PipelineConfig.from_dict(json.loads(str(z["config_json"])))
    cfg_lad = PipelineConfig.from_dict(json.loads(str(zl["config_json"])))
    rep = dataclasses.replace
    plan = (
        ("chained_ps", cfg_ps, z, ("gs_math_rhs",)),
        ("ladder", cfg_lad, zl, ("gs_math_block",)),
        ("chained", rep(cfg_lad, gs_chained=True), None,
         ("gs_math_block",)),
        ("chained_rr", rep(cfg_lad, gs_chained=True, gs_rhs_in_rung=True),
         None, ("gs_math_rhs",)),
    )
    runs = {name: run_path(name, z, cfg, params, refs, expect)
            for name, cfg, refs, expect in plan}
    runs["gates"] = gates(runs, params)
    return runs


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


KERNEL_TABLE = (
    ("gs_math_rhs", "chained_ps", "wgmath_tpu_torch/csrc/gs_math.cu",
     "wgmath_tpu/dynamics/gs_pallas.py:330",
     "dynamics/gs_pallas.py:_gs_math_rhs_pallas_call"),
    ("gs_math_block", "ladder", "wgmath_tpu_torch/csrc/gs_math_block.cu",
     "wgmath_tpu/dynamics/gs_pallas.py:246",
     "dynamics/gs_pallas.py:_gs_math_pallas_call"),
)
CONFIGS = ("chained_ps", "ladder", "chained", "chained_rr")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "GPU", file=sys.stderr)
        return 1
    try:
        setup = setup_phase()
        ladders = {}
        for name, path in (("chained_ps", NPZ), ("ladder", NPZ_LADDER)):
            cfg0 = json.loads(str(np.load(path)["config_json"]))
            ladders[name] = tuple(cfg0["gs_windows"][:cfg0["max_colors"]])
        summaries = kernel_phase(ladders)
        runs = path_phase()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    params = SimParams()
    paths = {}
    for name in CONFIGS:
        paths[name] = runs[name]["metrics"]
        try:
            prof = profile_window(*runs[name]["end"], params)
            paths[name]["profile"] = prof
            # the profiler stretches the step: the busy share of the
            # timed, unprofiled step is kernel time over that step
            paths[name]["device_busy_share"] = (
                prof["device_ms_per_step"] / paths[name]["ms_per_step"])
        except Exception as e:  # the profiler is untried on this machine
            paths[name]["profile"] = (f"not measured ({type(e).__name__}: "
                                      f"{e})")
    print(json.dumps({"paths": paths, "gates": runs["gates"]}))
    print(setup["nvidia_smi"])
    kernels = []
    for name, path, source, replaces, tpu_source in KERNEL_TABLE:
        m, summary = paths[path], summaries[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_source": tpu_source,
            "launches": m["launches"][name],
            "launches_per_step": m[f"{name}_launches_per_step"],
            "launches_by_path": {c: paths[c]["launches"][name]
                                 for c in CONFIGS},
            "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
            "plain_ms": summary["plain_ms"],
            "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"], "library_ms": None,
            "work": summary["work"],
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
