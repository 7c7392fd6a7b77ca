"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Three phases; any failed check ends the run with a non-zero exit:

1. setup: the card's name and power limit, torch/CUDA versions, and the
   build of every hand-written kernel from ``wgmath_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together; the Triton kernel compiles at
   its first launch), with the count of tensor-core (``HGMMA``)
   instructions in the built GEMM libraries;
2. kernel: each kernel's wrapper against its plain PyTorch version on the
   card, on seeded random inputs at the main paths' shapes (max abs error,
   tolerance, device time per launch, its bound, and the one PyTorch call
   that computes the same function where there is one). B1 and B2 also
   over whole sweeps: the two sweeps of the first substep of the settled
   pit's first frame (``chained_ps`` for B1, the ladder for B2), recorded
   from ``step_checked``, and synthetic P = 4 layouts; each sweep's one
   launch against the same kernel launched rung by rung (bit for bit),
   against its own repeats (bit for bit) and against the plain sweep
   (``solver._sweep_torch``), with the device time of each. B10 and B11
   likewise: one launch against the same kernel launched colour by colour
   and against its repeats (bit for bit) at the fused path's shapes, at
   P = 4 and on the first substep of the fused pit's first frame;
3. path: the linear-algebra paths of the bench at its own sizes (the chained
   GEMM at n = 1024 and 4096 with ``gemm_split`` beside it, the GEMM ->
   sqnorm -> normalize graph at n = 2048 through the module registry, the
   op-assign entry point at 2048 x 2048, and the chained GEMV at n = 4096,
   plain and transposed, each one device kernel an iteration), each
   against the same chain through the plain versions; the bench's geometry section (the SoA quaternion rotate chain
   and the component-major similarity chain at 1,000,000, against their
   invariants and the same code on the CPU) and its raycast section
   (100,000 rays against balls, cuboids and capsules, the first cast
   against the JAX package's, stored in ``artifacts/rays100k_jax.npz``);
   then the settled 10k-body ball pit
   (``artifacts/ball_pit10k_settled.npz``) stepped with ``step_checked``
   under five solver configurations of the bench: ``chained_ps``,
   ``ladder`` and ``fused`` (the fused solver, kernels B9-B12) under their
   stored warmed configurations, frame by frame against the JAX package's
   reference frames stored beside them (``ball_pit10k_ladder.npz``,
   ``ball_pit10k_fused.npz``); ``chained`` and ``chained_rr`` warmed on the
   card. Each is warmed by six frames and timed over further frames. Then
   the bench's own gates: ``chained_ps`` and ``fused`` against ``ladder``
   over three steps from one warmed state, ``chained`` / ``chained_rr``
   against the ladder's end positions, the kinetic-energy / penetration
   envelopes of ``chained_ps`` and ``fused`` against the ladder's, and
   ``fused``'s distance to the ladder's end positions (recorded beside the
   JAX package's own). Then the box scenes (``pyramid(20)`` against the
   JAX frames in ``artifacts/pyramid20.npz``, ``pyramid(50)`` timed) and
   the primitive rain: ``primitives3(40)`` against the JAX frames in
   ``artifacts/primitives3_small.npz`` and under the physical checks, and
   ``primitives3(2000)`` (10,000 balls, cuboids, capsules, cylinders and
   cones: GJK, EPA and the support-face clip) timed under the 4-point
   ladder and fused configurations, with B2 / B9-B11 checked at P = 4 on
   its frames and the support-mapped kernel's share of the step. Last the
   solve modes (colouring in the solve, uniform and split windows, the
   Jacobi solver): the README's quick start (``SCENES["pyramid3"]``,
   ``PipelineConfig(pair_capacity=16384)``, 300 ``step_checked`` frames)
   and the testbed's ``--solver jacobi`` on the same scene (20 frames),
   each against the JAX frames in ``artifacts/solve_modes_jax.npz`` and
   under the physical checks; the settled pit under the bench's
   ``steady_base`` (split windows over the cached colours) and the same
   with uniform windows, gated against the ladder; the pit's settle from
   its lattice (``bp_slack`` 0); and B2 on a uniform and a split plan
   with a truncated tail rung from those paths' own frames. Last the
   impulse joints: every case of ``artifacts/joints_jax.npz`` (the four
   chains, the drape scene under ``ladder`` / ``chained_rr`` /
   ``chained_ps``, ``ball_net3(16, 16)``) three frames each from JAX's
   state before it (the 10k net one frame, below); ``tests/test_joints.py``'s physical checks on the card;
   the 10,000-ball net (19,800 spherical joints) from JAX's drape state
   one frame against JAX's and timed under ``ladder`` and ``chained_ps``
   (finite, no centre below the ground, the largest joint stretch within
   twice JAX's plus 1 mm and within 1 mm of JAX's) and
   run under ``chained``, ``chained_rr``, the windowless default and the
   Jacobi solver; B1 / B2 on the net's own plans; the joints' share of
   the step. The fused solver with joints: the drape scene and a chain
   under ``gs_fused`` three frames each from JAX's state before it
   (``artifacts/lbvh_fused_joints_jax.npz.xz``), and the 10k net under
   ``net_ladder``'s configuration with ``gs_fused`` (``net_fused``: B9
   and B10 launched alone twice a substep, no B11), timed, held to the
   net's gates (its stretch within 1 mm of JAX's after the warm frames),
   to ``net_ladder`` over three steps and to its envelopes; B10 on its
   own plan, one launch against the plain version bit for bit. Last the
   LBVH broad phase (``bp_algo="lbvh"``): the settled pit's first frame
   with a full refresh against the grid's pairs and contacts (the JAX
   package's per-leaf window of 64 pairs drops the ground's past it,
   ROADMAP C11), three frames, ``pit_lbvh`` timed, and one LBVH call at
   the pit and at ``pyramid(50)``'s 42,926 boxes, timed. Last the meshes:
   ``trimesh3`` (100 balls on a 450-triangle field) three frames each
   from JAX's state before it (``artifacts/mesh_jax.npz.xz``), then timed;
   the CPU tests' small mesh, convex and triangle-GJK cases and the
   standalone segment / triangle / convex scenes against JAX's results;
   ``mesh10k`` (5,000 balls and 5,000 cuboids on the 100,352-triangle
   field, the clustered route) three frames from its built state against
   JAX's (the balls within 1e-4 m; the cuboids' triangle rows row by row,
   where JAX's float32 GJK leaves the true distance on ~5.6 % of them the
   port held to a float64 referee, ROADMAP C13), timed, with its physical
   checks (no centre below the field, the deepest contact, the mesh-pair
   demand within the batches), B2 on its own plan and the mesh contacts'
   share of the step.

Then the scale-out: the settled pit under the ``ladder``
configuration stepped by ranks of ``parallel.sharded_pipeline`` spawned
by ``tests/parallel_ranks.py`` (NCCL at world size 1, gloo at world size 2
with both ranks on the card), three frames against the single-device
``step`` (pair and contact counts exact, translations within 1e-6 m) and
the JAX ladder frames, the ranks' states equal bit for bit after every
frame, then ten timed frames with their collectives, bytes, B2 one-rung
launches and host syncs a step beside the single-device step's time; B2's
one-rung launch on each rank's slice of a rung against the whole rung (bit
for bit) and its plain version; one frame of the round-1 body-sharded
step (``parallel.sharded``) at world size 2, its pair count the brute
force's. Last the testbed CLI as a subprocess (``--run-all --frames 3
--verify --json``: every scene, finite; ``conveyor3`` on the oracle
backend) and ``conveyor3`` three frames on the card against the JAX
package's frames (``artifacts/parallel_jax.npz.xz``). To pay for these,
the script runs the box, primitives and 10k-net paths 10, 10 and 8 timed
frames (were 20, 20 and 15), ``pit_lbvh`` 10 (20), the 2D paths 5 (10),
``quickstart_jacobi`` 20 frames (30) and ``pit_settle`` 40 (60).

The static pair slots (``gs_static_slots``): ``chained_ss``, the stored
``chained_ps`` configuration with static rung placement, on the settled
pit, three frames against the JAX package's
(``artifacts/static_slots_jax.npz.xz``) under the same limits, static
placement shown to be on (the capacity holds the ladder and a tail of
256, the layout flag is the ladder's, every valid pair below the tail in
its colour's rung) with its tail rows each frame, then ten timed frames
beside ``chained_ps``; B1 on the static plan's first two sweeps (its rung
starts the host constants) against its plain version, timed; the bench's
3-step short gate from its warmed state against ``ladder`` and
``chained_ps``, the same after the bench's own warm-up from the bench's
initial configuration, and against the ladder at ``chained_ss``'s pair
capacity (which keeps the cached colours), printed beside the JAX
package's readings and not gated. The small-matrix geometry
(``geometry/decomp.py``, ``inv.py``): each decomposition, solve and
inverse on 1,048,576 matrices a size, timed, with its kernels a call,
``tests/test_geometry.py``'s residual checks on the card's output and its
first 4,096 rows against the CPU's. Last the five ``examples/torch_core_*.py`` as subprocesses on
the card, each exiting 0.

The last lines are the ``{"kernels": [...]}`` summary and
``{"ok": true, "device": {...}}``.
Without a CUDA device the script exits 1 before printing any result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import importlib
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
import zlib
from types import SimpleNamespace

import numpy as np
import torch

from wgmath_tpu_torch.broad_phase.grid import find_pairs_grid
from wgmath_tpu_torch.broad_phase import lbvh as lbvh_mod
from wgmath_tpu_torch.broad_phase.lbvh import find_pairs_lbvh
from wgmath_tpu_torch.convert import (
    load_arrays,
    state_from_arrays,
    state_to_arrays,
)
from wgmath_tpu_torch.core import cuda_build, dispatch, native_build
from wgmath_tpu_torch.dynamics import body as body_ops
from wgmath_tpu_torch.dynamics import build_fused, gs_fused, gs_math, solver
from wgmath_tpu_torch.dynamics.constraint import Contacts
from wgmath_tpu_torch.dynamics.gs_math import UPDATE_FIELDS, pack_meta
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.geometry import decomp, quat
from wgmath_tpu_torch.geometry import sim as sim_ops
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.pipeline import PipelineConfig, step, step_checked
from wgmath_tpu_torch.queries import ray
from wgmath_tpu_torch.shapes import shape as shp

# the ops package re-exports functions under its submodules' names, so the
# modules (which hold the launch counters) are fetched by their full names
core_module = importlib.import_module("wgmath_tpu_torch.core.module")
gemm_ops = importlib.import_module("wgmath_tpu_torch.ops.gemm")
gemv_ops = importlib.import_module("wgmath_tpu_torch.ops.gemv")
reduce_ops = importlib.import_module("wgmath_tpu_torch.ops.reduce")
elementwise_ops = importlib.import_module("wgmath_tpu_torch.ops.elementwise")
narrow_mod = importlib.import_module("wgmath_tpu_torch.queries.narrow_phase")
inv_mod = importlib.import_module("wgmath_tpu_torch.geometry.inv")
pipeline_mod = importlib.import_module("wgmath_tpu_torch.pipeline")

ROOT = os.path.dirname(os.path.abspath(__file__))
NPZ = os.path.join(ROOT, "artifacts", "ball_pit10k_settled.npz")
NPZ_LADDER = os.path.join(ROOT, "artifacts", "ball_pit10k_ladder.npz")
NPZ_FUSED = os.path.join(ROOT, "artifacts", "ball_pit10k_fused.npz")
NPZ_RAYS = os.path.join(ROOT, "artifacts", "rays100k_jax.npz")
NPZ_STATIC = os.path.join(ROOT, "artifacts", "static_slots_jax.npz.xz")
EXAMPLES = ("compose", "hot_reload", "overwrite", "profiling", "readback")

# NVIDIA H100 SXM data sheet: HBM3 rate, dense f32 (non-tensor) rate, and
# the dense tensor-core rates in TF32 and bf16
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12
# the JAX package's own tolerance for this math (tests/test_physics.py)
RTOL, ATOL = 1e-4, 1e-5
KERNEL_SOURCES = ("gs_math", "gs_math_block", "gemm", "gemm_split",
                  "reduce", "gemv", "build_fused", "gs_fused")
# frame-by-frame limits against the JAX reference: GS sums reorder on the
# card, and a pure reordering alone moves velocities by ~3e-5 after one
# step at 10k and ~3e-4 after two
TRANSLATION_LIMITS = (1e-4, 1e-3, 1e-3)
COUNT_REL_LIMIT = 1e-3
WARM_FRAMES = 6  # the bench warms every candidate by six checked frames
TIMED_FRAMES = 50  # the bench's K
SS_TIMED_FRAMES = 10  # chained_ss, beside chained_ps's TIMED_FRAMES
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


def device_times_ms(fn, n: int = 25, warmup: int = 3,
                    before=None) -> list[float]:
    """Device time of each of ``n`` calls of ``fn`` by CUDA events. Each
    call is queued behind a busy-wait kernel longer than the call's
    host-side enqueue, so host overhead between its launches does not
    count (one call at a time: a call of many small ops must not fill the
    device's launch queue). ``before()``, where given, runs between the
    busy-wait and the first event of each call, untimed (e.g. an L2
    flush)."""
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
        if before is not None:
            before()
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
    for name, loc in zip(("local_pt_a", "local_pt_b"),
                         anchors(rng, q[:L], pp[:L, 10:13], q[L:],
                                 pp[L:, 10:13], p_max)):
        put(name, loc)
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


def anchors(rng: np.random.Generator, q_a, t_a, q_b, t_b, p_max: int):
    """Both bodies' local anchors of one world point per contact point
    (within 0.5 of body a's centre), each off by about a millimetre, for
    poses [L, 4] (xyzw) / [L, 3] of unit scale."""
    world = t_a[:, None] + rng.uniform(-0.5, 0.5, (t_a.shape[0], p_max, 3))
    out = []
    for q, t in ((q_a, t_a), (q_b, t_b)):
        d = world + rng.normal(scale=1e-3, size=world.shape) - t[:, None]
        u_, w_ = -q[:, None, :3], q[:, None, 3:]  # rotate by the conjugate
        c = np.cross(u_, d)
        out.append(d + 2.0 * (w_ * c + np.cross(u_, c)))
    return out


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


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """Least time for the work: its bytes at the memory rate or its
    operations at the peak rate of their type, whichever is larger."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / flop_rate
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


# ---------------------------------------------------------------------------
# whole sweeps of B1 and B2: recorded from a step, or on a synthetic layout
# ---------------------------------------------------------------------------

# repeats of each recorded sweep that must give the first launch's bits
SWEEP_REPEATS = 5


def record_sweeps(run, count: int) -> list:
    """The first ``count`` sweeps that ``run()`` makes, each as the
    operands of ``solver.run_sweep`` with the buffer and impulse matrix
    cloned before the sweep changed them."""
    calls = []
    real = solver.run_sweep

    def record(plan, cons, fields, buf, imp, **kw):
        if len(calls) < count:
            calls.append(SimpleNamespace(plan=plan, cons=cons, fields=fields,
                                         buf=buf.clone(), imp=imp.clone(),
                                         kw=kw))
        real(plan, cons, fields, buf, imp, **kw)

    solver.run_sweep = record
    try:
        run()
    finally:
        solver.run_sweep = real
    return calls


def pit_sweeps(path: str | None, device, count: int = 2,
               cfg: PipelineConfig | None = None) -> list:
    """The first ``count`` sweeps of the first frame of the settled 10k pit
    under the configuration stored in ``path``, or ``cfg`` (substep 1:
    biased, then unbiased)."""
    z = dict(np.load(NPZ))
    if cfg is None:
        cfg = PipelineConfig.from_dict(json.loads(str(np.load(path)[
            "config_json"])))
    return record_sweeps(lambda: step_checked(
        state_from_arrays(z, device=device), SimParams(), cfg), count)


def synthetic_pass(rng: np.random.Generator, p_max: int, *, chained: bool,
                   rhs_mode: str | None, device, n_bodies: int = 2000,
                   windows: tuple = (256,) * 12) -> tuple[tuple, dict]:
    """Arguments of one ``solver.gs_color_major_pass`` on a seeded
    coloured layout: every class body-disjoint
    among its dynamic sides, a fifth of the b-sides on one of five static
    bodies, a tenth of the class rows invalid (cached pairs with no
    contact), one empty class, one class as wide as its window and the
    others narrower (so windows run into the next classes), a residue
    class and padding; the fields are ``gs_math_inputs``'s."""
    n_static, s_len, w = 5, 2, max(windows)
    mc = len(windows)
    counts = [40] + [int(x) for x in rng.integers(w // 4, w, mc)] + [0]
    counts[3], counts[5] = 0, w
    offsets = [int(x) for x in np.concatenate([[0], np.cumsum(counts)[:-1]])]
    c_rows = sum(counts)
    total = c_rows + w
    ba = np.zeros(total, np.int64)
    bb = np.zeros(total, np.int64)
    valid = np.zeros(total, bool)
    for c in range(mc + 1):
        rows = slice(offsets[c], offsets[c] + counts[c])
        perm = rng.permutation(np.arange(n_static, n_bodies))
        ba[rows] = perm[:counts[c]]
        bb[rows] = np.where(rng.random(counts[c]) < 0.2,
                            rng.integers(0, n_static, counts[c]),
                            perm[counts[c]:2 * counts[c]])
        valid[rows] = rng.random(counts[c]) > 0.1
    q = rng.normal(size=(n_bodies, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pose = np.concatenate([q, rng.uniform(-20.0, 20.0, (n_bodies, 3)),
                           np.ones((n_bodies, 1))], -1)
    (win, meta, num_points, *_), kw = gs_math_inputs(rng, total, p_max,
                                                     "biased", device)

    def t(x, dtype=torch.float32):
        return torch.from_numpy(np.asarray(x)).to(device, dtype)

    fields = gs_math._fields(win, meta)
    for name, loc in zip(("local_pt_a", "local_pt_b"),
                         anchors(rng, q[ba], pose[ba, 4:7], q[bb],
                                 pose[bb, 4:7], p_max)):
        fields[name].copy_(t(loc))
    fields["im_b"][t(bb < n_static, torch.bool)] = 0.0

    cons = SimpleNamespace(
        body_a=t(ba, torch.int64), body_b=t(bb, torch.int64),
        valid=t(valid, torch.bool), num_points=num_points,
        cfm_factor=t(rng.uniform(0.9, 1.0, total)),
        n_rhs=t(rng.uniform(-1.0, 1.0, (total, p_max))),
        t_rhs=t(rng.uniform(-0.1, 0.1, (total, p_max, s_len))), **fields)
    vels = body_ops.Velocity(t(rng.normal(size=(n_bodies, 3))),
                             t(rng.normal(size=(n_bodies, 3))))
    chain = None
    if chained:
        dyn_a, dyn_b = solver._dyn_sides(cons)
        chain = solver.build_gs_chain(cons.body_a, cons.body_b, dyn_a,
                                      dyn_b, offsets, counts, windows,
                                      n_bodies)
    extra = {}
    if rhs_mode is not None:
        extra = dict(rhs_mode=rhs_mode, rhs_consts=kw["consts"],
                     rhs_store=t(rng.uniform(-1.0, 1.0, (total, p_max))),
                     pose_tab=t(pose))
    return ((cons, vels, t(rng.uniform(0.0, 0.5, (total, p_max))),
             t(rng.normal(scale=0.1, size=(total, p_max, s_len))),
             (offsets, counts), windows, chain),
            dict(packed_fields=(win, meta), **extra))


def synthetic_sweep(rng: np.random.Generator, p_max: int,
                    **kw) -> SimpleNamespace:
    """The sweep of :func:`synthetic_pass`, recorded as
    :func:`record_sweeps` records."""
    args, kwargs = synthetic_pass(rng, p_max, **kw)
    (call,) = record_sweeps(
        lambda: solver.gs_color_major_pass(*args, **kwargs), 1)
    return call


def synthetic_windowless_sweep(rng: np.random.Generator, p_max: int, *,
                               device, cmax: int = 256, tail_window: int = 0,
                               split: int = 4) -> SimpleNamespace:
    """The ladder sweep of :func:`synthetic_pass` without its ladder: each
    colour's window is ``cmax`` rows (``tail_window`` past colour
    ``split``: the split windows, whose larger tail classes it truncates),
    the rows each class runs from ``solver.uniform_windows``; recorded as
    :func:`record_sweeps` records."""
    args, kwargs = synthetic_pass(rng, p_max, chained=False, rhs_mode=None,
                                  device=device, windows=(cmax,) * 12)
    counts = args[4][1]
    windows = solver.uniform_windows(counts, max_colors=len(counts) - 2,
                                     cmax=cmax, tail_window=tail_window,
                                     split=split)
    args = args[:5] + (windows,) + args[6:]
    (call,) = record_sweeps(
        lambda: solver.gs_color_major_pass(*args, **kwargs), 1)
    return call


def run_recorded(call, how: str):
    """(buf, imp) after one recorded sweep on fresh copies of its operands:
    ``how`` "kernel" (one launch), "rungs" (the same kernel launched rung
    by rung) or "plain" (``solver._sweep_torch``)."""
    buf, imp = call.buf.clone(), call.imp.clone()
    if how == "plain":
        solver._sweep_torch(call.plan, call.cons, call.fields, buf, imp,
                            **call.kw)
    else:
        solver.run_sweep(call.plan, call.cons, call.fields, buf, imp,
                         rung_by_rung=how == "rungs", **call.kw)
    return buf, imp


# a traced build's timestamps (csrc/gs_sweep.cuh): per side, these marks
TRACE_MARKS = ("chunk", "staged", "waited", "updated", "released")
TRACE_SIDES = 1 << 18  # csrc/gs_sweep.cuh kTraceSides


@contextlib.contextmanager
def traced_sweep_kernels():
    """Within the block B1 and B2 load from builds with
    ``-DWG_SWEEP_TRACE=1``, each its own library (the flags are part of a
    build's hash); after it, from the untraced builds again."""
    base = list(cuda_build.NVCC_FLAGS)
    cuda_build.NVCC_FLAGS[:] = base + ["-DWG_SWEEP_TRACE=1"]
    cuda_build.drop_loaded()
    try:
        yield
    finally:
        cuda_build.NVCC_FLAGS[:] = base
        cuda_build.drop_loaded()


def sweep_trace(call) -> np.ndarray:
    """[TRACE_SIDES, 5] global-timer marks (ns) that the last traced sweep
    of ``call``'s kernel left for each a-side it ran (indexed by the side;
    rows of other sides keep earlier launches' marks, or 0)."""
    return _read_trace(*(("gs_math", "gs_math_rhs_sweep_trace")
                         if call.kw.get("rhs_mode") else
                         ("gs_math_block", "gs_math_block_sweep_trace")))


def fused_trace() -> np.ndarray:
    """The marks of the last traced launch of B10 or B11, as
    :func:`sweep_trace`, indexed by the row of the fused layout."""
    return _read_trace("gs_fused", "fused_trace")


def _read_trace(lib: str, fn: str) -> np.ndarray:
    out = np.zeros((TRACE_SIDES, len(TRACE_MARKS)), np.uint64)
    f = getattr(cuda_build.load(lib), fn)
    f.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    f.restype = ctypes.c_int
    err = f(out.ctypes.data, out.nbytes)
    if err:
        raise RuntimeError(f"{fn}: error {err}")
    return out


def gs_sweep_work(call) -> tuple[int, int]:
    """(bytes, flops) of one recorded sweep with this run's layout: per
    row of a class, the packed fields the kernel reads, the point count,
    both side entries, the impulses (and rhs store) read and written, cfm
    and both rhs (B2), both sides' velocity rows (and poses, biased) read;
    per side that writes, its velocity row and flag. Each read once, each
    write once."""
    kw, plan = call.kw, call.plan
    p_max, s_len = kw["p_max"], kw["s_len"]
    meta = pack_meta(p_max, s_len)
    names = {"biased": gs_math.PACK_FIELDS,
             "unbiased": UPDATE_FIELDS + ("t_rhs_wo_bias",)}.get(
                 kw.get("rhs_mode"), UPDATE_FIELDS)
    cols = sum(int(np.prod(meta[f][1])) if meta[f][1] else 1 for f in names)
    imp = p_max * (1 + s_len)
    width = call.buf.shape[1]
    row = 4 * cols + 8 + 2 * 16 + 2 * 4 * imp + 2 * 4 * width
    if kw.get("rhs_mode") == "biased":
        row += 2 * 4 * kw["pose"].shape[1]
    if kw.get("rhs_mode"):
        row += 4 * p_max  # rhs_wo written (biased) or read (unbiased)
    else:
        row += 4 * (1 + imp)  # cfm, n_rhs, t_rhs
    sides = plan.sides.cpu().numpy()
    rows = writes = 0
    for r in plan.rungs:
        rows += r.rows
        for base in (2 * r.w_off, 2 * r.w_off + r.window):
            writes += int((sides[base:base + r.rows, 1] >= 0).sum())
    flops = GS_FLOPS_ROW + p_max * (
        GS_FLOPS_UPDATE + (GS_FLOPS_RHS if kw.get("rhs_mode") == "biased"
                           else 0))
    return rows * row + writes * (4 * width + 4), rows * flops


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
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:  # the kernel the next lines are about
                print("  ptxas: entry " + re.sub(
                    r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]{8}\d+", "",
                    entry.group(1)))
            elif any(w in line for w in ("registers", "spill", "error",
                                         "wgmma")):
                print(f"  ptxas: {line.strip()}")
    print(f"kernel build wall time {wall:.2f} s")
    t0 = time.perf_counter()
    lib = native_build.build()
    print(f"built native/wgnative.cpp ({os.path.basename(lib)}, g++) in "
          f"{time.perf_counter() - t0:.2f} s")
    colouring = colouring_times()
    # B9's block size, chosen at its first launch from the occupancy its
    # register count allows, at the fused pit's rows and the P = 4 case's
    cfg_f = json.loads(str(np.load(NPZ_FUSED)["config_json"]))
    c_pit = sum(cfg_f["gs_windows"][:cfg_f["max_colors"]]) + cfg_f["gs_rung0"]
    for p, c in ((1, c_pit), (4, 256 + sum(P4_WINDOWS))):
        block, regs, warps = build_fused.plan(p, c)
        print(f"build_fused launch plan at C={c} P={p}: blocks of {block} "
              f"threads, {-(-c // block)} blocks, {regs} registers a "
              f"thread, {warps} warps of such blocks an SM holds")
    counts = hgmma_counts()
    for name, n in counts.items():
        print(f"HGMMA instructions in the built {name}.cu: " + (
            "cuobjdump absent, not read" if n is None else str(n)))
    return {"nvidia_smi": smi, "build_s": wall, "hgmma": counts,
            "colouring": colouring}


def colouring_times(reps: int = 5) -> dict:
    """The joint colouring of ``ball_net3(100, 100)`` (19,800 joints) on
    this machine's host, by the native library and by its plain Python
    twin (the same colours), beside the whole scene build on the card;
    median wall ms of ``reps`` calls each."""
    from wgmath_tpu_torch.native import greedy_color, greedy_color_plain
    from wgmath_tpu_torch.scenes.builders import ball_net3

    net = ball_net3(100, 100, device="cpu")
    args = (net.joints.body_a.numpy(), net.joints.body_b.numpy(),
            net.bodies.is_dynamic().numpy())

    def med(fn):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    native, plain = greedy_color(*args), greedy_color_plain(*args)
    check(np.array_equal(native, plain), "native colouring of the net "
          "differs from its plain twin")
    out = {"native_ms": med(lambda: greedy_color(*args)),
           "plain_ms": med(lambda: greedy_color_plain(*args)),
           "scene_build_ms": med(lambda: ball_net3(100, 100,
                                                   device="cuda")),
           "colors": int(native.max())}
    print(f"colouring ball_net3(100, 100)'s 19,800 joints on the host: "
          f"native {out['native_ms']:.3f} ms, plain twin "
          f"{out['plain_ms']:.3f} ms (median of {reps}; "
          f"{out['colors']} colours); the whole scene build onto the card "
          f"{out['scene_build_ms']:.3f} ms")
    return out


def hgmma_counts() -> dict:
    """Tensor-core (wgmma) instructions in the built B3 and B4 libraries,
    from ``cuobjdump -sass`` where the toolkit has it (None where not)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    counts = {}
    for name in ("gemm", "gemm_split"):
        counts[name] = None
        if os.path.exists(tool):
            out = subprocess.run([tool, "-sass", cuda_build._target(name)[1]],
                                 capture_output=True, text=True, timeout=300)
            if out.returncode == 0:
                counts[name] = out.stdout.count("HGMMA")
    return counts


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


def kernel_phase(ladders: dict) -> dict:
    """The one-rung entry points of B1 and B2 against their plain versions
    at the listed shapes and at every rung width of their paths' ladders.
    Returns each kernel's largest error."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(20260)
    out = {}

    # gs_math (rhs rebuilt in kernel), both modes
    shapes = [(128, 1), (1024, 1), (4096, 1), (1024, 4)]
    shapes += [(w, 1) for w in sorted(set(ladders["chained_ps"])) if w
               and (w, 1) not in shapes]
    out["gs_math_rhs"] = max(
        _compare("gs_math", f"L={L:5d} P={p_max} {mode:8s}",
                 gs_math.gs_math_block_rhs, gs_math._gs_math_rhs_torch,
                 *gs_math_inputs(rng, L, p_max, mode, dev),
                 gs_math_work(L, p_max, mode))[0]
        for L, p_max in shapes for mode in ("biased", "unbiased"))

    # gs_math_block (rhs passed in): every rung of the ladder path at
    # P = 1, one size at P = 4
    shapes = [(w, 1) for w in sorted(set(ladders["ladder"]), reverse=True)
              if w]
    shapes.append((1024, 4))
    out["gs_math_block"] = max(
        _compare("gs_math_block", f"L={L:5d} P={p_max}",
                 gs_math.gs_math_block, gs_block_plain,
                 *gs_block_inputs(rng, L, p_max, dev),
                 gs_block_work(L, p_max))[0]
        for L, p_max in shapes)
    return out


def _sweep_case(name: str, label: str, call, timed: bool) -> dict:
    """One recorded sweep on the card: the whole-sweep launch against the
    same kernel launched rung by rung (bit for bit), against itself on
    repeats (bit for bit), and against the plain sweep (``RTOL`` /
    ``ATOL``, over the velocity buffer and the impulse matrix); with
    ``timed``, the device time of each."""
    got = run_recorded(call, "kernel")
    rungs = run_recorded(call, "rungs")
    want = run_recorded(call, "plain")
    torch.cuda.synchronize()
    for g, r in zip(got, rungs):
        check(torch.equal(g, r), f"{name} {label}: the one-launch sweep and "
              "the rung-by-rung launches of the same kernel differ")
    for _ in range(SWEEP_REPEATS):
        again = run_recorded(call, "kernel")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{name} {label}: two launches of the sweep differ")
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ratio = max(float(((g - w).abs() / (ATOL + RTOL * w.abs())).max())
                for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    check(ratio <= 1.0 and finite,
          f"{name} {label}: sweep disagrees with the plain sweep (max abs "
          f"diff {err:.3e}, {ratio:.2f}x the tolerance)")
    plan = call.plan
    n_rows = sum(r.rows for r in plan.rungs)
    res = {"max_abs_err": err, "tol_ratio": ratio, "rows": n_rows,
           "rungs": sum(1 for r in plan.rungs if r.rows),
           "chunks": int(plan.chunks.shape[0])}
    line = (f"{name} sweep {label}: {res['rungs']} rungs, {n_rows} rows, "
            f"{res['chunks']} chunks; = rung-by-rung bit for bit, "
            f"{SWEEP_REPEATS} repeats bit for bit; max|d| vs plain "
            f"{err:.3e} (tol-ratio {ratio:.3f})")
    if timed:
        bufs = [t.clone() for t in (call.buf, call.imp)]
        med = {}
        for how in ("kernel", "rungs", "plain"):
            if how == "plain":
                fn = lambda: solver._sweep_torch(  # noqa: E731
                    plan, call.cons, call.fields, *bufs, **call.kw)
            else:
                fn = lambda r=how == "rungs": solver.run_sweep(  # noqa: E731
                    plan, call.cons, call.fields, *bufs, rung_by_rung=r,
                    **call.kw)
            med[how] = statistics.median(device_times_ms(fn))
        nbytes, flops = gs_sweep_work(call)
        b_ms, _ = bound_ms(nbytes, flops)
        res.update(ms=med["kernel"], rungs_ms=med["rungs"],
                   plain_ms=med["plain"], bytes=nbytes, flops=flops)
        line += (f"; kernel {med['kernel'] * 1e3:.2f} us, rung by rung "
                 f"{med['rungs'] * 1e3:.2f} us, plain "
                 f"{med['plain'] * 1e3:.1f} us, bound {b_ms * 1e3:.2f} us")
    print(line)
    return res


def sweep_phase(rung_errs: dict) -> dict:
    """B1 and B2 over whole sweeps: the first substep of the settled 10k
    pit's first frame (``chained_ps`` for B1, biased and unbiased; the
    ladder for B2, both sweeps) timed, and synthetic P = 4 layouts with
    chains, invalid class rows, statics and windows wider than their
    classes. Returns each kernel's summary over one substep (two
    sweeps)."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(20268)
    out = {}
    for name, path, what in (("gs_math_rhs", NPZ, "chained_ps"),
                             ("gs_math_block", NPZ_LADDER, "ladder")):
        cases = [_sweep_case(name, f"{what} frame 1 sweep {k + 1}", call,
                             True)
                 for k, call in enumerate(pit_sweeps(path, dev))]
        nbytes = sum(c["bytes"] for c in cases)
        flops = sum(c["flops"] for c in cases)
        b_ms, b_by = bound_ms(nbytes, flops)
        out[name] = {
            "max_abs_err": max([c["max_abs_err"] for c in cases]
                               + [rung_errs[name]]),
            "ms": sum(c["ms"] for c in cases),
            "rungs_ms": sum(c["rungs_ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": b_ms, "bound_by": b_by,
            "work": f"one substep of {what} at frame 1: 2 sweeps, "
                    f"{cases[0]['rungs']} rungs, {cases[0]['rows']} class "
                    f"rows, P=1; one launch a sweep"}
    out["gs_math_rhs"]["static_slots"] = static_sweeps()
    out["gs_math_rhs"]["max_abs_err"] = max(
        out["gs_math_rhs"]["max_abs_err"],
        out["gs_math_rhs"]["static_slots"]["max_abs_err"])
    for chained, mode in ((True, "biased"), (True, "unbiased"),
                          (True, None), (False, None)):
        name = "gs_math_rhs" if mode else "gs_math_block"
        label = (f"synthetic P=4 {'chained' if chained else 'ladder'}"
                 + (f" {mode}" if mode else ""))
        r = _sweep_case(name, label, synthetic_sweep(
            rng, 4, chained=chained, rhs_mode=mode, device=dev), False)
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       r["max_abs_err"])
    return out


def static_sweeps() -> dict:
    """B1 over the first substep of the settled pit's first frame under
    ``chained_ss`` (the static pair slots): each rung starts at the static
    layout's host constant, and each sweep is held as ``_sweep_case``
    holds the others (rung by rung and repeats bit for bit, the plain
    version within tolerance), timed."""
    cfg = _config_of(static_arrays()["config_json"])
    starts = solver.static_offsets(tuple(cfg.gs_windows[:cfg.max_colors]))
    calls = pit_sweeps(None, torch.device("cuda"), cfg=cfg)
    for call in calls:
        moved = [(r.colour, r.start) for r in call.plan.rungs
                 if r.start != starts[r.colour]]
        check(not moved, f"chained_ss: rungs off the static offsets {moved}")
    cases = [_sweep_case("gs_math_rhs", f"chained_ss frame 1 sweep {k + 1}",
                         call, True) for k, call in enumerate(calls)]
    nbytes = sum(c["bytes"] for c in cases)
    flops = sum(c["flops"] for c in cases)
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases),
            "rungs_ms": sum(c["rungs_ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": b_ms, "bound_by": b_by,
            "rung_starts": [r.start for r in calls[0].plan.rungs],
            "work": f"one substep of chained_ss at frame 1: 2 sweeps, "
                    f"{cases[0]['rungs']} rungs at the static offsets, "
                    f"{cases[0]['rows']} class rows, P=1"}


# ---------------------------------------------------------------------------
# the fused solver: kernels B9 (build_fused), B10 (fused_sweep), B11
# (fused_substep1), B12 (fused_integrate)
# ---------------------------------------------------------------------------

# B9's fields against its plain version: the JAX package's own tolerance
# for this constraint build (tests/test_gs_fused.py), 1e-5 + 2e-6
# max|field| over each field's live columns. The rung padding's columns
# (dist 1e9, never read) hold torques that cancel two ~5e8 terms: held to
# that scale.
B9_FIELD_ATOL, B9_FIELD_RTOL = 1e-5, 2e-6
B9_PAD_RTOL, B9_PAD_ATOL = 1e-5, 5e2
# B12 against its plain version: the card's sinf, cosf and rsqrtf are within
# 2 ulp, and a translation of ~20 m is 1.9e-6 per ulp
INTEGRATE_RTOL, INTEGRATE_ATOL = 2e-6, 1e-6
# operations counted from the kernels' arithmetic: B9 per constraint and per
# contact point; B11's warmstart per contact point of a row (both sides);
# B12 per lane (sin, cos, sqrt and rsqrt one each)
B9_FLOPS_ROW, B9_FLOPS_POINT = 60, 330
WS_FLOPS_POINT = 90
INTEGRATE_FLOPS = 110
P4_BODIES, P4_WINDOWS = 2000, (256,) * 12  # the P = 4 case, smaller


# repeats of a B10 / B11 launch that must give the first launch's bits
FUSED_REPEATS = 5
# each kernel's one-launch wrapper and plain version
FUSED_FNS = {"fused_substep1": (gs_fused._launch_substep1,
                                gs_fused._substep1_torch),
             "fused_sweep": (gs_fused._launch_sweep,
                             gs_fused._fused_sweep_plain)}


def record_fused(run, count: int = 2, names=tuple(FUSED_FNS)) -> list:
    """The first ``count`` calls that ``run()`` makes through the solver's
    ``names`` (B11 / B10: ``solver.fused_substep1`` and
    ``solver.fused_sweep``), each with its tensor operands cloned (the
    counts last)."""
    calls = []
    real = {name: getattr(solver, name) for name in names}

    def recorder(name):
        def record(*args, **kw):
            if len(calls) < count:
                calls.append(SimpleNamespace(name=name, args=tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args),
                    kw=kw))
            return real[name](*args, **kw)
        return record

    for name in real:
        setattr(solver, name, recorder(name))
    try:
        run()
    finally:
        for name, fn in real.items():
            setattr(solver, name, fn)
    return calls


def pit_fused_calls(device) -> list:
    """The first substep's B11 and B10 calls of the settled 10k pit's
    first frame under the stored ``fused`` configuration."""
    z = dict(np.load(NPZ))
    cfg = PipelineConfig.from_dict(json.loads(str(np.load(NPZ_FUSED)[
        "config_json"])))
    return record_fused(lambda: step_checked(
        state_from_arrays(z, device=device), SimParams(), cfg))


def pit_build_call(device):
    """The first B9 call (``solver.build_constraints_fused``: poses,
    velocities, mass properties, the compacted contacts, parameters) of the
    settled 10k pit's first frame under the stored ``fused``
    configuration."""
    z = dict(np.load(NPZ))
    cfg = PipelineConfig.from_dict(json.loads(str(np.load(NPZ_FUSED)[
        "config_json"])))
    return record_fused(lambda: step_checked(
        state_from_arrays(z, device=device), SimParams(), cfg), 1,
        ("build_constraints_fused",))[0]


def run_fused(call, how: str):
    """Outputs of a recorded call: ``how`` "kernel" (one launch),
    "colours" (the same kernel launched once a colour and once for the
    opening, in ticket order) or "plain" (its plain version, counts read
    on the host)."""
    launch, plain = FUSED_FNS[call.name]
    if how == "plain":
        return plain(*call.args[:-1], call.args[-1].cpu(), **call.kw)
    return launch(*call.args, colour_by_colour=how == "colours", **call.kw)


def fused_bits(call, label: str):
    """One launch of a recorded call against the same kernel launched
    colour by colour and against ``FUSED_REPEATS`` more launches, each bit
    for bit. Returns the one launch's outputs."""
    got = run_fused(call, "kernel")
    colours = run_fused(call, "colours")
    torch.cuda.synchronize()
    check(all(torch.equal(g, c) for g, c in zip(got, colours)),
          f"{call.name} {label}: one launch and the colour-by-colour "
          "launches of the same kernel differ")
    for _ in range(FUSED_REPEATS):
        again = run_fused(call, "kernel")
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"{call.name} {label}: two launches differ")
    return got


def fused_inputs(rng: np.random.Generator, n_bodies: int, windows: tuple,
                 rung0: int, counts, p_max: int, device) -> dict:
    """Seeded inputs of the four fused kernels laid out as the fused solve
    lays them out: ``counts[k]`` live rows of colour k at the head of its
    rung (colour 0 the residue), the rest padding as the compaction leaves
    it (body 0, no points, dist 1e9). Each colour draws its bodies from a
    permutation of the dynamic bodies, so no dynamic body is in a colour
    twice (the colouring contract); one b-side in twenty is a static body
    (bodies 0..4), which can repeat. The bodies sit in a 20 m pit, as the
    rhs rebuild's drift sees them in the ball pit."""
    windows = tuple(int(w) for w in windows)
    rungs = (rung0,) + windows
    ctot = sum(rungs)
    ba = np.zeros(ctot, np.int64)
    bb = np.zeros(ctot, np.int64)
    valid = np.zeros(ctot, bool)
    dyn_ids = np.arange(N_STATIC, n_bodies)
    off = 0
    for k, (rung, cnt) in enumerate(zip(rungs, counts)):
        cnt = min(int(cnt), rung)
        if k == 0:  # the residue: bodies may repeat
            a = rng.choice(dyn_ids, cnt)
            b = (a + 1 + rng.integers(0, 50, cnt) - N_STATIC) % (
                n_bodies - N_STATIC) + N_STATIC
        else:
            perm = rng.permutation(dyn_ids)[:2 * cnt]
            a, b = perm[:cnt], perm[cnt:].copy()
            static = rng.random(cnt) < 0.05
            b[static] = rng.integers(0, N_STATIC, int(static.sum()))
        ba[off:off + cnt], bb[off:off + cnt] = a, b
        valid[off:off + cnt] = True
        off += rung
    n = n_bodies
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    tr = np.stack([rng.uniform(-10, 10, n), rng.uniform(0, 20, n),
                   rng.uniform(-10, 10, n)], -1)
    dyn = np.ones(n, bool)
    dyn[:N_STATIC] = False
    normal = rng.normal(size=(ctot, 3))
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    dist = np.where(valid[:, None], rng.uniform(-0.05, 0.01, (ctot, p_max)),
                    1e9)
    nump = np.where(valid, rng.integers(1, p_max + 1, ctot), 0)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    poses = Sim(t(q), t(tr), torch.ones(n, device=device))
    vels = body_ops.Velocity(t(rng.normal(scale=0.5, size=(n, 3))),
                             t(rng.normal(scale=0.5, size=(n, 3))))
    local = body_ops.ball_local_mprops(
        t(rng.uniform(0.4, 0.6, n)), dynamic=t(dyn, torch.bool))
    mprops = body_ops.update_mprops(poses, local)
    contacts = Contacts(
        t(ba, torch.int64), t(bb, torch.int64), t(normal),
        t(rng.uniform(-0.5, 0.5, (ctot, p_max, 3))), t(dist),
        t(nump, torch.int64), t(valid, torch.bool))
    c_full = list(counts) + [0] * (len(windows) + 2 - len(counts))
    return dict(poses=poses, vels=vels, mprops=mprops, contacts=contacts,
                windows=windows, rung0=rung0, ctot=ctot, n=n, p_max=p_max,
                counts=t(c_full, torch.int32),
                com=t(rng.uniform(-0.05, 0.05, (n, 3))))


def fused_operands(z: dict, big_t, rng: np.random.Generator) -> dict:
    """Operands of B10, B11 and B12 from :func:`fused_inputs` and a bigT:
    the tables, the component-major velocity / pose / COM tables, seeded
    impulses and rhs, the window and source blocks and their maps, the
    substep scalars of the pit's parameters."""
    dev = big_t.device
    n, p_max, ctot = z["n"], z["p_max"], z["ctot"]
    windows, rung0 = z["windows"], z["rung0"]
    meta_all, _ = build_fused.field_meta(p_max, 2)
    w_g = gs_fused.gather_width(n, windows)
    c = z["contacts"]
    im_a = big_t[meta_all["im_a"][0]:meta_all["im_a"][0] + 3].T
    im_b = big_t[meta_all["im_b"][0]:meta_all["im_b"][0] + 3].T
    idx, inv = gs_fused.build_fused_tables(
        c.body_a, c.body_b, (im_a != 0).any(-1), (im_b != 0).any(-1),
        c.valid, windows=windows, rung0=rung0, w_g=w_g)

    def table(rows, x):
        out = torch.zeros((rows, w_g), device=dev)
        out[:x.shape[1], :n] = x.T
        return out

    vels, poses = z["vels"], z["poses"]
    relin = ("t_rhs_wo_bias", "local_pt_a", "local_pt_b", "info_dist",
             "info_normal_vel")
    src0 = min(meta_all[f][0] for f in relin)
    k_pack = meta_all["cfm_factor"][0]
    sub = SimParams().substep()

    def u(lo, hi, *shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32,
                               device=dev)

    return dict(
        vt=table(8, torch.cat([vels.linear, vels.angular], -1)),
        pose=table(8, torch.cat([poses.rotation, poses.translation,
                                 poses.scale[:, None]], -1)),
        com=table(3, z["com"]),
        n_imp=u(0.0, 0.1, p_max, ctot), t_imp=u(-0.02, 0.02, 2 * p_max, ctot),
        n_rhs=u(-1.0, 1.0, p_max, ctot), t_rhs=u(-0.1, 0.1, 2 * p_max, ctot),
        win=big_t[:k_pack], src=big_t[src0:],
        active=c.valid.to(torch.float32)[None].contiguous(),
        nump=c.num_points.to(torch.float32)[None].contiguous(),
        idx=idx, inv=inv,
        meta={f: meta_all[f] for f in gs_math.PACK_FIELDS},
        src_meta={f: (meta_all[f][0] - src0, meta_all[f][1]) for f in relin},
        scalars=(sub.warmstart_coefficient, sub.contact_cfm_factor,
                 sub.inv_dt, sub.contact_erp_inv_dt, sub.allowed_linear_error,
                 sub.max_corrective_velocity),
        dt=sub.dt, w_g=w_g)


def _fused_rows(z) -> int:
    """Rows the sweeps run over: every rung of an occupied colour."""
    counts = z["counts"].cpu().tolist()
    return sum(w for k, w in enumerate(z["windows"], start=1)
               if counts[k] > 0)


def build_work(z) -> tuple[int, int]:
    """(bytes, flops) of one B9 launch: the body table's 29 fields (not
    its padding), the ids and the contact rows read once, bigT written
    once."""
    p, c, n = z["p_max"], z["ctot"], z["n"]
    k_all = build_fused.field_meta(p, 2)[1]
    nbytes = 4 * build_fused.SIDE_OFFS[-1] * n + c * (16 + 4 * (3 + 4 * p)) \
        + 4 * k_all * c
    return nbytes, c * (B9_FLOPS_ROW + p * B9_FLOPS_POINT)


def sweep_work(z, k_load: int, substep: bool) -> tuple[int, int]:
    """(bytes, flops) of one B10 (or B11) launch: velocities in and out,
    the impulses in and out, and for every swept row its fields, flags,
    rhs (B11: rhs sources), both table lookups; B11 also the poses and the
    rhs store. The work runs over the rungs of the occupied colours."""
    p, ctot, w_g = z["p_max"], z["ctot"], z["w_g"]
    rows = _fused_rows(z)
    per_row = k_load + 2 + 4 + (10 * p if substep else 3 * p)
    nbytes = 4 * (2 * 8 * w_g + 2 * 3 * p * ctot + rows * per_row)
    flops = rows * (GS_FLOPS_ROW + p * GS_FLOPS_UPDATE)
    if substep:
        nbytes += 4 * (8 * w_g + p * ctot)
        flops += rows * p * (GS_FLOPS_RHS + WS_FLOPS_POINT)
    return nbytes, flops


def _fused_check(name, label, got, want, rtol, atol) -> tuple[float, float]:
    """(max abs err, worst |d| / (atol + rtol |plain|)) over the outputs;
    fails the run above 1 or on a non-finite output."""
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    ratio = max(_tol_ratio(g, w, rtol, atol) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    check(ratio <= 1.0 and finite,
          f"{name} {label}: kernel disagrees with its plain version (max "
          f"abs diff {err:.3e}, {ratio:.2f}x the tolerance)")
    return err, ratio


def _report(name, label, err, ratio, tol, k_ms, p_ms, work) -> dict:
    nbytes, flops = work
    b_ms, b_by = bound_ms(nbytes, flops)
    print(f"{name} {label} max|d|={err:.3e} tol-ratio {ratio:.3f} ({tol}) "
          f"kernel {k_ms * 1e3:9.2f} us plain {p_ms * 1e3:10.2f} us bound "
          f"{b_ms * 1e3:7.2f} us by {b_by} "
          f"({nbytes / max(k_ms, 1e-9) / 1e6:7.1f} GB/s)")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def b9_args(z, params=None) -> tuple:
    """The arguments of B9's kernel and plain version for one input set."""
    p = z["p_max"]
    meta, k_all = build_fused.field_meta(p, 2)
    params = params or SimParams()
    consts = (params.restitution, params.inv_dt, params.friction,
              params.contact_cfm_factor)
    packed = build_fused._packed_bodies(z["poses"], z["vels"], z["mprops"])
    return packed, z["contacts"], consts, meta, k_all, p


def _b9_case(z, label, timed: bool, params=None):
    """B9 on one input set. Returns (summary or None, the kernel's bigT)."""
    args = b9_args(z, params)
    meta = args[3]
    got = build_fused._launch(*args)
    want = build_fused._build_torch(*args)
    torch.cuda.synchronize()
    live = z["contacts"].valid
    err, ratio = 0.0, 0.0
    for f, (at, tail) in meta.items():
        rows = slice(at, at + (int(np.prod(tail)) if tail else 1))
        g, w = got[rows][:, live], want[rows][:, live]
        tol = B9_FIELD_ATOL + B9_FIELD_RTOL * float(w.abs().max())
        d = float((g - w).abs().max())
        err, ratio = max(err, d), max(ratio, d / tol)
    pad_ratio = _tol_ratio(got[:, ~live], want[:, ~live], B9_PAD_RTOL,
                           B9_PAD_ATOL)
    check(ratio <= 1.0 and pad_ratio <= 1.0
          and bool(torch.isfinite(got).all()),
          f"build_fused {label}: kernel disagrees with its plain version "
          f"(live {ratio:.2f}x, padding {pad_ratio:.2f}x the tolerance)")
    if not timed:
        print(f"build_fused {label} max|d|={err:.3e} tol-ratio {ratio:.3f} "
              f"(padding {pad_ratio:.3f})")
        return None, got
    k_ms = _median_ms(lambda: build_fused._launch(*args))
    p_ms = _median_ms(lambda: build_fused._build_torch(*args))
    return _report("build_fused", label, err, ratio,
                   f"field tol 1e-5 + 2e-6 max|f|; padding {pad_ratio:.3f}",
                   k_ms, p_ms, build_work(z)), got


def fused_calls(z, op) -> list:
    """B10 and B11 on one operand set of :func:`fused_operands`, as
    :func:`record_fused` records calls."""
    kw = dict(windows=z["windows"], rung0=z["rung0"], p_max=z["p_max"],
              s_len=2, meta=op["meta"])
    return [SimpleNamespace(name="fused_sweep", kw=kw, args=(
                op["vt"], op["n_imp"], op["t_imp"], op["win"], op["active"],
                op["nump"], 1.0, op["n_rhs"], op["t_rhs"], op["idx"],
                op["inv"], z["counts"])),
            SimpleNamespace(name="fused_substep1", kw=dict(
                kw, src_meta=op["src_meta"], scalars=op["scalars"]), args=(
                op["vt"], op["n_imp"], op["t_imp"], op["win"], op["src"],
                op["pose"], op["active"], op["nump"], op["idx"], op["inv"],
                z["counts"]))]


def carrying_integrate(call, op):
    """A B10 call of :func:`fused_calls` that also carries B12 on its input
    velocities, as the fused step makes it."""
    return SimpleNamespace(name=call.name, args=call.args, kw=dict(
        call.kw, integrate=(op["pose"], op["com"], op["dt"])))


def _b10_b11_case(z, op, label, timed: bool) -> tuple:
    """B10 and B11 on one operand set: each one launch against the same
    kernel launched colour by colour and against its repeats (bit for bit,
    :func:`fused_bits`), against its plain version (which reads the counts
    from a host copy, so it makes no host sync), padding rows' impulses
    unchanged. Returns the two summaries (None when not timed) and B11's
    outputs."""
    out, results = {}, {}
    for call in fused_calls(z, op):
        name = call.name
        got = fused_bits(call, label)
        grid = gs_fused.LAST_GRID[name]
        want = run_fused(call, "plain")
        torch.cuda.synchronize()
        pad = op["active"][0] < 0.5
        check(torch.equal(got[1][:, pad],
                          (op["n_imp"] * (op["scalars"][0] if name ==
                                          "fused_substep1" else 1.0))[:, pad]),
              f"{name} {label}: padding rows' impulses changed")
        err, ratio = _fused_check(name, label, got, want, RTOL, ATOL)
        results[name] = got
        bits = (f"grid {grid} blocks; = colour by colour bit for bit, "
                f"{FUSED_REPEATS} repeats bit for bit")
        if timed:
            k_ms = _median_ms(lambda: run_fused(call, "kernel"))
            counts_h = call.args[-1].cpu()
            p_ms = _median_ms(lambda: FUSED_FNS[name][1](
                *call.args[:-1], counts_h, **call.kw))
            k_load = max(op["meta"][f][0] + gs_math._size(op["meta"][f][1])
                         for f in gs_math.UPDATE_FIELDS)
            out[name] = _report(
                name, label, err, ratio,
                f"rtol {RTOL}, atol {ATOL}; {bits}", k_ms, p_ms,
                sweep_work(dict(z, w_g=op["w_g"]), k_load,
                           name == "fused_substep1"))
            out[name]["grid"] = grid
        else:
            print(f"{name} {label} max|d|={err:.3e} tol-ratio {ratio:.3f}; "
                  f"{bits}")
    return out, results["fused_substep1"]


def b9_from_copies(args) -> bool:
    """Whether B9 on contiguous copies of the contact fields gives the bits
    of B9 on the fields as they are (strided views, read in place)."""
    c = args[1]
    copies = dataclasses.replace(c, normal_a=c.normal_a.contiguous(),
                                 points_a=c.points_a.contiguous(),
                                 dist=c.dist.contiguous())
    got = build_fused._launch(*args)
    want = build_fused._launch(args[0], copies, *args[2:])
    torch.cuda.synchronize()
    return torch.equal(got, want)


def _pit_b9_case(label: str) -> tuple:
    """B9 on the pit's own first-frame inputs, its contact fields the
    compaction's strided views: against its plain version, against itself
    on contiguous copies (bit for bit), timed. Returns (summary, C)."""
    call = pit_build_call("cuda")
    poses, vels, mprops, contacts, params = call.args
    check(not contacts.normal_a.is_contiguous()
          and not contacts.points_a.is_contiguous(),
          "build_fused pit: the compacted contact fields are not the "
          "strided views the kernel should read in place")
    z = dict(p_max=contacts.points_a.shape[1], poses=poses, vels=vels,
             mprops=mprops, contacts=contacts, ctot=contacts.capacity,
             n=poses.translation.shape[0])
    check(b9_from_copies(b9_args(z, params)),
          "build_fused pit: strided contact fields and contiguous copies "
          "give different bits")
    row, _ = _b9_case(z, f"{label} C={z['ctot']} (strided contacts)", True,
                      params)
    return row, z["ctot"]


def paired_ms(fa, fb) -> tuple[float, float]:
    """Median device times of two calls measured in turns a, b, b, a."""
    ta, tb = device_times_ms(fa), device_times_ms(fb)
    tb += device_times_ms(fb)
    ta += device_times_ms(fa)
    return statistics.median(ta), statistics.median(tb)


def _carried_b12_case(z, op, vt, label, timed: bool) -> dict | None:
    """B12 carried by B10 on ``vt`` (B11's output): B10 with the integrate
    in one launch against colour by colour and its repeats (bit for bit);
    its velocities and impulses B10's without the integrate, its poses the
    standalone B12's, bit for bit; the poses against the plain version.
    Timed: B10 with and without the integrate, in turns."""
    sweep = fused_calls(z, dict(op, vt=vt))[0]
    call = carrying_integrate(sweep, op)
    n0 = gs_fused.INTEGRATES_IN_SWEEP
    got = fused_bits(call, f"{label} carrying B12")
    check(gs_fused.INTEGRATES_IN_SWEEP == n0 + 2 + FUSED_REPEATS,
          "fused_sweep: a launch carrying B12 was not counted once")
    alone = run_fused(sweep, "kernel")
    standalone = gs_fused._launch_integrate(op["pose"], vt, op["com"],
                                            op["dt"])
    want = gs_fused._cm_integrate(op["pose"], vt, op["com"], op["dt"])
    torch.cuda.synchronize()
    check(all(torch.equal(g, a) for g, a in zip(got[:3], alone)),
          f"fused_sweep {label}: carrying B12 changed its velocities or "
          "impulses")
    check(torch.equal(got[3], standalone),
          f"fused_integrate {label}: carried by B10 and standalone differ")
    err, ratio = _fused_check("fused_integrate", f"{label} carried by B10",
                              (got[3],), (want,), INTEGRATE_RTOL,
                              INTEGRATE_ATOL)
    msg = (f"fused_integrate {label} carried by B10 max|d|={err:.3e} "
           f"tol-ratio {ratio:.3f}; = standalone B12 bit for bit, B10's "
           "outputs = without it bit for bit, = colour by colour, "
           f"{FUSED_REPEATS} repeats")
    if not timed:
        print(msg)
        return None
    with_ms, without_ms = paired_ms(lambda: run_fused(call, "kernel"),
                                    lambda: run_fused(sweep, "kernel"))
    print(f"{msg}; B10 carrying it {with_ms * 1e3:.2f} us, without "
          f"{without_ms * 1e3:.2f} us (in turns)")
    return {"max_abs_err": err, "sweep_with_ms": with_ms,
            "sweep_without_ms": without_ms}


def _b12_case(z, op, vt, label, timed: bool):
    args = (op["pose"], vt, op["com"], op["dt"])
    got = gs_fused._launch_integrate(*args)
    want = gs_fused._cm_integrate(*args)
    torch.cuda.synchronize()
    err, ratio = _fused_check("fused_integrate", label, (got,), (want,),
                              INTEGRATE_RTOL, INTEGRATE_ATOL)
    if not timed:
        print(f"fused_integrate {label} max|d|={err:.3e} tol-ratio "
              f"{ratio:.3f}")
        return None
    k_ms = _median_ms(lambda: gs_fused._launch_integrate(*args))
    p_ms = _median_ms(lambda: gs_fused._cm_integrate(*args))
    w_g = op["w_g"]
    return _report("fused_integrate", label, err, ratio,
                   f"rtol {INTEGRATE_RTOL}, atol {INTEGRATE_ATOL}", k_ms,
                   p_ms, (4 * w_g * (8 + 6 + 3 + 8), w_g * INTEGRATE_FLOPS))


def fused_kernel_phase(cfg: dict, counts: list) -> dict:
    """B9-B12 against their plain versions: at the fused path's own shapes
    (the stored configuration's 24 windows and 256-row residue rung over
    10,005 bodies, each colour as full as in the first reference frame;
    P = 1), timed; then at P = 4 on a smaller layout with a non-empty
    residue and empty colours; then B11 and B10 on the first substep of
    the fused pit's first frame, timed too. B10 and B11 each as one launch
    against the same kernel launched colour by colour and against their
    repeats, bit for bit."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(20265)
    windows = tuple(cfg["gs_windows"][:cfg["max_colors"]])
    z = fused_inputs(rng, 10_005, windows, cfg["gs_rung0"], counts, 1, dev)
    label = f"C={z['ctot']} P=1"
    out = {}
    out["build_fused"], big_t = _b9_case(z, label, True)
    op = fused_operands(z, big_t, rng)
    label += f" Wg={op['w_g']}"
    summaries, sub_out = _b10_b11_case(z, op, label, True)
    out.update(summaries)
    # B12 twice on B11's output: standalone, and carried by B10
    out["fused_integrate"] = _b12_case(z, op, sub_out[0], label, True)
    carried = _carried_b12_case(z, op, sub_out[0], label, True)
    out["fused_integrate"].update(
        max_abs_err=max(out["fused_integrate"]["max_abs_err"],
                        carried.pop("max_abs_err")), **carried)
    # P = 4: residue rows, empty colours
    c4 = [64] + [int(x) for x in rng.integers(0, 257, len(P4_WINDOWS))]
    c4[-2:] = [0, 0]
    z4 = fused_inputs(rng, P4_BODIES, P4_WINDOWS, 256, c4, 4, dev)
    label4 = f"C={z4['ctot']} P=4"
    _, big4 = _b9_case(z4, label4, False)
    check(b9_from_copies(b9_args(z4)), "build_fused P=4: strided views")
    op4 = fused_operands(z4, big4, rng)
    _, sub4 = _b10_b11_case(z4, op4, label4, False)
    _b12_case(z4, op4, sub4[0], label4, False)
    p4 = _carried_b12_case(z4, op4, sub4[0], label4, True)
    out["fused_sweep"]["p4_with_integrate_ms"] = p4["sweep_with_ms"]
    out["fused_sweep"]["p4_without_integrate_ms"] = p4["sweep_without_ms"]
    # B9 on the pit's own first-frame inputs: strided contact fields
    pit_b9, pit_c = _pit_b9_case("pit frame 1")
    row = out["build_fused"]
    row["max_abs_err"] = max(row["max_abs_err"], pit_b9["max_abs_err"])
    row["pit_frame1_ms"] = pit_b9["ms"]
    row["pit_frame1_C"] = pit_c
    # the first substep of the fused pit's first frame: B11, then B10
    # carrying B12 (as the step makes it)
    for call in pit_fused_calls(dev):
        check((call.name == "fused_sweep") == ("integrate" in call.kw),
              f"{call.name} pit frame 1: the step's B10 does not carry B12")
        got = fused_bits(call, "pit frame 1")
        err, ratio = _fused_check(call.name, "pit frame 1", got,
                                  run_fused(call, "plain"), RTOL, ATOL)
        row = out[call.name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row["pit_frame1_ms"] = _median_ms(lambda: run_fused(call, "kernel"))
        print(f"{call.name} pit frame 1 max|d|={err:.3e} tol-ratio "
              f"{ratio:.3f}; grid {gs_fused.LAST_GRID[call.name]} blocks; "
              f"= colour by colour bit for bit, {FUSED_REPEATS} repeats bit "
              f"for bit; kernel {row['pit_frame1_ms'] * 1e3:.2f} us")
    for name, row in out.items():
        row["work"] = (f"one launch on the fused path's shapes: {label}, "
                       f"{len(windows)} windows, residue rung "
                       f"{cfg['gs_rung0']}")
    return out

# ---------------------------------------------------------------------------
# linear-algebra layer: kernels B3 (gemm), B4 (gemm_split), B7 (reduce),
# B8 (op_assign) and the bench's two paths through them
# ---------------------------------------------------------------------------

# the reference's golden tolerance for GEMM-class results, and what one
# rounding to bf16 of sums taken in another order can differ by (one bf16
# ulp is 2^-7 of the value)
GEMM_TOL = {torch.float32: (1e-3, 1e-3), torch.bfloat16: (1.6e-2, 1e-2)}
# gemm_split against an f64 product, as a share of the mean magnitude: the
# JAX package's limits at K = 256 (tests/test_ops.py); at K = 4096 the f32
# accumulation error of any f32 product grows by sqrt(4096 / 256) = 4
# accumulation error of any f32 product grows by sqrt(4096 / 256) = 4, and
# the worst of 65,536 entries gets a factor 2 (torch.matmul in f32 is
# printed beside it as the yardstick)
SPLIT_F64_LIMITS_K256 = {6: 5e-6, 3: 1e-3}
SPLIT_F64_LIMITS_K4096 = {6: 4e-5, 3: 1e-3}
# kernel against plain version, f32 terms added in another order: for sum
# and sqnorm a share of the sum of the terms' magnitudes (the signed sum
# itself nearly cancels), for prod a share of the result (4e6 factors near
# 1; tests/test_ops.py gives prod 5e-3 at 4,096 factors), min and max exact
REDUCE_TOL = {"sum": 1e-6, "sqnorm": 1e-6, "prod": 5e-3, "min": 0.0,
              "max": 0.0}
# Triton's f32 division is within 2 ulp of the rounded quotient
OP_ASSIGN_RTOL = 1e-6
GEMM_PATH_SIZES = ((1024, 64), (4096, 8))  # n, chained iterations K
GEMM_SPLIT_ITERS = 4
GRAPH_N, GRAPH_ITERS = 2048, 16
# device kernels an iteration of the graph path: B3, B7 (one launch), and
# the add, rsqrt and multiply of the normalize
GRAPH_KERNELS = 5
REDUCE_N = GRAPH_N * GRAPH_N
OP_ASSIGN_SHAPE = (2048, 2048)
CHAIN_RTOL = 1e-3  # end of a chain against the plain chain, of max |value|


def _cuda(x, dtype=np.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.astype(dtype))).cuda()


def _median_ms(fn) -> float:
    return statistics.median(device_times_ms(fn))


def _tol_ratio(got, want, rtol, atol) -> float:
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def gemm_work(nb, m, n, k, itemsize, passes=3, rate=TF32_FLOP_PER_S):
    """(bytes, flops, bound ms, bound by, f32-pipe bound ms) of one product.
    The bound is the card's least time for a result inside the reference's
    tolerance: ``passes`` tensor-core passes at ``rate`` (3 x TF32 for f32
    inputs, one bf16 pass for bf16 inputs). The f32-pipe bound is what a
    kernel without tensor cores can reach."""
    nbytes = nb * (m * k + k * n + m * n) * itemsize
    flops = 2 * nb * m * n * k
    b_ms, b_by = bound_ms(nbytes, passes * flops, rate)
    return nbytes, flops, b_ms, b_by, bound_ms(nbytes, flops)[0]


GEMM_FETCH = ("per element", "cp.async", "TMA")  # csrc/gemm.cu enum Fetch


def _gemm_case(label, a, b, *, ta=False, tb=False, library=False) -> dict:
    """B3 on one shape: agreement with ``gemm_torch`` and device times."""
    kw = dict(transpose_a=ta, transpose_b=tb)
    got = gemm_ops.gemm(a, b, impl="cuda", **kw)
    fetch = [GEMM_FETCH[f] for f in (ctypes.c_int * 2).in_dll(
        cuda_build.load("gemm"), "gemm_last_fetch")]
    want = gemm_ops.gemm_torch(a, b, **kw)
    torch.cuda.synchronize()
    rtol, atol = GEMM_TOL[a.dtype]
    err = float((got.float() - want.float()).abs().max())
    ratio = _tol_ratio(got, want, rtol, atol)
    m, k = gemm_ops._op_shape(a, ta)
    n = gemm_ops._op_shape(b, tb)[1]
    nb = max(a.numel() // (m * k), b.numel() // (k * n))
    bf16 = a.dtype == torch.bfloat16
    nbytes, flops, b_ms, b_by, fma_ms = gemm_work(
        nb, m, n, k, a.element_size(), 1 if bf16 else 3,
        BF16_FLOP_PER_S if bf16 else TF32_FLOP_PER_S)
    k_ms = _median_ms(lambda: gemm_ops.gemm(a, b, **kw))
    p_ms = _median_ms(lambda: gemm_ops.gemm_torch(a, b, **kw))
    row = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bound_ms_f32_fma": fma_ms,
           "bound_share": b_ms / k_ms, "tflops": flops / k_ms / 1e9,
           "library_ms": None, "fetch": fetch}
    lib = ""
    if library:
        # the one PyTorch call for the same function: matmul in full f32,
        # and with TF32 allowed (what "default" may use), set for this
        # timing only
        row["library_ms"] = _median_ms(lambda: torch.matmul(a, b))
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            row["library_tf32_ms"] = _median_ms(lambda: torch.matmul(a, b))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        lib = (f" matmul f32 {row['library_ms']:.4f} ms, tf32 "
               f"{row['library_tf32_ms']:.4f} ms")
    print(f"gemm {label} max|d|={err:.3e} tol-ratio {ratio:.3f} (rtol "
          f"{rtol}, atol {atol}) kernel {k_ms:.4f} ms "
          f"({row['tflops']:.2f} TFLOP/s) plain {p_ms:.4f} ms bound "
          f"{b_ms:.4f} ms by {b_by}, {100 * b_ms / k_ms:.1f} % of it "
          f"reached (f32 pipes {fma_ms:.4f} ms){lib}; A, B fetched by "
          f"{fetch[0]}, {fetch[1]}")
    check(ratio <= 1.0 and bool(torch.isfinite(got.float()).all()),
          f"gemm {label}: kernel disagrees with its plain version (max abs "
          f"diff {err:.3e}, {ratio:.2f}x the tolerance)")
    return row


def gemm_kernel_phase(rng) -> dict:
    rows = {}
    for n in (1024, 2048, 4096):
        a = _cuda(rng.normal(size=(n, n)))
        b = _cuda(rng.normal(size=(n, n)) / np.sqrt(n))
        rows[n] = _gemm_case(f"n={n} f32", a, b, library=True)
    # the tensor cores' f32 accumulation over K = 4096, against f64 on a
    # 256^2 corner, beside torch.matmul in full f32 (printed, not gated:
    # the limit is GEMM_TOL)
    corner = a[:256].double() @ b[:, :256].double()
    scale = float(corner.abs().mean())
    for label, c in (("gemm", gemm_ops.gemm(a, b)),
                     ("torch.matmul f32", torch.matmul(a, b))):
        rows[4096][f"f64_rel_{label.split()[0]}"] = d = float(
            (c[:256, :256].double() - corner).abs().max()) / scale
        print(f"{label} n=4096 vs f64 on a 256^2 corner {d:.3e} of the "
              "mean magnitude")
    # the four transpose variants: at a small batched shape, and at a size
    # where the arithmetic, not the launch, is the cost
    for ta in (False, True):
        for tb in (False, True):
            tag = ("t" if ta else "n") + ("t" if tb else "n")
            a = _cuda(rng.normal(size=(2, 256, 512) if ta else (2, 512, 256)))
            b = _cuda(rng.normal(size=(2, 384, 256) if tb else (2, 256, 384)))
            rows[tag] = _gemm_case(f"2x512x256.2x256x384 {tag} f32", a, b,
                                   ta=ta, tb=tb)
            a = _cuda(rng.normal(size=(2048, 2048)))
            b = _cuda(rng.normal(size=(2048, 2048)) / np.sqrt(2048))
            rows[tag + "2048"] = _gemm_case(f"n=2048 {tag} f32", a, b,
                                            ta=ta, tb=tb)
    a = _cuda(rng.normal(size=(3, 65, 100)))
    rows["ragged"] = _gemm_case("3x65x100.3x100x49 f32 (ragged)", a,
                                _cuda(rng.normal(size=(3, 100, 49))))
    rows["broadcast"] = _gemm_case("3x65x100.100x49 f32 (one b for all)", a,
                                   _cuda(rng.normal(size=(100, 49))))
    rows["bf16"] = _gemm_case(
        "4x512x384.4x384x256 bf16",
        _cuda(rng.normal(size=(4, 512, 384))).bfloat16(),
        _cuda(rng.normal(size=(4, 384, 256)) / np.sqrt(384)).bfloat16())
    head = dict(rows[4096])
    head["max_abs_err"] = max(r["max_abs_err"] for k, r in rows.items()
                              if k != "bf16")
    head["work"] = ("one 4096^3 f32 product (path 1); bound: 3 TF32 "
                    "tensor-core passes, which meet the 1e-3 contract")
    head["by_shape"] = {str(k): {f: r[f] for f in
                                 ("ms", "plain_ms", "bound_ms",
                                  "bound_ms_f32_fma", "bound_share",
                                  "tflops", "library_ms", "max_abs_err")}
                        for k, r in rows.items()}
    return head


def gemm_split_kernel_phase(rng) -> dict:
    n = 4096
    a = _cuda(rng.normal(size=(n, n)))
    b = _cuda(rng.normal(size=(n, n)) / np.sqrt(n))
    ap, bp = gemm_ops._split3(a), gemm_ops._split3(b)
    check(torch.equal(ap.float().sum(0), a),
          "gemm_split: the three planes do not sum back to the operand")
    corner = a[:256].double() @ b[:, :256].double()
    scale = float(corner.abs().mean())
    lib_ms = _median_ms(lambda: torch.matmul(a, b))
    lib_f64 = float((torch.matmul(a, b)[:256, :256].double() - corner)
                    .abs().max()) / scale
    out = {}
    for passes in (6, 3):
        got = gemm_ops.gemm_split(a, b, n_passes=passes)
        want = gemm_ops._gemm_split_torch(ap, bp, passes)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ratio = _tol_ratio(got, want, 1e-5, 1e-5)
        f64 = float((got[:256, :256].double() - corner).abs().max()) / scale
        n_split = 3 if passes == 6 else 2
        nbytes = 2 * n_split * 2 * n * n + 4 * n * n
        flops = passes * 2 * n ** 3
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOP_PER_S)
        k_ms = _median_ms(
            lambda: gemm_ops._gemm_split_cuda(ap, bp, passes))
        p_ms = _median_ms(
            lambda: gemm_ops._gemm_split_torch(ap, bp, passes))
        print(f"gemm_split n={n} passes={passes} max|d|={err:.3e} "
              f"tol-ratio {ratio:.3f} (rtol 1e-5, atol 1e-5: f32 sums in "
              f"another order) vs f64 on a 256^2 corner {f64:.3e} of the "
              f"mean magnitude (limit {SPLIT_F64_LIMITS_K4096[passes]}; "
              f"torch.matmul f32 reads {lib_f64:.3e}) kernel {k_ms:.4f} ms "
              f"({flops / k_ms / 1e9:.2f} TFLOP/s of plane products) plain "
              f"{p_ms:.3f} ms bound {b_ms:.4f} ms by {b_by}, "
              f"{100 * b_ms / k_ms:.1f} % of it reached, matmul f32 "
              f"{lib_ms:.4f} ms")
        check(ratio <= 1.0 and f64 <= SPLIT_F64_LIMITS_K4096[passes],
              f"gemm_split passes={passes}: off its plain version by "
              f"{err:.3e} or off the f64 product by {f64:.3e}")
        out[passes] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "bound_share": b_ms / k_ms, "library_ms": lib_ms,
                       "f64_rel": f64}
    # the JAX package's own check, at its own size
    a2 = _cuda(rng.normal(size=(256, 256)))
    b2 = _cuda(rng.normal(size=(256, 256)) / 16)
    ref = a2.double() @ b2.double()
    for passes in (6, 3):
        f64 = float((gemm_ops.gemm_split(a2, b2, n_passes=passes).double()
                     - ref).abs().max() / ref.abs().mean())
        print(f"gemm_split n=256 passes={passes} vs f64 {f64:.3e} of the "
              f"mean magnitude (limit {SPLIT_F64_LIMITS_K256[passes]})")
        check(f64 <= SPLIT_F64_LIMITS_K256[passes],
              f"gemm_split passes={passes} at 256: {f64:.3e} off f64")
    head = dict(out[6])
    head["max_abs_err"] = max(o["max_abs_err"] for o in out.values())
    head["work"] = ("one 4096^3 product in six bf16-plane passes (path 1); "
                    "bound: six bf16 tensor-core passes")
    head["three_passes"] = out[3]
    return head


_LIBRARY_REDUCE = {"sum": torch.sum, "prod": torch.prod, "min": torch.amin,
                   "max": torch.amax, "sqnorm": lambda x: torch.dot(x, x)}


# an L2 flush between launches: written by a library fill, well past the
# card's 50 MB of L2
L2_FLUSH_BYTES = 256 * 2 ** 20


def reduce_kernel_phase(rng) -> dict:
    """B7 against the plain version for each op at the graph path's length
    and at 1,000,003: the result within REDUCE_TOL, two runs' bits, one
    device kernel a call; device times with the input warm in L2 (as the
    graph path reads it, just written by the product) and with L2 flushed
    before each launch, beside the library call's and the one-launch floor
    of the same harness (an empty kernel on the same grid)."""
    out = {}
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    for n in (REDUCE_N, 1_000_003):
        # factors near 1 keep the product of n of them in range
        x = _cuda(rng.uniform(0.999, 1.001, size=n)
                  * rng.choice([-1.0, 1.0], size=n))
        blocks = reduce_ops.grid(n, reduce_ops.max_blocks(x.get_device()))
        floor_ms = _median_ms(lambda: reduce_ops.launch_empty(n))
        # the first call on a stream makes its scratch (one more kernel)
        reduce_ops.reduce(x, "sqnorm")
        kernels = profile_window(lambda: reduce_ops.reduce(x, "sqnorm"), 4,
                                 1)["kernels_per_step"]
        print(f"reduce n={n}: grid {blocks} blocks of "
              f"{reduce_ops.THREADS}; one-launch floor (empty kernel, same "
              f"grid) {floor_ms * 1e3:.2f} us; {kernels:g} device kernels a "
              "call")
        check(kernels == 1, f"reduce n={n}: {kernels} device kernels a call "
              "(expected 1)")
        for op in reduce_ops._OPS:
            got = reduce_ops.reduce(x, op, impl="cuda")
            again = reduce_ops.reduce(x, op, impl="cuda")
            want = reduce_ops._reduce_torch(x, op)
            torch.cuda.synchronize()
            err = abs(float(got) - float(want))
            pre = reduce_ops._OPS[op][0]
            scale = (abs(float(want)) if op in ("prod", "min", "max")
                     else float(pre(x).abs().sum()))
            tol = REDUCE_TOL[op] * scale
            k_ms = _median_ms(lambda: reduce_ops.reduce(x, op))
            cold_ms = statistics.median(device_times_ms(
                lambda: reduce_ops.reduce(x, op), before=flush.zero_))
            p_ms = _median_ms(lambda: reduce_ops._reduce_torch(x, op))
            l_ms = _median_ms(lambda: _LIBRARY_REDUCE[op](x))
            l_cold_ms = statistics.median(device_times_ms(
                lambda: _LIBRARY_REDUCE[op](x), before=flush.zero_))
            b_ms, b_by = bound_ms(4 * n + 4, (2 if op == "sqnorm" else 1) * n)
            print(f"reduce n={n} {op:6s} kernel {float(got):.7g} plain "
                  f"{float(want):.7g} |d|={err:.3e} (limit {tol:.3e}) "
                  f"kernel {k_ms * 1e3:.2f} us (L2 flushed "
                  f"{cold_ms * 1e3:.2f}) plain {p_ms * 1e3:.2f} us "
                  f"library {l_ms * 1e3:.2f} us (L2 flushed "
                  f"{l_cold_ms * 1e3:.2f}) bound {b_ms * 1e3:.2f} us by "
                  f"{b_by}; floor {floor_ms * 1e3:.2f} us")
            check(np.isfinite(float(got)) and err <= tol,
                  f"reduce {op} n={n}: kernel {float(got)} vs plain "
                  f"{float(want)}")
            check(bool(got == again),
                  f"reduce {op} n={n}: two runs gave different bits")
            out[(n, op)] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                            "bound_ms": b_ms, "bound_by": b_by,
                            "library_ms": l_ms, "cold_ms": cold_ms,
                            "library_cold_ms": l_cold_ms,
                            "floor_ms": floor_ms, "grid": blocks,
                            "kernels_per_call": kernels}
    head = dict(out[(REDUCE_N, "sqnorm")])
    head["work"] = (f"sqnorm of {REDUCE_N} f32 (path 2), input warm in L2 "
                    "as after the product that wrote it; cold_ms with L2 "
                    "flushed before each launch")
    # op -> {n: (us warm, us with L2 flushed)}
    head["by_op_us"] = {op: {n: (out[(n, op)]["ms"] * 1e3,
                                 out[(n, op)]["cold_ms"] * 1e3)
                             for n in (REDUCE_N, 1_000_003)}
                        for op in reduce_ops._OPS}
    return head


def redirect_op():
    """A caller's own redirect: any ``@triton.jit`` binary function."""
    import triton

    @triton.jit
    def twice_plus(a, b):
        return a * 2.0 + b

    return twice_plus, (lambda a, b: a * 2.0 + b)


_LIBRARY_OP = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
               "div": torch.div, "copy": lambda a, b: b.clone()}


def op_assign_kernel_phase(rng) -> dict:
    a = _cuda(rng.normal(size=OP_ASSIGN_SHAPE))
    b = _cuda(np.abs(rng.normal(size=OP_ASSIGN_SHAPE)) + 0.5)
    t0 = time.perf_counter()
    elementwise_ops.op_assign_kernel(a, b, "add")
    torch.cuda.synchronize()
    print(f"op_assign: Triton compile and first launch "
          f"{time.perf_counter() - t0:.2f} s")
    jitted, plain = redirect_op()
    out = {}
    for op in list(elementwise_ops.VARIANTS) + ["redirect"]:
        # copy never reads a
        nbytes = (2 if op == "copy" else 3) * a.numel() * 4
        k_op, p_op = (jitted, plain) if op == "redirect" else (op, op)
        got = elementwise_ops.op_assign_kernel(a, b, k_op)
        want = elementwise_ops.op_assign(a, b, p_op)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ratio = _tol_ratio(got, want, OP_ASSIGN_RTOL, 1e-30)
        k_ms = _median_ms(
            lambda: elementwise_ops.op_assign_kernel(a, b, k_op))
        p_ms = _median_ms(lambda: elementwise_ops.op_assign(a, b, p_op))
        l_ms = (_median_ms(lambda: _LIBRARY_OP[op](a, b))
                if op in _LIBRARY_OP else None)
        b_ms, b_by = bound_ms(nbytes, a.numel())
        lib = "none" if l_ms is None else f"{l_ms * 1e3:.2f} us"
        print(f"op_assign {OP_ASSIGN_SHAPE} {op:8s} max|d|={err:.3e} "
              f"tol-ratio {ratio:.3f} (rtol {OP_ASSIGN_RTOL}) kernel "
              f"{k_ms * 1e3:.2f} us plain {p_ms * 1e3:.2f} us library {lib} "
              f"bound {b_ms * 1e3:.2f} us by {b_by} "
              f"({nbytes / k_ms / 1e6:.0f} GB/s)")
        check(ratio <= 1.0 and bool(torch.isfinite(got).all())
              and got.shape == a.shape,
              f"op_assign {op}: kernel disagrees with its plain version "
              f"(max abs diff {err:.3e})")
        out[op] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms}
    head = dict(out["add"])
    head["max_abs_err"] = max(o["max_abs_err"] for o in out.values())
    head["work"] = "add over 2048 x 2048 f32 (the entry-point phase)"
    head["by_op_us"] = {op: o["ms"] * 1e3 for op, o in out.items()}
    return head


# B5 / B6 against the plain version: f32 terms added in another order, as a
# share of the sum of the terms' magnitudes of each output (as B7's sum)
GEMV_TOL = 1e-5
GEMV_N, GEMV_ITERS = 4096, 64
# label, stored shape of A, shape of x, and the columns of the stored A
# that the case takes (None: all of it): for A x, then for A^T x. Beside
# the main path's 4096^2, each entry is a shape that the kernels plan or
# load differently: the ragged edge, a shared matrix over a batch, M = 1,
# K = 1, a narrow M with a tall K (A^T x: one column tile, the K split at
# its most), a column slice whose rows are 16-byte misaligned with M not a
# multiple of 4 (the scalar loads), a K shorter than the K split allows,
# a batch past the grid's y / z limit of 65,535, and 8192^2 (four times
# 4096^2's bytes: the two give the stream rate and a launch's fixed cost)
GEMV_SHAPES = {
    False: (("4096^2", (4096, 4096), (4096,), None),
            ("1000x777 (ragged)", (1000, 777), (777,), None),
            ("5x64x96 (batched, one x for all)", (5, 64, 96), (96,), None),
            ("M=1", (1, 300), (300,), None),
            ("K=1", (300, 1), (1,), None),
            ("64x65536 (narrow M, tall K)", (64, 65536), (65536,), None),
            ("1001x777 view at column 1 of 1001x780 (rows misaligned)",
             (1001, 780), (777,), (1, 778)),
            ("4096x5 (K=5)", (4096, 5), (5,), None),
            ("70000x4x8 (batch past 65,535)", (70000, 4, 8), (70000, 8),
             None),
            ("8192^2", (8192, 8192), (8192,), None)),
    True: (("4096^2", (4096, 4096), (4096,), None),
           ("1000x777 (ragged)", (1000, 777), (1000,), None),
           ("5x64x96 (batched, one x for all)", (5, 64, 96), (64,), None),
           ("M=1", (300, 1), (300,), None),
           ("K=1", (1, 300), (1,), None),
           ("65536x64 (narrow M, tall K)", (65536, 64), (65536,), None),
           ("777x1001 view at column 1 of 777x1004 (M % 4 = 1, rows "
            "misaligned)", (777, 1004), (777,), (1, 1002)),
           ("5x4096 (K=5, shorter than the K split)", (5, 4096), (5,),
            None),
           ("70000x8x4 (batch past 65,535)", (70000, 8, 4), (70000, 8),
            None),
           ("8192^2", (8192, 8192), (8192,), None)),
}


def gemv_case_operands(entry, normal) -> tuple:
    """(A, x) of one ``GEMV_SHAPES`` entry; ``normal(shape)`` makes a CUDA
    tensor of seeded normals."""
    _, a_shape, x_shape, cols = entry
    a = normal(a_shape)
    if cols is not None:
        a = a[..., cols[0]:cols[1]]
    return a, normal(x_shape)


def gemv_work(a_shape) -> tuple:
    """(bytes, operations) of one product over a stored ``[..., r, c]``:
    A, x and y each moved once."""
    *batch, r, c = a_shape
    nb = int(np.prod(batch)) if batch else 1
    return 4 * nb * (r * c + r + c), 2 * nb * r * c


def _gemv_case(label, a, x, tr) -> dict:
    """B5 (``tr`` False) or B6 on one shape: agreement with ``gemv_torch``
    per output, two launches bit for bit, and device times."""
    got = gemv_ops.gemv(a, x, transpose_a=tr, impl="cuda")
    again = gemv_ops.gemv(a, x, transpose_a=tr, impl="cuda")
    want = gemv_ops.gemv_torch(a, x, transpose_a=tr)
    scale = gemv_ops.gemv_torch(a.abs(), x.abs(), transpose_a=tr)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    ratio = float((diff / (GEMV_TOL * scale).clamp(min=1e-30)).max())
    nbytes, flops = gemv_work(tuple(a.shape))
    b_ms, b_by = bound_ms(nbytes, flops)
    k_ms = _median_ms(lambda: gemv_ops.gemv(a, x, transpose_a=tr))
    p_ms = _median_ms(lambda: gemv_ops.gemv_torch(a, x, transpose_a=tr))
    l_ms = None
    if a.ndim == 2:  # the one library call: cuBLAS gemv
        at = a.t() if tr else a
        l_ms = _median_ms(lambda: torch.mv(at, x))
    name = "gemv_tr" if tr else "gemv"
    m, k = (a.shape[-1], a.shape[-2]) if tr else (a.shape[-2], a.shape[-1])
    plan = gemv_ops.plan(m, k, int(np.prod(a.shape[:-2])) if a.ndim > 2
                         else 1, transpose_a=tr)
    lib = "none" if l_ms is None else f"{l_ms * 1e3:.2f} us"
    print(f"{name} {label} plan {plan} max|d|={err:.3e} tol-ratio "
          f"{ratio:.3f} (1e-5 of "
          f"sum |a x|) bitwise-repeatable {bool(torch.equal(got, again))} "
          f"kernel {k_ms * 1e3:.2f} us plain {p_ms * 1e3:.2f} us torch.mv "
          f"{lib} bound {b_ms * 1e3:.2f} us by {b_by} "
          f"({nbytes / k_ms / 1e6:.0f} GB/s)")
    check(ratio <= 1.0 and bool(torch.isfinite(got).all())
          and got.shape == want.shape,
          f"{name} {label}: kernel disagrees with its plain version (max "
          f"abs diff {err:.3e}, {ratio:.2f}x the tolerance)")
    check(torch.equal(got, again),
          f"{name} {label}: two launches gave different bits")
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "tol_ratio": ratio, "plan": plan}


def gemv_kernel_phase(rng) -> dict:
    def normal(shape):
        return _cuda(rng.normal(size=shape))

    out = {tr: {entry[0]: _gemv_case(entry[0],
                                     *gemv_case_operands(entry, normal), tr)
                for entry in cases}
           for tr, cases in GEMV_SHAPES.items()}
    heads = {}
    for tr, name in ((False, "gemv"), (True, "gemv_tr")):
        # time = fixed cost + bytes / rate, from 4096^2 and 8192^2
        small, large = out[tr]["4096^2"], out[tr]["8192^2"]
        extra = gemv_work((8192, 8192))[0] - gemv_work((4096, 4096))[0]
        for who, key in (("kernel", "ms"), ("torch.mv", "library_ms")):
            rate = extra / (large[key] - small[key]) / 1e9  # TB/s
            fixed = small[key] - gemv_work((4096, 4096))[0] / rate / 1e9
            print(f"{name} {who}: streams A at {rate:.3f} TB/s, a "
                  f"launch costs {fixed * 1e3:.2f} us beyond its bytes "
                  f"(4096^2 against 8192^2)")
        head = dict(out[tr]["4096^2"])
        head["max_abs_err"] = max(r["max_abs_err"] for r in out[tr].values())
        head["work"] = (f"one {'transposed ' if tr else ''}product at "
                        f"4096^2 f32 (the gemv path)")
        head["by_shape"] = out[tr]
        heads[name] = head
    return heads


def linalg_kernel_phase() -> dict:
    rng = np.random.default_rng(20263)
    return {"gemm": gemm_kernel_phase(rng),
            "gemm_split": gemm_split_kernel_phase(rng),
            "reduce": reduce_kernel_phase(rng),
            "op_assign": op_assign_kernel_phase(rng),
            **gemv_kernel_phase(rng)}


LINALG_COUNTERS = (("gemm", gemm_ops, "LAUNCHES_GEMM"),
                   ("gemm_split", gemm_ops, "LAUNCHES_GEMM_SPLIT"),
                   ("gemv", gemv_ops, "LAUNCHES_GEMV"),
                   ("gemv_tr", gemv_ops, "LAUNCHES_GEMV_TR"),
                   ("reduce", reduce_ops, "LAUNCHES_REDUCE"),
                   ("op_assign", elementwise_ops, "LAUNCHES_OP_ASSIGN"))


def _zero_linalg_counts() -> None:
    for _, mod, attr in LINALG_COUNTERS:
        setattr(mod, attr, 0)
    dispatch.HOST_SYNCS = 0


def _linalg_counts() -> dict:
    return {name: getattr(mod, attr) for name, mod, attr in LINALG_COUNTERS}


def _plain_chain_check(name: str, start, plain_body, iters: int):
    """A ``check_end`` for :func:`chain_path`: the end of the chain against
    the same chain through the plain versions on the card, as a share of
    its largest value."""
    def check_end(got) -> dict:
        want = start
        for _ in range(iters):
            want = plain_body(want)
        torch.cuda.synchronize()
        rel = float((got - want).abs().max() / want.abs().max())
        check(bool(torch.isfinite(got).all()) and got.shape == start.shape,
              f"{name}: non-finite or misshapen end value")
        check(rel <= CHAIN_RTOL,
              f"{name}: end of the chain off the plain chain by {rel:.3e} of "
              f"its largest value (limit {CHAIN_RTOL})")
        print(f"path {name}: end vs plain chain {rel:.2e} of the largest "
              f"value (limit {CHAIN_RTOL})")
        return {"end_vs_plain_chain": rel}
    return check_end


def chain_path(name: str, body, start, iters: int, expect: dict, *,
               rate: tuple, check_end, profile_iters: int = 0,
               runs: int = 2, kernels: int = 0) -> dict:
    """One bench path: ``iters`` chained iterations of ``body`` from
    ``start`` after a warm-up, ``runs`` times, each whole chain between two
    CUDA events. The counts are set to 0 just before the chains run and
    read just after; ``expect`` gives the launches per iteration the path
    must show (a kernel not named there must show none), and no host sync
    is allowed. ``rate`` is (unit, work of one iteration in that unit per
    second); ``check_end`` holds the chain's end value and returns its
    metrics. ``kernels``, where given, is the most device kernels an
    iteration the profiled window may show (the profiler can lose a
    kernel's record, never add one)."""
    c = start
    for _ in range(2):
        c = body(c)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_linalg_counts()
    times, host = [], []
    for _ in range(runs):
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        c = start
        t0 = time.perf_counter()
        ev0.record()
        for _ in range(iters):
            c = body(c)
        ev1.record()
        host.append((time.perf_counter() - t0) * 1e3 / iters)
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1) / iters)
    launches, syncs = _linalg_counts(), dispatch.HOST_SYNCS
    peak = torch.cuda.max_memory_allocated()
    per_iter = {k: v / (runs * iters) for k, v in launches.items()}
    check(all(per_iter[k] == expect.get(k, 0) for k in per_iter)
          and syncs == 0,
          f"{name}: {per_iter} launches per iteration and {syncs} host "
          f"syncs (expected {expect} and no sync)")
    unit, work = rate
    rates = [work / (t / 1e3) for t in times]
    out = {"ms_per_iteration": times, "host_enqueue_ms_per_iteration": host,
           "iterations": iters, "rate": rates,
           "rate_unit": unit, "launches": launches,
           "launches_per_iteration": per_iter,
           "host_syncs_per_iteration": syncs / (runs * iters),
           "peak_mem_gb": peak / 1e9}
    out.update(check_end(c))
    extra = ""
    if profile_iters:
        box = [start]

        def one():
            box[0] = body(box[0])

        prof = profile_window(one, profile_iters,
                              max(kernels, sum(expect.values())))
        # the profiler stretches the host side: the busy share of the
        # timed, unprofiled chain is kernel time over that chain's time
        busy = prof["device_ms_per_step"] / statistics.median(times)
        check(not kernels or prof["kernels_per_step"] <= kernels,
              f"{name}: {prof['kernels_per_step']} device kernels an "
              f"iteration, expected {kernels}")
        out.update(device_busy_share=busy,
                   kernels_per_iteration=prof["kernels_per_step"],
                   device_ms_per_iteration=prof["device_ms_per_step"],
                   profile_top=prof["top"][:6])
        extra = (f"; {prof['device_ms_per_step']:.4f} ms of kernel time in "
                 f"{prof['kernels_per_step']:.1f} device kernels per "
                 f"iteration (profiled window): device busy {busy:.3f}")
    print(f"path {name}: {' / '.join(f'{t:.5f}' for t in times)} "
          f"ms/iteration ({' / '.join(f'{r:.2f}' for r in rates)} {unit}) "
          f"over {iters} chained iterations, {runs} runs (host enqueue "
          f"{' / '.join(f'{h:.5f}' for h in host)} ms/iteration); launches per "
          f"iteration { {k: v for k, v in per_iter.items() if v} }, {syncs} "
          f"host syncs; peak memory {peak / 1e9:.3f} GB{extra}")
    return out


def linalg_path_phase() -> dict:
    """The bench's GEMM section, its composition graph and the op-assign
    entry point, through the port's public functions. Returns name ->
    metrics with the launch counts of each path."""
    paths = {}
    rng = np.random.default_rng(0)  # the bench's seed for the GEMM section
    for n, iters in GEMM_PATH_SIZES:
        a = _cuda(rng.normal(size=(n, n)))
        b = _cuda(rng.normal(size=(n, n)) / np.sqrt(n))
        for prec in ("highest", "default"):
            name = f"gemm n={n} {prec}"
            paths[f"gemm{n}_{prec}"] = chain_path(
                name, lambda c: gemm_ops.gemm(c, b, precision=prec), a,
                iters, {"gemm": 1}, rate=("TFLOP/s", 2 * n ** 3 / 1e12),
                check_end=_plain_chain_check(
                    name, a, lambda c: gemm_ops.gemm_torch(c, b), iters),
                profile_iters=4 if prec == "highest" else 0)
        if n != 4096:
            continue
        b_planes = gemm_ops._split3(b)
        for passes in (6, 3):
            name = f"gemm_split n={n} passes={passes} (split included)"
            paths[f"gemm_split{n}_{passes}"] = chain_path(
                name, lambda c: gemm_ops.gemm_split(c, b, n_passes=passes),
                a, GEMM_SPLIT_ITERS, {"gemm_split": 1},
                rate=("TFLOP/s", 2 * n ** 3 / 1e12),
                check_end=_plain_chain_check(
                    name, a, lambda c: gemm_ops._gemm_split_torch(
                        gemm_ops._split3(c), b_planes, passes),
                    GEMM_SPLIT_ITERS))

    # composition graph: GEMM -> sqnorm -> normalize through the registry
    ns = {}
    ns.update(core_module.compose("linalg.gemm"))
    ns.update(core_module.compose("linalg.reduce"))
    gemm, reduce_ = ns["gemm"], ns["reduce"]
    rng = np.random.default_rng(2)  # the bench's seed for this section
    n = GRAPH_N
    a = _cuda(rng.normal(size=(n, n)))
    b = _cuda(rng.normal(size=(n, n)))

    def graph(c):
        c = gemm(c, b, precision="default")
        s = reduce_(c.reshape(-1), "sqnorm")
        return c * torch.rsqrt(s + 1e-12)

    def graph_plain(c):
        c = gemm_ops.gemm_torch(c, b)
        s = reduce_ops._reduce_torch(c.reshape(-1), "sqnorm")
        return c * torch.rsqrt(s + 1e-12)

    name = "graph (gemm -> sqnorm -> normalize) n=2048"
    vs_plain = _plain_chain_check(name, a, graph_plain, GRAPH_ITERS)

    def graph_end(c) -> dict:
        norm = float(reduce_ops._reduce_torch(c.reshape(-1), "sqnorm"))
        check(abs(norm - 1.0) <= 1e-4,
              f"graph: the normalized end value has squared norm {norm}")
        return {"end_sqnorm": norm, **vs_plain(c)}

    paths["graph2048"] = chain_path(
        name, graph, a, GRAPH_ITERS, {"gemm": 1, "reduce": 1},
        rate=("TFLOP/s", 2 * n ** 3 / 1e12), check_end=graph_end,
        profile_iters=8, kernels=GRAPH_KERNELS)
    print(f"path {name}: {paths['graph2048']['kernels_per_iteration']:g} "
          "device kernels an iteration (B3, B7 and the normalize's three "
          "elementwise ops)")

    # entry points off those paths: op_assign_kernel, five variants and one
    # redirected function
    rng = np.random.default_rng(3)
    x = _cuda(rng.normal(size=OP_ASSIGN_SHAPE))
    y = _cuda(np.abs(rng.normal(size=OP_ASSIGN_SHAPE)) + 0.5)
    jitted, plain = redirect_op()
    _zero_linalg_counts()
    worst = 0.0
    for k_op, p_op in [(v, v) for v in elementwise_ops.VARIANTS] + \
            [(jitted, plain)]:
        got = elementwise_ops.op_assign_kernel(x, y, k_op)
        ratio = _tol_ratio(got, elementwise_ops.op_assign(x, y, p_op),
                           OP_ASSIGN_RTOL, 1e-30)
        check(ratio <= 1.0, f"op_assign entry point {k_op}: off its plain "
              f"version by {ratio:.2f}x the tolerance")
        worst = max(worst, ratio)
    counts = _linalg_counts()
    check(counts["op_assign"] == 6 and dispatch.HOST_SYNCS == 0,
          f"op_assign entry points: {counts} launches")
    paths["op_assign2048"] = {"launches": counts, "worst_tol_ratio": worst}
    print(f"path op_assign {OP_ASSIGN_SHAPE}: {counts['op_assign']} "
          f"launches (five variants and one redirect), worst tol-ratio "
          f"{worst:.3f} (rtol {OP_ASSIGN_RTOL})")
    return paths


# ---------------------------------------------------------------------------
# the bench's gemv, geometry and raycast sections: kernels B5 (gemv) and B6
# (gemv_tr), and the plain tensor code of the quaternion / similarity SoA
# paths and the ray casts
# ---------------------------------------------------------------------------

GEOM_N, ROT_ITERS, SIM_ITERS = 1_000_000, 128, 16
# rotations keep norms, renormalized quaternions stay unit: both within
# GEOM_UNIT_TOL after the chain. The first GEOM_CPU_ROWS rows after
# GEOM_CPU_ITERS iterations equal the same code on the CPU within
# ROT_CPU_TOL: every op of the rotate chain rounds once on both. The
# similarity chain renormalizes with rsqrt, which the card computes within
# 2 ulp and the CPU correctly rounded; a 2-ulp rsqrt put into the CPU run
# moves its translations (up to 12 in size) by up to 4.4e-6 of
# (1 + |t|) after 4 iterations, hence SIM_CPU_TOL
GEOM_UNIT_TOL = 1e-4
GEOM_CPU_ROWS, GEOM_CPU_ITERS = 65_536, 4
ROT_CPU_TOL, SIM_CPU_TOL = 1e-6, 1e-5
RAY_N, RAY_ITERS = 100_000, 32
# the card's first cast against the JAX package's: the same hit mask, and
# times within RAY_RTOL / RAY_ATOL where both hit. Where float32 cannot
# settle a ray, the float64 time of the same cast decides: a ray that
# grazes its shape (its hit mask or time moves when the shape grows or
# shrinks by RAY_GRAZE of its size) may differ, its time within
# RAY_F64_RTOL of the float64 time; two times that are both within the
# tolerance of the float64 time may differ by up to twice it. The bench's
# quaternions and directions are scaled by one matrix norm, not normalized
# per row, so |d| goes down to 3e-7 and t up to 1e6. Such rays are counted.
RAY_RTOL = RAY_ATOL = 1e-5
RAY_GRAZE = 1e-5
RAY_F64_RTOL = 1e-4


def gemv_path_phase() -> dict:
    """The bench's gemv section: K chained ``v <- gemv(A, v)`` at n = 4096
    (B5), the same chain transposed (B6), and cuBLAS's gemv beside them.
    Each kernel chain must run one device kernel, the port's, an
    iteration."""
    rng = np.random.default_rng(0)  # the bench's seed for this section
    n = GEMV_N
    a = _cuda(rng.normal(size=(n, n)) / 64.0)
    x = _cuda(rng.normal(size=(n,)))
    rate = ("GB/s", (n * n + 2 * n) * 4 / 1e9)
    paths = {}
    for tr, key in ((False, "gemv4096"), (True, "gemv_tr4096")):
        name = f"gemv n={n}{' transposed' if tr else ''}"
        paths[key] = chain_path(
            name, lambda v: gemv_ops.gemv(a, v, transpose_a=tr), x,
            GEMV_ITERS, {"gemv_tr" if tr else "gemv": 1}, rate=rate,
            check_end=_plain_chain_check(
                name, x, lambda v: gemv_ops.gemv_torch(a, v, transpose_a=tr),
                GEMV_ITERS),
            profile_iters=8)
        run = paths[key]
        launches = sum(run["launches_per_iteration"].values())
        host, ms = (" / ".join(f"{t:.5f}" for t in run[k]) for k in (
            "host_enqueue_ms_per_iteration", "ms_per_iteration"))
        print(f"path {name}: {run['kernels_per_iteration']:.2f} device "
              f"kernels and {launches:.2f} port-kernel launches per "
              f"iteration; host enqueue {host} ms against {ms} "
              f"ms/iteration")
        check(run["kernels_per_iteration"] == 1 and launches == 1,
              f"{name}: {run['kernels_per_iteration']} device kernels and "
              f"{launches} port-kernel launches per iteration (expected 1)")
    for tr, key in ((False, "torch_mv4096"), (True, "torch_mv_tr4096")):
        at = a.t() if tr else a
        name = f"torch.mv n={n}{' transposed' if tr else ''} (yardstick)"
        paths[key] = chain_path(
            name, lambda v: torch.mv(at, v), x, GEMV_ITERS, {}, rate=rate,
            check_end=_plain_chain_check(
                name, x, lambda v: gemv_ops.gemv_torch(a, v, transpose_a=tr),
                GEMV_ITERS))
    return paths


def _cpu_rows_check(name, card, cpu, tol) -> float:
    """Largest |card - cpu| / (1 + |cpu|) over matching rows, checked
    against ``tol``."""
    worst = 0.0
    for g, w in zip(card, cpu):
        g = g.cpu()
        worst = max(worst, float(((g - w).abs() / (1.0 + w.abs())).max()))
    check(worst <= tol,
          f"{name}: the first {GEOM_CPU_ROWS} rows after {GEOM_CPU_ITERS} "
          f"iterations are off the CPU by {worst:.3e} (limit {tol})")
    return worst


def geometry_path_phase() -> dict:
    """The bench's geometry section at n = 1,000,000: the SoA rotate chain
    (``split_soa`` once, K x ``mul_vec_soa``) and the similarity chain
    (``to_cm`` once, K x ``normalize_rotation(mul(s, inv(s0)))`` with the
    scale clipped). Both are plain tensor code."""
    rng = np.random.default_rng(1)  # the bench's seed for this section
    n = GEOM_N
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    rows = slice(0, GEOM_CPU_ROWS)
    rate = ("Gop/s", n / 1e9)
    paths = {}

    def rotate_chain(qt, vt, iters):
        qs = quat.split_soa(qt)
        out = quat.split_soa(vt)
        for _ in range(iters):
            out = quat.mul_vec_soa(qs, out)
        return out

    qs = quat.split_soa(_cuda(q))
    v0 = _cuda(v)
    norm0 = torch.linalg.norm(v0, dim=-1)

    def rotate_end(c) -> dict:
        end = quat.merge_soa(c)
        drift = float(((torch.linalg.norm(end, dim=-1) - norm0).abs()
                       / norm0).max())
        check(bool(torch.isfinite(end).all()) and end.shape == v0.shape
              and drift <= GEOM_UNIT_TOL,
              f"rotate: norms drift by {drift:.3e} after {ROT_ITERS} "
              f"rotations (limit {GEOM_UNIT_TOL})")
        cpu = _cpu_rows_check(
            "rotate",
            [r[rows] for r in rotate_chain(_cuda(q), v0, GEOM_CPU_ITERS)],
            rotate_chain(torch.from_numpy(q[rows]), torch.from_numpy(v[rows]),
                         GEOM_CPU_ITERS), ROT_CPU_TOL)
        print(f"path rotate: norm drift {drift:.3e} after {ROT_ITERS} "
              f"(limit {GEOM_UNIT_TOL}); card vs CPU {cpu:.3e} (limit "
              f"{ROT_CPU_TOL})")
        return {"norm_drift": drift, "vs_cpu": cpu}

    paths["quat_rotate_1m"] = chain_path(
        f"quat rotate SoA n={n}", lambda c: quat.mul_vec_soa(qs, c),
        quat.split_soa(v0), ROT_ITERS, {}, rate=rate, check_end=rotate_end,
        profile_iters=4)

    def sim_start(qt, vt):
        return sim_ops.to_cm(Sim(qt, vt, torch.ones(qt.shape[0],
                                                    device=qt.device)))

    def sim_body(s0):
        def body(s):
            out = sim_ops.normalize_rotation(sim_ops.mul(s, sim_ops.inv(s0)))
            return Sim(out.rotation, out.translation,
                       torch.clamp(out.scale, 0.5, 2.0), cm=True)
        return body

    def sim_chain(qt, vt, iters):
        s0 = sim_start(qt, vt)
        s, body = s0, sim_body(s0)
        for _ in range(iters):
            s = body(s)
        return s

    s0 = sim_start(_cuda(q), v0)

    def sim_end(c) -> dict:
        x, y, z, w = c.rotation
        unit = float((torch.sqrt(x * x + y * y + z * z + w * w) - 1.0)
                     .abs().max())
        finite = all(bool(torch.isfinite(r).all())
                     for r in (*c.rotation, *c.translation, c.scale))
        check(finite and unit <= GEOM_UNIT_TOL,
              f"sim3: quaternions off unit by {unit:.3e} after {SIM_ITERS} "
              f"compositions (limit {GEOM_UNIT_TOL})")
        card = sim_chain(_cuda(q), v0, GEOM_CPU_ITERS)
        cpu = sim_chain(torch.from_numpy(q[rows]), torch.from_numpy(v[rows]),
                        GEOM_CPU_ITERS)
        err = _cpu_rows_check(
            "sim3", [r[rows] for r in (*card.rotation, *card.translation,
                                       card.scale)],
            (*cpu.rotation, *cpu.translation, cpu.scale), SIM_CPU_TOL)
        print(f"path sim3: |q| off 1 by {unit:.3e} after {SIM_ITERS} "
              f"(limit {GEOM_UNIT_TOL}); card vs CPU {err:.3e} (limit "
              f"{SIM_CPU_TOL})")
        return {"unit_drift": unit, "vs_cpu": err}

    paths["sim3_compose_inv_1m"] = chain_path(
        f"sim3 compose-inverse cm n={n}", sim_body(s0), s0, SIM_ITERS, {},
        rate=rate, check_end=sim_end, profile_iters=4)
    return paths


# the small-matrix geometry: DECOMP_N matrices a size; the first
# DECOMP_CPU_ROWS rows of each output against the port's CPU run of the
# same rows, within DECOMP_CPU_TOL (the card adds a sum over a matrix's
# rows in another order than the CPU, which QR's reflections and the
# solves carry to ~3e-6; the eigen and SVD routines renormalise with
# rsqrt, within 2 ulp on the card, through 8 Jacobi sweeps, and an SVD's
# bases move by ~eps·σ₁²/gap where two singular values nearly meet: 1.6e-4
# on one of 4,096 random 3x3 matrices), LU's pivots exactly;
# tests/test_geometry.py's residual limits on every output row, but that
# a solve or an inverse may miss them on a matrix whose float64 condition
# number exceeds DECOMP_COND (counted: the residual of a backward-stable
# solve grows with it)
DECOMP_N, DECOMP_CPU_ROWS, DECOMP_COND = 1 << 20, 4096, 1e3
DECOMP_CPU_TOL = {"lu": (1e-5, 1e-6), "lu_solve": (1e-5, 1e-5),
                  "qr": (1e-5, 1e-5), "cholesky": (1e-5, 1e-6),
                  "cholesky_solve": (1e-5, 1e-5), "eig": (1e-4, 1e-5),
                  "svd": (1e-3, 1e-3), "inv": (1e-5, 1e-6),
                  "det": (1e-5, 1e-6)}


def _f64(fn, x):
    """``fn`` of ``x`` in float64 on the CPU (LAPACK: cuSOLVER's batched
    eigensolver refuses these batches), back in float32 on ``x``'s
    device."""
    return fn(x.double().cpu()).float().to(x.device)


def _residual_rows(got, want, rtol, atol):
    """Rows (leading axis) of ``got`` outside ``atol + rtol·|want|``."""
    bad = (got - want).abs() > atol + rtol * want.abs()
    return bad.reshape(bad.shape[0], -1).any(dim=1)


def decomp_phase(device="cuda", n_mats: int = DECOMP_N) -> dict:
    """Each decomposition, solve, inverse and determinant of
    ``geometry/decomp.py`` / ``inv.py`` on ``n_mats`` seeded matrices a
    size on the card: ms a call by CUDA events, kernels a call by the
    profiler, ``tests/test_geometry.py``'s residual checks on the whole
    output, and the first rows against the CPU's."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(20)
    rows = slice(0, DECOMP_CPU_ROWS)
    out = {}

    def case(label, key, fn, args, residual):
        """Time ``fn(*args)``, hold it against the CPU on the first rows,
        and run ``residual(outputs)``: a dict of row masks that miss the
        limits, each with the matrices whose condition may excuse them
        (or None: no row may miss)."""
        got = fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        cpu = fn(*(a[rows].cpu() for a in args))
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        rtol, atol = DECOMP_CPU_TOL[key]
        worst = 0.0
        for g, c in zip(got, cpu):
            g = g[rows].cpu()
            if not g.is_floating_point():
                check(torch.equal(g, c), f"{label}: the card's pivots are "
                      "not the CPU's")
                continue
            worst = max(worst, float(((g - c).abs() / (atol + rtol * c.abs()))
                                     .max()))
        check(worst <= 1.0, f"{label}: the card's first {DECOMP_CPU_ROWS} "
              f"rows are {worst:.2f}x the tolerance off the CPU's")
        missed = {}
        for what, (bad, mats) in residual(got).items():
            n_bad = int(bad.sum())
            if n_bad and mats is not None:
                cond = torch.linalg.cond(mats[bad].double().cpu())
                check(bool((cond > DECOMP_COND).all()),
                      f"{label}: {what} misses its limit on a matrix of "
                      f"condition {float(cond.min()):.3e}")
            else:
                check(n_bad == 0, f"{label}: {what} misses its limit on "
                      f"{n_bad} rows")
            missed[what] = n_bad
        ms = statistics.median(device_times_ms(lambda: fn(*args), n=5,
                                               warmup=1))
        kernels = profile_window(lambda: fn(*args), 1)["kernels_per_step"]
        res = {"ms": ms, "kernels_per_call": kernels, "vs_cpu_tol_ratio":
               worst, "rows_excused_by_condition": missed}
        print(f"decomp {label} at {n_mats} matrices: {ms:.3f} ms a call, "
              f"{kernels:.0f} kernels a call, card vs CPU {worst:.3f}x the "
              f"tolerance, residual rows past their limits (each of "
              f"condition > {DECOMP_COND:.0e}) {missed}")
        out[label] = res

    for n in (2, 3, 4):
        eye = torch.eye(n, device=dev)
        a = torch.randn((n_mats, n, n), generator=gen, device=dev)
        b = torch.randn((n_mats, n), generator=gen, device=dev)
        a1 = a + eye

        def lu_res(o, a1=a1):
            l, u = decomp.lu_unpack(o[0])
            pa = torch.gather(a1, 1, o[1].long()[..., None].expand(a1.shape))
            return {"L·U = P·A": (_residual_rows(l @ u, pa, 1e-2, 1e-3),
                                  None)}
        case(f"lu{n}", "lu", decomp.lu, (a1,), lu_res)
        packed, perm = decomp.lu(a1)
        case(f"lu_solve{n}", "lu_solve", decomp.lu_solve, (packed, perm, b),
             lambda o, a1=a1, b=b: {"A·x = b": (_residual_rows(
                 (a1 @ o[0][..., None])[..., 0], b, 1e-2, 1e-2), a1)})

        def qr_res(o, a=a, eye=eye):
            q, r = o
            low = torch.tril(r, -1).abs().reshape(r.shape[0], -1).amax(1)
            return {"Q·R = A": (_residual_rows(q @ r, a, 1e-2, 1e-3), None),
                    "QᵀQ = I": (_residual_rows(
                        q.transpose(1, 2) @ q, eye.expand(q.shape), 1e-3,
                        1e-3), None),
                    "R upper": (low >= 1e-3, None)}
        case(f"qr{n}", "qr", decomp.qr, (a,), qr_res)
        spd = a.transpose(1, 2) @ a + 0.5 * eye
        case(f"cholesky{n}", "cholesky", decomp.cholesky, (spd,),
             lambda o, spd=spd: {"L·Lᵀ = A": (_residual_rows(
                 o[0] @ o[0].transpose(1, 2), spd, 1e-2, 1e-3), None)})
        chol = decomp.cholesky(spd)
        case(f"cholesky_solve{n}", "cholesky_solve", decomp.cholesky_solve,
             (chol, b), lambda o, spd=spd, b=b: {"A·x = b": (_residual_rows(
                 (spd @ o[0][..., None])[..., 0], b, 1e-2, 1e-2), spd)})
        sym = (a + a.transpose(1, 2)) / 2

        def eig_res(o, sym=sym):
            w, v = o
            wn = _f64(torch.linalg.eigvalsh, sym)
            return {"V·diag(w)·Vᵀ = A": (_residual_rows(
                v @ torch.diag_embed(w) @ v.transpose(1, 2), sym, 1e-2,
                1e-3), None),
                "w = eigvalsh(A)": (_residual_rows(w, wn, 1e-3, 1e-3), None)}
        case(f"eig{n}", "eig", decomp.symmetric_eigen, (sym,), eig_res)
        ai = a + n * eye
        inv_n = getattr(inv_mod, f"inv{n}")
        det_n = getattr(inv_mod, f"det{n}")
        case(f"inv{n}", "inv", inv_n, (ai,), lambda o, ai=ai: {
            "inv(A)": (_residual_rows(o[0], _f64(torch.linalg.inv, ai),
                                      5e-3, 1e-3), ai)})
        case(f"det{n}", "det", det_n, (ai,), lambda o, ai=ai: {
            "det(A)": (_residual_rows(o[0][:, None], _f64(
                torch.linalg.det, ai)[:, None], 5e-3, 1e-3), ai)})
        if n == 4:
            continue

        def svd_res(o, a=a, eye=eye):
            u, s_, vt = o
            sn = _f64(torch.linalg.svdvals, a)
            return {"U·Σ·Vᵀ = A": (_residual_rows(
                u @ torch.diag_embed(s_) @ vt, a, 1e-2, 1e-3), None),
                "UᵀU = I": (_residual_rows(u.transpose(1, 2) @ u,
                                            eye.expand(u.shape), 1e-3,
                                            2e-3), None),
                "σ = svdvals(A)": (_residual_rows(s_, sn, 1e-3, 1e-3), None),
                "σ descending": (torch.diff(s_, dim=-1).amax(1) > 1e-5,
                                 None)}
        case(f"svd{n}", "svd", decomp.svd, (a,), svd_res)
    return out


def examples_phase() -> dict:
    """The five ``examples/torch_core_*.py`` as subprocesses on the card,
    started together; each must exit 0. Returns name -> (exit code,
    seconds, its last line)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples",
                                      f"torch_core_{name}.py")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name in EXAMPLES}
    out = {}
    try:
        for name, proc in procs.items():
            so, se = proc.communicate(timeout=300)
            last = (so.strip().splitlines() or [""])[-1]
            out[name] = {"exit": proc.returncode, "last_line": last,
                         "seconds": time.perf_counter() - t0}
            print(f"example torch_core_{name}.py on the card: exit "
                  f"{proc.returncode} after {out[name]['seconds']:.1f} s; "
                  f"{last}")
            check(proc.returncode == 0,
                  f"examples/torch_core_{name}.py exited {proc.returncode}: "
                  f"{se.strip()[-600:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def ray_bench_arrays(n: int = RAY_N, seed: int = 3) -> dict:
    """The bench's raycast inputs (``bench.py`` ``bench_rays``), drawn by
    the same numpy calls in the same order: tags, params, poses, origins
    and unit directions as numpy arrays. ``scripts/export_rays_npz.py``
    builds the JAX side from the same arrays."""
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 3, n)
    radii = rng.uniform(0.2, 1.0, n).astype(np.float32)
    params = np.zeros((n, 8), np.float32)
    params[:, 0] = radii
    params[tags == 1, :3] = rng.uniform(0.2, 1.0,
                                        (int((tags == 1).sum()), 3))
    params[tags == 2, 1] = 0.3
    tag = np.where(tags == 1, shp.CUBOID,
                   np.where(tags == 2, shp.CAPSULE, shp.BALL))
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, -1, keepdims=True)
    centers = rng.normal(size=(n, 3)).astype(np.float32) * 2
    origins = centers + rng.normal(size=(n, 3)).astype(np.float32) * 5
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, -1, keepdims=True)
    return {"tag": tag.astype(np.int32), "params": params, "rotation": q,
            "translation": centers, "scale": np.ones((n,), np.float32),
            "origins": origins, "dirs": dirs}


def ray_scene(z: dict, device, dtype=torch.float32, params_scale=1.0):
    """(shapes, poses, origins, dirs) of :func:`ray_bench_arrays` output as
    the bench builds them: a ``ShapeSet`` with the default ``kinds``."""
    def t(key):
        return torch.from_numpy(np.asarray(z[key])).to(device, dtype)

    shapes = shp.ShapeSet(
        torch.from_numpy(z["tag"]).to(device, torch.int64),
        t("params") * params_scale, torch.zeros((0, 3), device=device),
        torch.zeros((0, 3), dtype=torch.int64, device=device))
    poses = Sim(t("rotation"), t("translation"), t("scale"))
    return shapes, poses, t("origins"), t("dirs")


def _ray_conditioning(z: dict, idx: np.ndarray):
    """For the rays ``idx``, in float64 on the CPU: their time of the same
    cast, and whether they graze their shape."""
    sub = {k: v[idx] for k, v in z.items()}
    t64 = ray.cast(*ray_scene(sub, "cpu", torch.float64)).numpy()
    t = [ray.cast(*ray_scene(sub, "cpu", torch.float64, 1.0 + s * RAY_GRAZE))
         .numpy() for s in (-1.0, 1.0)]
    hit = [np.isfinite(x) for x in t]
    return t64, (hit[0] != hit[1]) | _times_off(t[0], t[1], hit[0] & hit[1])


def _within(got, want, rtol, atol) -> np.ndarray:
    ok = np.zeros(got.shape, bool)
    fin = np.isfinite(got) & np.isfinite(want)
    ok[fin] = np.abs(got[fin] - want[fin]) <= atol + rtol * np.abs(want[fin])
    return ok


def _times_off(got, want, both) -> np.ndarray:
    """Rays hit on both sides whose times differ beyond RAY_RTOL /
    RAY_ATOL."""
    return both & ~_within(got, want, RAY_RTOL, RAY_ATOL)


def ray_path_phase() -> dict:
    """The bench's raycast section: 100,000 rays against the mixed
    ball / cuboid / capsule set, K chained casts ``o <- o + d (t 1e-6)``.
    The first cast is held against the JAX package's, stored in
    ``artifacts/rays100k_jax.npz`` by ``scripts/export_rays_npz.py``."""
    z = ray_bench_arrays()
    ref = np.load(NPZ_RAYS)
    check(int(ref["n"]) == RAY_N and int(ref["seed"]) == 3,
          "raycast: the stored JAX times are for another input")
    shapes, poses, origins, dirs = ray_scene(z, "cuda")
    got = ray.cast(shapes, poses, origins, dirs).cpu().numpy()
    want = ref["t"]
    hit_g, hit_w = np.isfinite(got), np.isfinite(want)
    both = hit_g & hit_w
    check(bool(both.any()), "raycast: no ray hits its shape")
    off = _times_off(got, want, both)
    t_err = float(np.abs(got[both] - want[both]).max())
    masks = np.flatnonzero(hit_g != hit_w)
    times = np.flatnonzero(off)
    idx = np.concatenate([masks, times])
    t64, grazing = _ray_conditioning(z, idx)
    in_mask = np.arange(idx.size) < masks.size
    both_near = (_within(got[idx], t64, RAY_RTOL, RAY_ATOL)
                 & _within(want[idx], t64, RAY_RTOL, RAY_ATOL))
    graze_near = grazing & _within(got[idx], t64, RAY_F64_RTOL, 0.0)
    excused = np.where(in_mask, grazing, both_near | graze_near)
    print(f"raycast first cast vs JAX: {int(hit_g.sum())} hits (JAX "
          f"{int(hit_w.sum())}, stored {int(ref['hits'])}); hit masks differ "
          f"on {masks.size} rays ({int(grazing[in_mask].sum())} grazing); "
          f"times off on {times.size} (rtol {RAY_RTOL}, atol {RAY_ATOL}): "
          f"{int(both_near[~in_mask].sum())} with both within that of "
          f"float64, {int(graze_near[~in_mask].sum())} grazing and within "
          f"{RAY_F64_RTOL} of float64; max |dt| where both hit {t_err:.3e}")
    check(bool(excused.all()),
          f"raycast: rays {idx[~excused][:5].tolist()} off the JAX cast "
          f"without a float32 reason")

    def body(o):
        t = ray.cast(shapes, poses, o, dirs)
        t = torch.where(torch.isfinite(t), t, 0.0)
        return o + dirs * (t[:, None] * 1e-6)  # the bench's chain

    def ray_end(c) -> dict:
        check(bool(torch.isfinite(c).all()) and c.shape == origins.shape,
              "raycast: non-finite or misshapen origins after the chain")
        return {"first_cast": {
            "hits": int(hit_g.sum()), "hits_jax": int(hit_w.sum()),
            "mask_differs": int(masks.size), "time_off": int(times.size),
            "grazing": int(grazing.sum()),
            "both_near_float64": int(both_near.sum()), "max_abs_dt": t_err}}

    return {"raycast_100k": chain_path(
        f"raycast n={RAY_N}", body, origins, RAY_ITERS, {},
        rate=("Mrays/s", RAY_N / 1e6), check_end=ray_end, profile_iters=4)}


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


# the pit paths' kernel counters: name -> (module, counter)
PIT_COUNTERS = {"gs_math_rhs": (gs_math, "LAUNCHES"),
                "gs_math_block": (gs_math, "LAUNCHES_BLOCK"),
                "build_fused": (build_fused, "LAUNCHES"),
                "fused_sweep": (gs_fused, "LAUNCHES_SWEEP"),
                "fused_substep1": (gs_fused, "LAUNCHES_SUBSTEP1"),
                "fused_integrate": (gs_fused, "LAUNCHES_INTEGRATE"),
                "fused_integrate_in_sweep": (gs_fused,
                                             "INTEGRATES_IN_SWEEP")}
# the fused path's counters: B9, B10, B11 and the B10 launches carrying
# B12 (the standalone B12 is not on the path)
FUSED_KERNELS = ("build_fused", "fused_sweep", "fused_substep1",
                 "fused_integrate_in_sweep")


def _pit_counts() -> dict:
    return {k: getattr(mod, attr) for k, (mod, attr) in PIT_COUNTERS.items()}


def run_path(name: str, arrays: dict, cfg: PipelineConfig, params,
             refs: dict | None, expect: tuple, *, warm: int = WARM_FRAMES,
             timed: int = TIMED_FRAMES, envelopes=None,
             timed_trail: bool = False, record=None) -> dict:
    """One configuration from a state (``arrays``: its
    ``state_to_arrays`` dict, or the state on the card): ``warm`` checked
    frames (the first ones held against the JAX reference frames in
    ``refs`` where there are any), then ``timed`` timed frames. ``expect`` names the kernel counters
    this path must move; every other counter must stay at 0. The counts
    are set to 0 just before the path runs and read just after.
    ``envelopes(state)`` gives the end state's kinetic-energy proxy and
    deepest penetration (default: the pit's). ``timed_trail`` also keeps
    the translations after each timed frame (references only, no sync);
    ``record(state)`` is kept after each timed frame (device tensors, no
    sync) as ``recorded``."""
    state = (state_from_arrays(arrays, device="cuda")
             if isinstance(arrays, dict) else arrays)
    n_ref = 0 if refs is None else sum(
        1 for k in refs if k.startswith("ref.")
        and k.endswith(".translation"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod, attr in PIT_COUNTERS.values():
        setattr(mod, attr, 0)
    dispatch.HOST_SYNCS = 0
    trail = []  # translations after each warm frame
    for f in range(warm):
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
        d_v = "not stored"
        if f"ref.{f}.linear" in refs:
            lin = state.bodies.vels.linear.cpu().numpy()
            d_v = f"{float(np.abs(lin - refs[f'ref.{f}.linear']).max()):.3e}"
        rel = [abs(int(pc[i]) - int(ref_pc[i])) / max(abs(int(ref_pc[i])), 1)
               for i in (0, 1)]
        print(f"{name} reference frame {f}: pairs {pc[0]} (ref {ref_pc[0]}) "
              f"contacts {pc[1]} (ref {ref_pc[1]}) bp_path {pc[3]} "
              f"max|dx| {d_tr:.3e} (limit {TRANSLATION_LIMITS[f]:.0e}) "
              f"max|dv| {d_v} host {dt * 1e3:.1f} ms")
        check(max(rel) <= COUNT_REL_LIMIT,
              f"{name} reference frame {f}: pair/contact counts off by "
              f"{max(rel):.2e} (limit {COUNT_REL_LIMIT})")
        check(d_tr <= TRANSLATION_LIMITS[f],
              f"{name} reference frame {f}: translations off by {d_tr:.3e}")
    warmed = (state, cfg)

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    counts = []
    torch.cuda.synchronize()
    warm_launches = _pit_counts()
    warm_syncs = dispatch.HOST_SYNCS
    t0 = time.perf_counter()
    start.record()
    recorded = []
    for _ in range(timed):
        state, cfg = step_checked(state, params, cfg)
        counts.append(state.pair_count)
        if timed_trail:
            trail.append(state.bodies.poses.translation)
        if record is not None:
            recorded.append(record(state))
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = _pit_counts()
    syncs = dispatch.HOST_SYNCS
    check(_finite(state), f"{name} timed frames: non-finite state")
    for kernel, n in launches.items():
        check((n > 0) == (kernel in expect),
              f"{name}: kernel {kernel} launched {n} times on this path "
              f"(expected {'some' if kernel in expect else 'none'})")
    counts = [c.cpu().numpy() for c in counts]
    mc = cfg.max_colors
    ke, pen = (envelopes or _envelopes)(state)
    ms = start.elapsed_time(end) / timed
    metrics = {
        "frames_timed": timed, "ms_per_step": ms,
        "steps_per_s": 1e3 / ms,
        "host_ms_per_step": 1e3 * host_s / timed,
        "pairs": int(counts[-1][0]), "contacts": int(counts[-1][1]),
        # the class counts ride along under a window ladder only
        "colours_in_use": (max(int(np.count_nonzero(c[9:9 + mc]))
                               for c in counts)
                           if len(counts[0]) > 8 else None),
        "bp_path_mix": {nm: sum(int(c[3]) == i for c in counts)
                        for i, nm in enumerate(("hit", "repair", "full"))},
        "host_syncs_per_step": (syncs - warm_syncs) / timed,
        "launches": launches,
        **{f"{k}_launches_per_step": (n - warm_launches[k]) / timed
           for k, n in launches.items()},
        "kinetic_energy": ke, "max_penetration": pen,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "ladder": [w for w in cfg.gs_windows if w],
    }
    per_step = ", ".join(
        f"{k} {metrics[k + '_launches_per_step']:.2f}" for k in launches
        if launches[k])
    print(f"config {name}: {ms:.2f} ms/step ({1e3 / ms:.2f} steps/s) over "
          f"{timed} frames by CUDA events; launches/step: {per_step}; "
          f"{metrics['host_syncs_per_step']:.2f} host syncs/step; KE "
          f"{ke:.4f}, max penetration {pen:.5f}")
    if "build_fused" in expect:
        # one B9 launch and, per substep, one B11 and one B10 carrying B12
        # per step() call (a regrow re-runs the step); no standalone B12.
        # With joints, per substep two B10 launched alone and no B11
        timed_n = {k: launches[k] - warm_launches[k] for k in FUSED_KERNELS}
        subs = params.num_solver_iterations
        builds = timed_n["build_fused"]
        if state.joints is None:
            ok = all(timed_n[k] == subs * builds for k in FUSED_KERNELS[1:])
            what = f"{subs} of B11, B10 and B10 carrying B12"
        else:
            ok = (timed_n["fused_sweep"] == 2 * subs * builds
                  and launches["fused_substep1"] == 0
                  and launches["fused_integrate_in_sweep"] == 0)
            what = f"{2 * subs} of B10 alone and no B11"
        check(ok and builds >= timed and launches["fused_integrate"] == 0,
              f"{name}: fused launches {timed_n} are not one build and "
              f"{what} per step, or a standalone B12 was launched")
        metrics["regrow_frames"] = builds - timed
    return {"metrics": metrics, "warmed": warmed, "end": (state, cfg),
            "trail": trail, "counts": counts, "recorded": recorded}


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
    out.update(fused_gates(runs, params))
    return out


def static_gates(runs: dict, params, z: dict, zs: dict) -> dict:
    """``chained_ss``'s readings of the bench's short gate, printed beside
    the JAX package's and not gated (the JAX package's own reading
    diverges there): three ``step`` s of ``chained_ss`` against three of the
    warmed ``ladder`` and of ``chained_ps``, from (1) ``chained_ss``'s
    warmed state (warmed under the stored configuration), (2) the state
    after the bench's own warm-up, six checked frames from the settled
    state under the bench's initial configuration (broad-phase budgets of
    64 / 8 / 16 / 48 and rungs of 128), as the JAX package's reading was
    taken, and (3) from (1) against the ladder at ``chained_ss``'s pair
    capacity. The ladder's cache check ignores the slot layout but not
    the capacity: at its own capacity (37,888 against 41,984) it refreshes
    and colours the pairs anew, at ``chained_ss``'s it keeps the cached
    colours, so (3) holds the same colour classes on both sides."""
    lad_cfg = runs["ladder"]["warmed"][1]
    ps_cfg = runs["chained_ps"]["warmed"][1]

    def short(st, cfg_ss, others=(("ladder", lad_cfg),
                                  ("chained_ps", ps_cfg))) -> dict:
        out = {}
        for name, other in others:
            ends = []
            for cfg in (cfg_ss, other):
                s = st
                for _ in range(SHORT_GATE_STEPS):
                    s = step(s, params, cfg)
                ends.append(s.bodies.poses.translation)
            out[f"vs_{name}"] = _max_dp(*ends)
        return out

    st, cfg = runs["chained_ss"]["warmed"]
    stored = short(st, cfg)
    s, c = (state_from_arrays(z, device="cuda"),
            _config_of(zs["initial_config_json"]))
    warm = []
    for _ in range(WARM_FRAMES):
        s, c = step_checked(s, params, c)
        pc = s.pair_count.cpu().numpy()
        warm.append((int(pc[0]), int(pc[3])))
    bench = short(s, c)
    same_colours = short(st, cfg, (("ladder", dataclasses.replace(
        lad_cfg, pair_capacity=cfg.pair_capacity)),))
    jax = {f"vs_{n}": float(zs[f"short_gate.{n}"])
           for n in ("ladder", "chained_ps")}
    jax_frames = {k: [float(zs[f"{k}_dp.{f}"]) for f in range(3)]
                  for k in ("ladder", "ps")}
    print(f"short gate chained_ss over {SHORT_GATE_STEPS} steps (not "
          f"gated): from its warmed state {stored}; after the bench's "
          f"warm-up (pairs, bp_path a frame {warm}) {bench}; against the "
          f"ladder at its pair capacity (the same colours) {same_colours}; "
          f"the JAX package's after "
          f"its warm-up {jax}, and its reference frames 1-3 against the "
          f"ladder's {jax_frames['ladder']} and chained_ps's "
          f"{jax_frames['ps']}")
    return {"chained_ss_short_gate": {
        "stored_warmup": stored, "bench_warmup": bench,
        "ladder_same_colours": same_colours, "bench_warmup_frames": warm,
        "jax_bench_warmup": jax, "jax_reference_frames": jax_frames}}


def fused_gates(runs: dict, params) -> dict:
    """``fused`` against the ladder: the short gate and the envelope gate
    (both checked), and the bench's K-gate distance to the ladder's end
    positions, recorded beside the JAX package's own fused-vs-ladder
    distance (its warmstart adds in another order than the ladder's, and
    one ulp grows chaotically over 56 frames)."""
    out = {}
    lad, fus = runs["ladder"], runs["fused"]
    st, cfg_f = fus["warmed"]
    ends = []
    for cfg in (cfg_f, lad["warmed"][1]):
        s = st
        for _ in range(SHORT_GATE_STEPS):
            s = step(s, params, cfg)
        ends.append(s.bodies.poses.translation)
    err = _max_dp(*ends)
    out["fused_vs_ladder_3_steps"] = err
    print(f"gate fused vs ladder over {SHORT_GATE_STEPS} steps from one "
          f"warmed state: max|dp| {err:.3e} (limit {SHORT_GATE_LIMIT})")
    check(np.isfinite(err) and err <= SHORT_GATE_LIMIT,
          f"fused diverges from the ladder by {err:.3e} m over "
          f"{SHORT_GATE_STEPS} steps")
    m_f, m_l = fus["metrics"], lad["metrics"]
    ke_f, pen_f = m_f["kinetic_energy"], m_f["max_penetration"]
    ke_l, pen_l = m_l["kinetic_energy"], m_l["max_penetration"]
    out["envelopes_fused"] = {"fused": {"ke": ke_f, "pen": pen_f},
                              "ladder": {"ke": ke_l, "pen": pen_l}}
    print(f"gate fused envelopes after {WARM_FRAMES + TIMED_FRAMES} frames: "
          f"KE {ke_f:.4f} vs ladder {ke_l:.4f}, max penetration "
          f"{pen_f:.5f} vs {pen_l:.5f}")
    check(pen_f <= pen_l + ENVELOPE_PEN_SLACK
          and ke_f <= ENVELOPE_KE_FACTOR * ke_l + ENVELOPE_KE_SLACK,
          "fused envelope exceeds the ladder's (drift)")
    end = _max_dp(fus["end"][0].bodies.poses.translation,
                  lad["end"][0].bodies.poses.translation)
    first = _max_dp(fus["trail"][0], lad["trail"][0])
    warm = _max_dp(fus["trail"][-1], lad["trail"][-1])
    zf = np.load(NPZ_FUSED)
    jax_dp = [float(zf[f"ladder_dp.{f}"]) for f in range(3)]
    out["fused_vs_ladder"] = {
        "after_1_frame": first, f"after_{WARM_FRAMES}_frames": warm,
        f"after_{WARM_FRAMES + TIMED_FRAMES}_frames": end,
        "jax_after_1_2_3_frames": jax_dp}
    print(f"K-gate distance fused vs ladder (recorded, not checked): "
          f"max|dp| {first:.3e} after 1 frame, {warm:.3e} after "
          f"{WARM_FRAMES}, {end:.3e} after {WARM_FRAMES + TIMED_FRAMES} "
          f"(the bench's limit {END_GATE_LIMIT}); the JAX package's own "
          f"fused vs ladder after 1, 2, 3 frames: "
          + ", ".join(f"{d:.3e}" for d in jax_dp))
    return out


def _config_of(blob) -> PipelineConfig:
    return PipelineConfig.from_dict(json.loads(str(blob)))


def static_arrays() -> dict:
    """The settled pit's ``chained_ss`` group of the JAX package's static
    slots export, without its ``pit.`` prefix."""
    return {k[len("pit."):]: v for k, v in load_arrays(NPZ_STATIC).items()
            if k.startswith("pit.")}


def static_refs(z: dict, zs: dict) -> dict:
    """``run_path``'s references from the stored offsets: each frame's
    translations (the settled state's plus the offset) and counts."""
    tr0 = z["bodies.poses.translation"]
    refs = {}
    for f in range(3):
        refs[f"ref.{f}.translation"] = tr0 + zs[f"ref.{f}.offset"]
        refs[f"ref.{f}.pair_count"] = zs[f"ref.{f}.pair_count"]
    return refs


def static_layout(state, cfg: PipelineConfig, what: str) -> dict:
    """Static placement is on and holds: the capacity holds the ladder and
    a tail of 256, the cached tag's flag is the ladder's (not 1, the
    colour-major layout's), every valid pair below the tail sits in its
    colour's rung. Returns the flag, the ladder's sum and the tail rows."""
    w = np.concatenate([[0], np.cumsum(cfg.gs_windows[:cfg.max_colors])])
    flag = 2 + zlib.crc32(repr(tuple(
        cfg.gs_windows[:cfg.max_colors])).encode()) % 2000000000
    valid = state.bp_pairs.valid.cpu().numpy()
    cols = state.bp_colors[0].cpu().numpy()
    slots = np.nonzero(valid[:w[-1]])[0]
    c = np.clip(cols[slots], 1, cfg.max_colors)
    placed = bool(((cols[slots] >= 1) & (w[c - 1] <= slots)
                   & (slots < w[c])).all())
    tail = int(valid[w[-1]:].sum())
    check(cfg.pair_capacity >= w[-1] + 256 and state.bp_colors[3] == flag
          and flag != 1 and placed,
          f"{what}: static placement is not on (capacity "
          f"{cfg.pair_capacity} for a ladder of {w[-1]}, flag "
          f"{state.bp_colors[3]} for {flag}, rows in their rungs {placed})")
    return {"flag": int(flag), "ladder_rows": int(w[-1]),
            "pair_capacity": cfg.pair_capacity, "tail_rows": tail}


def static_slots_checks(run: dict, zs: dict) -> dict:
    """``chained_ss``'s layout after the warm frames and after each timed
    frame (its tail rows), beside the JAX package's reference frames."""
    out = {"warmed": static_layout(*run["warmed"], "chained_ss warmed"),
           "jax_tail_rows": [int(zs[f"ref.{f}.tail_rows"])
                             for f in range(3)],
           "jax_flags": [int(zs[f"ref.{f}.slot_flag"]) for f in range(3)]}
    end_cfg = run["end"][1]
    w = sum(end_cfg.gs_windows[:end_cfg.max_colors])
    out["timed_tail_rows"] = [int(v[w:].sum()) for v, _ in run["recorded"]]
    out["timed_flags"] = sorted({f for _, f in run["recorded"]})
    out["end"] = static_layout(*run["end"], "chained_ss end")
    print(f"chained_ss static placement: warmed {out['warmed']}, end "
          f"{out['end']}; tail rows after each timed frame "
          f"{out['timed_tail_rows']} (flags {out['timed_flags']}); the JAX "
          f"package's reference frames: tail rows {out['jax_tail_rows']}, "
          f"flags {out['jax_flags']}")
    return out


def path_phase() -> dict:
    """The configurations (``chained_ss`` with ``SS_TIMED_FRAMES`` timed
    frames), then the gates. Returns name → run."""
    z = dict(np.load(NPZ))
    zl = dict(np.load(NPZ_LADDER))
    zf = dict(np.load(NPZ_FUSED))
    zs = static_arrays()
    params = SimParams()
    cfg_ps = _config_of(z["config_json"])
    cfg_lad = _config_of(zl["config_json"])
    cfg_fused = _config_of(zf["config_json"])
    rep = dataclasses.replace
    plan = (
        ("chained_ps", cfg_ps, z, ("gs_math_rhs",), {}),
        ("ladder", cfg_lad, zl, ("gs_math_block",), {}),
        ("chained", rep(cfg_lad, gs_chained=True), None,
         ("gs_math_block",), {}),
        ("chained_rr", rep(cfg_lad, gs_chained=True, gs_rhs_in_rung=True),
         None, ("gs_math_rhs",), {}),
        ("fused", cfg_fused, zf, FUSED_KERNELS, {}),
        ("chained_ss", _config_of(zs["config_json"]), static_refs(z, zs),
         ("gs_math_rhs",), dict(
             timed=SS_TIMED_FRAMES,
             record=lambda s: (s.bp_pairs.valid.clone(), s.bp_colors[3]))),
    )
    runs = {name: run_path(name, z, cfg, params, refs, expect, **kw)
            for name, cfg, refs, expect, kw in plan}
    runs["chained_ss"]["static"] = static_slots_checks(runs["chained_ss"],
                                                       zs)
    runs["gates"] = gates(runs, params)
    runs["gates"].update(static_gates(runs, params, z, zs))
    return runs


# ---------------------------------------------------------------------------
# the box scenes: cuboid-cuboid SAT manifolds, 4-point constraints through
# B2 (ladder) and B9-B11 (fused)
# ---------------------------------------------------------------------------

NPZ_BOXES = os.path.join(ROOT, "artifacts", "boxes_small.npz")
NPZ_PYRAMID = os.path.join(ROOT, "artifacts", "pyramid20.npz")
REF_SCENE = "pyramid20"  # the scene of NPZ_PYRAMID
BOX_LEVELS = 50  # 42,925 cuboids and the ground
# the pyramid the physical checks hold: 20 levels, the README's pyramid3
CHECK_LEVELS = 20
BOX_WARM_FRAMES = 15
# 10 timed frames (were 20): the run's time limit, when the scale-out
# and testbed phases came; the physical checks keep 35 frames
BOX_TIMED_FRAMES = 10
BOX_CHECK_FRAMES = 35
# records of artifacts/pyramid43k.npz (the JAX package's 50-level run):
# record r holds the positions after 1 + 10 (r - 1) steps
NPZ_PYRAMID43K = os.path.join(ROOT, "artifacts", "pyramid43k.npz")
RECORD_STEPS = (1, 11, 21, 31)
# path -> the configuration of ``builders.box_configs`` and its kernels
BOX_PATHS = {"box_ladder": ("ladder", ("gs_math_block",)),
             "box_fused": ("fused", FUSED_KERNELS)}
# the physical checks: level 0 rests on the ground (centres at y = 0.5),
# no box rises; the fused pile's envelope within the ladder's
LEVEL0_Y, LEVEL0_TOL, RISE_TOL = 0.5, 1e-2, 1e-2
# pyramid(50) falls in on itself under this solver, in the port as in the
# JAX package's own 50-level recording (ROADMAP C7): level 0 sinks ~0.02 m
# and the upper levels pass 1 m into each other by frame 35, whatever
# gs_cmax; so its level-0 and envelope figures are recorded, and the
# physical checks are held on pyramid(CHECK_LEVELS), which recovers


def box_arrays(path: str, prefix: str) -> dict:
    """The entries of an exported box file under ``prefix``, the prefix
    cut off."""
    with np.load(path) as z:
        return {k[len(prefix):]: z[k] for k in z.files
                if k.startswith(prefix)}


def box_state(scene: str, name: str, device):
    """A scene of ``boxes_small.npz`` as the JAX package warmed it under
    configuration ``name``: (state on ``device``, configuration)."""
    z = box_arrays(NPZ_BOXES, f"{scene}.{name}.")
    return (state_from_arrays(box_arrays(NPZ_BOXES, f"{scene}.{name}.state."),
                              device=device),
            PipelineConfig.from_dict(json.loads(str(z["config_json"]))))


def box_sweeps(device, count: int = 2) -> list:
    """The first ``count`` sweeps (B2, P = 4) of the first frame of the
    warmed ``pyramid(6)`` under the ladder."""
    state, cfg = box_state("pyramid6", "ladder", device)
    return record_sweeps(lambda: step_checked(state, SimParams(), cfg),
                         count)


def box_fused_calls(device) -> list:
    """The first substep's B11 and B10 calls (P = 4) of the first frame of
    the warmed ``pyramid(6)`` under ``fused``."""
    state, cfg = box_state("pyramid6", "fused", device)
    return record_fused(lambda: step_checked(state, SimParams(), cfg))


def box_build_call(device):
    """The first B9 call (P = 4) of the first frame of the warmed
    ``pyramid(6)`` under ``fused``."""
    state, cfg = box_state("pyramid6", "fused", device)
    return record_fused(lambda: step_checked(state, SimParams(), cfg), 1,
                        ("build_constraints_fused",))[0]


def box_envelopes(state) -> tuple[float, float]:
    """Kinetic-energy proxy (sum |v|^2; the boxes share one mass) and the
    deepest penetration of the end state's contact manifolds
    (:func:`contact_depths`)."""
    vel = state.bodies.vels.linear
    depth = contact_depths(state)
    return (float((vel * vel).sum()),
            max(float(depth.max()) if depth.numel() else 0.0, 0.0))


def contact_depths(state) -> torch.Tensor:
    """The depths of the live points of the state's contact manifolds (the
    narrow phase over the cached pair list, 4 points wide; a state that
    keeps no pair cache, ``bp_slack`` 0, gives its last frame's manifolds,
    as its constraints hold them)."""
    if state.bp_pairs is None:
        cons = state.prev_constraints
        slot = torch.arange(cons.info_dist.shape[1],
                            device=cons.info_dist.device)
        live = cons.valid[:, None] & (slot[None, :]
                                      < cons.num_points[:, None])
        return -cons.info_dist[live]
    c, _ = narrow_mod.narrow_phase(state.bodies.poses, state.shapes,
                                   state.bp_pairs,
                                   SimParams().prediction_distance, p_max=4)
    slot = torch.arange(4, device=c.dist.device)
    live = c.valid[:, None] & (slot[None, :] < c.num_points[:, None])
    return -c.dist[live]


def box_reference_phase(params) -> dict:
    """``pyramid(20)`` from the JAX package's warmed states, three frames
    of each configuration against the JAX frames in ``pyramid20.npz``."""
    out = {}
    for name in ("ladder", "fused"):
        refs = box_arrays(NPZ_PYRAMID, f"{REF_SCENE}.{name}.")
        state = state_from_arrays(box_arrays(NPZ_PYRAMID,
                                             f"{REF_SCENE}.{name}.state."),
                                  device="cuda")
        cfg = PipelineConfig.from_dict(json.loads(str(refs["config_json"])))
        errs = []
        for f in range(len(TRANSLATION_LIMITS)):
            state, cfg = step_checked(state, params, cfg)
            check(_finite(state), f"{REF_SCENE} {name} frame {f}: non-finite")
            pc = state.pair_count.cpu().numpy()
            ref_pc = refs[f"ref.{f}.pair_count"]
            d_tr = float(np.abs(state.bodies.poses.translation.cpu().numpy()
                                - refs[f"ref.{f}.translation"]).max())
            d_v = float(np.abs(state.bodies.vels.linear.cpu().numpy()
                               - refs[f"ref.{f}.linear"]).max())
            rel = [abs(int(pc[i]) - int(ref_pc[i]))
                   / max(abs(int(ref_pc[i])), 1) for i in (0, 1)]
            print(f"{REF_SCENE} {name} reference frame {f}: pairs {pc[0]} (ref "
                  f"{ref_pc[0]}) contacts {pc[1]} (ref {ref_pc[1]}) cuboid "
                  f"pairs {pc[6]} (ref {ref_pc[6]}) max|dx| {d_tr:.3e} "
                  f"(limit {TRANSLATION_LIMITS[f]:.0e}) max|dv| {d_v:.3e}")
            check(max(rel) <= COUNT_REL_LIMIT,
                  f"{REF_SCENE} {name} frame {f}: pair/contact counts off by "
                  f"{max(rel):.2e} (limit {COUNT_REL_LIMIT})")
            check(d_tr <= TRANSLATION_LIMITS[f],
                  f"{REF_SCENE} {name} frame {f}: translations off by "
                  f"{d_tr:.3e}")
            errs.append({"max_dx": d_tr, "max_dv": d_v,
                         "pairs": int(pc[0]), "contacts": int(pc[1])})
        out[name] = errs
    return out


def box_kernel_checks(runs: dict, params, summaries: dict) -> None:
    """B2, B9, B11 and B10 carrying B12 at P = 4 on the first frame after
    the warm frames of ``pyramid(50)`` (:func:`p4_kernel_checks`); adds each
    kernel's numbers to its summary under ``pyramid50_*``."""
    p4_kernel_checks(runs, params, summaries, ("box_ladder", "box_fused"),
                     "pyramid50")


def p4_kernel_checks(runs: dict, params, summaries: dict, paths: tuple,
                     label: str) -> None:
    """B2, B9, B11 and B10 carrying B12 at P = 4 on the first frame after
    the warm frames of the runs of ``paths`` (ladder, fused), recorded from
    ``step_checked``: B2's two sweeps of substep 1 and B11 / B10 one launch
    each against the same kernel launched rung by rung or colour by colour
    and their repeats (bit for bit) and against the plain versions; B9
    against its plain version and its contiguous copies. Adds each
    kernel's numbers to its summary under ``<label>_*``."""
    state, cfg = runs[paths[0]]["warmed"]
    calls = record_sweeps(lambda: step_checked(state, params, cfg), 2)
    check(all(c.kw["p_max"] == 4 for c in calls),
          f"{label} ladder: the sweeps are not 4 points wide")
    cases = [_sweep_case("gs_math_block", f"{label} ladder sweep {k + 1}",
                         call, True) for k, call in enumerate(calls)]
    row = summaries["gs_math_block"]
    row["max_abs_err"] = max([row["max_abs_err"]]
                             + [c["max_abs_err"] for c in cases])
    row.update({f"{label}_ms": sum(c["ms"] for c in cases),
                f"{label}_plain_ms": sum(c["plain_ms"] for c in cases),
                f"{label}_rows": cases[0]["rows"],
                f"{label}_rungs": cases[0]["rungs"]})
    state, cfg = runs[paths[1]]["warmed"]

    def run():
        step_checked(state, params, cfg)

    build = record_fused(run, 1, ("build_constraints_fused",))[0]
    poses, vels, mprops, contacts, bparams = build.args
    z = dict(p_max=contacts.points_a.shape[1], poses=poses, vels=vels,
             mprops=mprops, contacts=contacts, ctot=contacts.capacity,
             n=poses.translation.shape[0])
    check(z["p_max"] == 4, f"{label} fused: the build is not 4 points wide")
    check(b9_from_copies(b9_args(z, bparams)),
          f"build_fused {label}: strided contact fields and contiguous "
          "copies give different bits")
    b9, _ = _b9_case(z, f"{label} C={z['ctot']} P=4", True, bparams)
    row = summaries["build_fused"]
    row["max_abs_err"] = max(row["max_abs_err"], b9["max_abs_err"])
    row.update({f"{label}_ms": b9["ms"], f"{label}_plain_ms": b9["plain_ms"],
                f"{label}_C": z["ctot"]})
    for call in record_fused(run):
        check((call.name == "fused_sweep") == ("integrate" in call.kw),
              f"{call.name} {label}: the step's B10 does not carry B12")
        check(call.kw["p_max"] == 4, f"{call.name} {label}: not P = 4")
        got = fused_bits(call, label)
        err, ratio = _fused_check(call.name, label, got,
                                  run_fused(call, "plain"), RTOL, ATOL)
        row = summaries[call.name]
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row[f"{label}_ms"] = _median_ms(lambda: run_fused(call, "kernel"))
        print(f"{call.name} {label} max|d|={err:.3e} tol-ratio "
              f"{ratio:.3f}; grid {gs_fused.LAST_GRID[call.name]} blocks; "
              f"= colour by colour bit for bit, {FUSED_REPEATS} repeats bit "
              f"for bit; kernel {row[f'{label}_ms'] * 1e3:.2f} us")


def _physics(tr, y0, levels: int) -> dict:
    """Level 0's largest distance from y = 0.5, the highest rise over the
    start, and the range of the drops."""
    drop = y0[1:] - tr[1:, 1]
    return {"level0_max_off": float((tr[1:1 + levels ** 2, 1]
                                     - LEVEL0_Y).abs().max()),
            "max_rise": float((tr[:, 1] - y0).max()),
            "drop_min": float(drop.min()), "drop_max": float(drop.max()),
            "drop_median": float(drop.median())}


def _print_physics(label: str, m: dict) -> None:
    print(f"{label}: level 0 within {m['level0_max_off']:.3e} m of y = "
          f"{LEVEL0_Y} (limit {LEVEL0_TOL}); highest rise "
          f"{m['max_rise']:.3e} m (limit {RISE_TOL}); boxes "
          f"{m['drop_min']:.4f}..{m['drop_max']:.4f} m below their start, "
          f"median {m['drop_median']:.4f}")


def box_physics_phase(params) -> dict:
    """``pyramid(CHECK_LEVELS)`` from its first state under ``ladder`` and
    ``fused`` for as many frames as the 50-level paths run: level 0 stays
    within ``LEVEL0_TOL`` of y = 0.5, no box rises more than ``RISE_TOL``,
    the fused pile's deepest penetration within the ladder's plus 5e-3 and
    its kinetic-energy proxy within twice the ladder's plus 0.1."""
    from wgmath_tpu_torch.scenes.builders import box_configs, pyramid

    out, env = {}, {}
    for name in ("ladder", "fused"):
        state = pyramid(CHECK_LEVELS, device="cuda")
        y0 = state.bodies.poses.translation[:, 1].clone()
        n = int(y0.shape[0])
        cfg = PipelineConfig(**box_configs(n)[name])
        for _ in range(BOX_CHECK_FRAMES):
            state, cfg = step_checked(state, params, cfg)
        check(_finite(state), f"pyramid{CHECK_LEVELS} {name}: non-finite")
        m = _physics(state.bodies.poses.translation, y0, CHECK_LEVELS)
        env[name] = box_envelopes(state)
        m.update(kinetic_energy=env[name][0], max_penetration=env[name][1])
        _print_physics(f"pyramid{CHECK_LEVELS} {name} after "
                       f"{BOX_CHECK_FRAMES} frames", m)
        check(m["level0_max_off"] <= LEVEL0_TOL,
              f"pyramid{CHECK_LEVELS} {name}: level 0 left the ground")
        check(m["max_rise"] <= RISE_TOL,
              f"pyramid{CHECK_LEVELS} {name}: a box rose {m['max_rise']:.3e}")
        out[name] = m
    (ke_l, pen_l), (ke_f, pen_f) = env["ladder"], env["fused"]
    print(f"gate pyramid{CHECK_LEVELS} fused envelopes: KE {ke_f:.4f} vs "
          f"ladder {ke_l:.4f}, max penetration {pen_f:.5f} vs {pen_l:.5f}")
    check(pen_f <= pen_l + ENVELOPE_PEN_SLACK
          and ke_f <= ENVELOPE_KE_FACTOR * ke_l + ENVELOPE_KE_SLACK,
          f"pyramid{CHECK_LEVELS} fused envelope exceeds the ladder's")
    return out


def record_drops(trail: list, y0) -> dict:
    """The dynamic bodies' median and largest drop after each of
    ``RECORD_STEPS`` steps of a run (``trail``: translations after each
    frame), beside the JAX package's 50-level recording's."""
    with np.load(NPZ_PYRAMID43K) as z:
        pos, dyn = z["positions"], z["dynamic"].astype(bool)
    out = {}
    for r, steps in enumerate(RECORD_STEPS, start=1):
        if steps > len(trail):
            break
        drop = (y0 - trail[steps - 1][:, 1])[torch.from_numpy(dyn).cuda()]
        jax_drop = pos[0, dyn, 1] - pos[r, dyn, 1]
        out[steps] = {"median": float(drop.median()),
                      "max": float(drop.max()),
                      "jax_median": float(np.median(jax_drop)),
                      "jax_max": float(jax_drop.max())}
    return out


def box_phase(params) -> dict:
    """The box scenes: ``pyramid(20)`` against the JAX frames, the physical
    checks on ``pyramid(CHECK_LEVELS)``, then ``pyramid(50)`` from its
    first state under ``ladder`` and ``fused`` (``BOX_WARM_FRAMES`` warm
    frames, ``BOX_TIMED_FRAMES`` timed): finite, no box rising, its level
    0 and envelopes recorded, and its drops beside the JAX package's
    50-level recording (recorded). Returns path name -> run, plus
    ``jax_frames`` and ``box_checks``."""
    runs = {"jax_frames": box_reference_phase(params)}
    checks = {f"pyramid{CHECK_LEVELS}": box_physics_phase(params)}
    from wgmath_tpu_torch.scenes.builders import box_configs, pyramid

    state0 = pyramid(BOX_LEVELS, device="cpu")
    arrays = state_to_arrays(state0)
    y0 = state0.bodies.poses.translation[:, 1].cuda()
    n = int(state0.bodies.poses.translation.shape[0])
    for path, (name, expect) in BOX_PATHS.items():
        cfg = PipelineConfig(**box_configs(n)[name])
        runs[path] = run_path(path, arrays, cfg, params, None, expect,
                              warm=BOX_WARM_FRAMES, timed=BOX_TIMED_FRAMES,
                              envelopes=box_envelopes, timed_trail=True)
        m = _physics(runs[path]["end"][0].bodies.poses.translation, y0,
                     BOX_LEVELS)
        m["drops_beside_jax_43k"] = record_drops(runs[path]["trail"], y0)
        _print_physics(f"{path} after {BOX_WARM_FRAMES + BOX_TIMED_FRAMES} "
                       "frames (recorded)", m)
        for steps, d in m["drops_beside_jax_43k"].items():
            print(f"{path} after {steps} steps: drop median {d['median']:.6f}"
                  f" max {d['max']:.6f} m; the JAX package's 50-level "
                  f"recording: median {d['jax_median']:.6f} max "
                  f"{d['jax_max']:.6f}")
        check(m["max_rise"] <= RISE_TOL, f"{path}: a box rose "
              f"{m['max_rise']:.3e} m")
        checks[path] = m
    m_l, m_f = runs["box_ladder"]["metrics"], runs["box_fused"]["metrics"]
    checks["envelopes"] = {
        "fused": {"ke": m_f["kinetic_energy"], "pen": m_f["max_penetration"]},
        "ladder": {"ke": m_l["kinetic_energy"],
                   "pen": m_l["max_penetration"]}}
    print(f"box_fused envelopes (recorded): KE {m_f['kinetic_energy']:.4f} "
          f"vs ladder {m_l['kinetic_energy']:.4f}, max penetration "
          f"{m_f['max_penetration']:.5f} vs {m_l['max_penetration']:.5f}")
    runs["box_checks"] = checks
    return runs


# ---------------------------------------------------------------------------
# the primitive rain: support-mapped contacts (GJK, EPA, PFM manifolds)
# ---------------------------------------------------------------------------

NPZ_PRIMITIVES = os.path.join(ROOT, "artifacts", "primitives3_small.npz")
PRIM_SCENE = "primitives3"  # the scene of NPZ_PRIMITIVES: per_kind 40
PRIM_PER_KIND = 2000  # 10,000 dynamic bodies and the ground
# the lower layers land by ~90 frames (the top one starts ~29.5 m up)
PRIM_WARM_FRAMES = 90
# 10 timed frames (were 20: the run's time limit); the
# physical checks on primitives3(40) keep 110 frames
PRIM_TIMED_FRAMES = 10
PRIM_CHECK_FRAMES = 110
PRIM_PATHS = {"prim_ladder": ("ladder", ("gs_math_block",)),
              "prim_fused": ("fused", FUSED_KERNELS)}
# the timed window must hold this many support-mapped pairs a frame
PRIM_MIN_PFM_PAIRS = 2000
# the JAX frames (each from JAX's state before it): every count exactly but
# the contacts' and their classes', which may differ by one contact; at
# least PRIM_NEAR_SHARE of the bodies within the pit's limit of the frame,
# every body within PRIM_FAR_ATOL. GJK and EPA iterate in f32, and an ulp
# sends a near-degenerate pair into another simplex
# (tests/test_torch_gjk.py); such a pair's two bodies move apart from
# JAX's by up to ~3e-2 m in a frame (tests/test_torch_pipeline_primitives.py)
PRIM_NEAR_SHARE, PRIM_FAR_ATOL = 0.85, 5e-2
# the physical checks, held on primitives3(40) over as many frames as the
# 10k paths run: no dynamic centre below the ground's top, at most
# PRIM_DEEP_SHARE of the live contact points deeper than PRIM_DEEPEST (the
# deepest is recorded: an f32 GJK that finds a touching pair's cores
# overlapping hands EPA a flat simplex, and the contact comes out up to
# ~0.8 m deep; the JAX package's own narrow phase gives 0.40 m on its own
# 62nd frame of this scene, ROADMAP C9). At 10,000 bodies the EPA batch
# (the JAX package's epa_cap, 256) overflows and the pairs past it keep
# GJK's answer, a zero depth: bodies sink through the ground there, so the
# 10k figures are recorded (ROADMAP C8)
PRIM_GROUND_Y, PRIM_DEEPEST, PRIM_DEEP_SHARE = 0.0, 0.1, 0.01


def prim_counts_match(got, want) -> bool:
    """Every count exactly but the contacts' and their classes', which may
    differ by one contact."""
    got, want = np.asarray(got), np.asarray(want)
    d_contacts = abs(int(got[1]) - int(want[1]))
    rest = np.r_[0, 2:8]
    return (np.array_equal(got[rest], want[rest]) and d_contacts <= 1
            and int(np.abs(got[8:] - want[8:]).sum()) <= 2 * d_contacts)


def primitives_reference_phase(params) -> dict:
    """``primitives3(40)`` against the JAX frames in
    ``primitives3_small.npz``: under ``ladder`` and ``fused`` three frames,
    each from JAX's state before it."""
    out = {}
    for name in ("ladder", "fused"):
        errs = []
        for f in range(len(TRANSLATION_LIMITS)):
            start = (f"{PRIM_SCENE}.{name}." if f == 0
                     else f"{PRIM_SCENE}.{name}.ref.{f - 1}.")
            refs = box_arrays(NPZ_PRIMITIVES, f"{PRIM_SCENE}.{name}.ref.{f}.")
            state = state_from_arrays(
                box_arrays(NPZ_PRIMITIVES, start + "state."), device="cuda")
            cfg = PipelineConfig.from_dict(json.loads(str(box_arrays(
                NPZ_PRIMITIVES, start)["config_json"])))
            state, cfg = step_checked(state, params, cfg)
            check(_finite(state), f"{PRIM_SCENE} {name} frame {f}: "
                  "non-finite")
            pc = state.pair_count.cpu().numpy()
            dx = np.abs(state.bodies.poses.translation.cpu().numpy()
                        - refs["translation"]).max(-1)
            d_v = float(np.abs(state.bodies.vels.linear.cpu().numpy()
                               - refs["linear"]).max())
            near = float((dx <= TRANSLATION_LIMITS[f]).mean())
            print(f"{PRIM_SCENE} {name} reference frame {f}: pairs {pc[0]} "
                  f"(ref {refs['pair_count'][0]}) contacts {pc[1]} (ref "
                  f"{refs['pair_count'][1]}) support-mapped pairs {pc[7]} "
                  f"(ref {refs['pair_count'][7]}); bodies within "
                  f"{TRANSLATION_LIMITS[f]:.0e} m {near:.3f} (limit "
                  f"{PRIM_NEAR_SHARE}), max|dx| {dx.max():.3e} (limit "
                  f"{PRIM_FAR_ATOL:.0e}), max|dv| {d_v:.3e}")
            check(prim_counts_match(pc, refs["pair_count"]),
                  f"{PRIM_SCENE} {name} frame {f}: counts {pc[:8]} against "
                  f"{refs['pair_count'][:8]}")
            check(near >= PRIM_NEAR_SHARE and dx.max() <= PRIM_FAR_ATOL,
                  f"{PRIM_SCENE} {name} frame {f}: translations off")
            errs.append({"max_dx": float(dx.max()), "near_share": near,
                         "max_dv": d_v, "pairs": int(pc[0]),
                         "contacts": int(pc[1]), "pfm_pairs": int(pc[7])})
        out[name] = errs
    return out


def _ground_figures(state) -> dict:
    """The lowest dynamic centre, the bodies below the ground's top, and
    the share of the live contact points deeper than ``PRIM_DEEPEST``."""
    y = state.bodies.poses.translation[1:, 1]
    depth = contact_depths(state)
    return {"min_y": float(y.min()),
            "below_ground": int((y < PRIM_GROUND_Y).sum()),
            "deep_share": (float((depth > PRIM_DEEPEST).float().mean())
                           if depth.numel() else 0.0),
            "contact_points": int(depth.numel())}


@contextlib.contextmanager
def epa_demands():
    """A list that gains the EPA demand (``pfm_contact``'s unclamped count
    of core-overlapping pairs, a device scalar) of every support-mapped
    batch the narrow phase runs inside the block, the last the frame's
    kept run."""
    real = narrow_mod._pfm_call
    seen = []

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        seen.append(out[-1])
        return out

    narrow_mod._pfm_call = wrapped
    try:
        yield seen
    finally:
        narrow_mod._pfm_call = real


def primitives_physics_phase(params) -> dict:
    """``primitives3(40)`` from its first state under ``ladder`` and
    ``fused`` for as many frames as the 10k paths run: no dynamic centre
    below the ground's top and the deepest contact within
    ``PRIM_DEEPEST``, the fused envelope recorded beside the ladder's."""
    from wgmath_tpu_torch.scenes.builders import (
        primitive_configs,
        primitives3,
    )

    out = {}
    for name in ("ladder", "fused"):
        state = primitives3(40, device="cuda")
        cfg = PipelineConfig(**primitive_configs(
            int(state.bodies.poses.translation.shape[0]))[name])
        with epa_demands() as epa:
            for _ in range(PRIM_CHECK_FRAMES):
                state, cfg = step_checked(state, params, cfg)
        check(_finite(state), f"{PRIM_SCENE} {name}: non-finite")
        ke, pen = box_envelopes(state)
        m = dict(_ground_figures(state), kinetic_energy=ke,
                 max_penetration=pen,
                 epa_demand_max=int(torch.stack(epa).max()))
        print(f"{PRIM_SCENE} {name} after "
              f"{PRIM_CHECK_FRAMES} frames: lowest centre "
              f"y = {m['min_y']:.4f} (limit {PRIM_GROUND_Y}), contact points "
              f"deeper than {PRIM_DEEPEST} m {m['deep_share']:.4f} of "
              f"{m['contact_points']} (limit {PRIM_DEEP_SHARE}), deepest "
              f"{pen:.5f} m (recorded), KE {ke:.4f}, EPA demand at most "
              f"{m['epa_demand_max']} (cap 256)")
        check(m["below_ground"] == 0, f"{PRIM_SCENE} {name}: a body's centre "
              f"is below the ground (lowest y {m['min_y']:.4f})")
        check(m["deep_share"] <= PRIM_DEEP_SHARE, f"{PRIM_SCENE} {name}: "
              f"{m['deep_share']:.4f} of the contact points deeper than "
              f"{PRIM_DEEPEST} m")
        out[name] = m
    print(f"{PRIM_SCENE} fused envelope (recorded): KE "
          f"{out['fused']['kinetic_energy']:.4f} vs ladder "
          f"{out['ladder']['kinetic_energy']:.4f}, deepest "
          f"{out['fused']['max_penetration']:.5f} vs "
          f"{out['ladder']['max_penetration']:.5f}")
    return out


def primitives_phase(params) -> dict:
    """The primitive rain: ``primitives3(40)`` against the JAX frames and
    under the physical checks, then ``primitives3(2000)`` (10,000 bodies
    and the ground) from its first state under ``prim_ladder`` and
    ``prim_fused`` (``PRIM_WARM_FRAMES`` warm, ``PRIM_TIMED_FRAMES``
    timed): finite, at least ``PRIM_MIN_PFM_PAIRS`` support-mapped pairs
    in every timed frame; the EPA demand a frame against its cap, the
    lowest centre, the bodies below the ground and the envelopes recorded.
    Returns path name -> run, plus ``prim_jax_frames`` and
    ``prim_checks``."""
    from wgmath_tpu_torch.scenes.builders import (
        primitive_configs,
        primitives3,
    )

    runs = {"prim_jax_frames": primitives_reference_phase(params)}
    checks = {"primitives3_40": primitives_physics_phase(params)}
    state0 = primitives3(PRIM_PER_KIND, device="cpu")
    arrays = state_to_arrays(state0)
    n = int(state0.bodies.poses.translation.shape[0])
    for path, (name, expect) in PRIM_PATHS.items():
        cfg = PipelineConfig(**primitive_configs(n)[name])
        with epa_demands() as seen:
            run = runs[path] = run_path(
                path, arrays, cfg, params, None, expect,
                warm=PRIM_WARM_FRAMES, timed=PRIM_TIMED_FRAMES,
                envelopes=box_envelopes, record=lambda st: seen[-1])
        pfm_pairs = [int(c[7]) for c in run["counts"]]
        epa = [int(x) for x in run["recorded"]]
        m = dict(_ground_figures(run["end"][0]),
                 pfm_pairs_per_frame=(min(pfm_pairs), max(pfm_pairs)),
                 epa_demand_per_frame=(min(epa), max(epa)), epa_cap=256,
                 pfm_pair_capacity=run["end"][1].pfm_pair_capacity)
        run["metrics"].update(m)
        print(f"{path}: support-mapped pairs a timed frame {min(pfm_pairs)}"
              f"..{max(pfm_pairs)} (at least {PRIM_MIN_PFM_PAIRS}); EPA "
              f"demand {min(epa)}..{max(epa)} against its cap of 256; "
              f"lowest centre y = {m['min_y']:.3f}, {m['below_ground']} "
              f"bodies below the ground, contact points deeper than "
              f"{PRIM_DEEPEST} m {m['deep_share']:.4f} of "
              f"{m['contact_points']}, deepest "
              f"{run['metrics']['max_penetration']:.4f} m (recorded)")
        check(min(pfm_pairs) >= PRIM_MIN_PFM_PAIRS,
              f"{path}: {min(pfm_pairs)} support-mapped pairs in a timed "
              "frame")
        checks[path] = m
    runs["prim_checks"] = checks
    return runs


def primitives_kernel_checks(runs: dict, params, summaries: dict) -> None:
    """B2, B9, B11 and B10 carrying B12 at P = 4 on the first frame after
    the warm frames of ``primitives3(2000)`` (:func:`p4_kernel_checks`),
    under ``primitives10k_*`` in each kernel's summary."""
    p4_kernel_checks(runs, params, summaries, tuple(PRIM_PATHS),
                     "primitives10k")


def sat_share(run_once, frames: int = 3) -> dict:
    """The share of a frame's device time and host time spent inside
    ``cuboid_cuboid_manifold`` (:func:`range_share`)."""
    return range_share(run_once, narrow_mod, "cuboid_cuboid_manifold",
                       "sat_manifold", frames)


def pfm_share(run_once, frames: int = 3) -> dict:
    """The share of a frame's device time and host time spent in the
    support-mapped kernel (GJK, EPA and the clip; its CUDA graph's
    replays, ``narrow_phase._pfm_call``), with the same range timed by
    CUDA events (a graph's kernels may not be credited to the range)."""
    return range_share(run_once, narrow_mod, "_pfm_call", "pfm_manifold",
                       frames, events=True)


def range_share(run_once, module, attr: str, label: str, frames: int = 3,
                events: bool = False) -> dict:
    """The share of a frame's device time and host time spent inside
    ``module.attr``: a profiled window of ``frames`` calls of ``run_once``
    with that call wrapped in a ``record_function`` range (informational).
    ``events``: also the range's time by CUDA events a frame."""
    return range_shares(run_once, module, {label: attr}, frames,
                        events)[label]


def range_shares(run_once, module, ranges: dict, frames: int = 3,
                 events: bool = False) -> dict:
    """:func:`range_share` for several calls in one profiled window:
    ``ranges`` maps each range's label to the attribute of ``module`` it
    wraps, or to a (module, attribute) pair. Returns label -> figures."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    ranges = {label: (at if isinstance(at, tuple) else (module, at))
              for label, at in ranges.items()}
    real = {at: getattr(*at) for at in ranges.values()}
    marks = {label: [] for label in ranges}

    def wrapper(label, fn):
        def wrapped(*args, **kw):
            with record_function(label):
                if events:
                    start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(2))
                    start.record()
                    out = fn(*args, **kw)
                    end.record()
                    marks[label].append((start, end))
                    return out
                return fn(*args, **kw)
        return wrapped

    for label, at in ranges.items():
        setattr(*at, wrapper(label, real[at]))
    try:
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(frames):
                    run_once()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA
               and e.key not in ranges]
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in kernels)
    events_all = prof.events()
    # the whole window's figures, as profile_window gives them
    out = {"window": {
        "device_ms_per_step": total_us / 1e3 / frames,
        "profiled_wall_ms_per_step": wall_ms / frames,
        "device_busy_share": total_us / 1e3 / wall_ms,
        "kernels_per_step": sum(e.count for e in kernels
                                if getattr(e, "self_device_time_total",
                                           0.0)) / frames}}
    for label in ranges:
        # the host-side ranges only: the profiler also lays each range on
        # the device's timeline under the same name, a span whose time
        # includes the device's idle gaps
        spans = [e for e in events_all if e.name == label
                 and getattr(e, "device_type", None) == DeviceType.CPU]
        dev = sum(e.device_time_total for e in spans)
        host = sum(e.cpu_time_total for e in spans)
        out[label] = {"calls_per_step": len(spans) / frames,
                      "device_ms_per_step": dev / 1e3 / frames,
                      "device_share": dev / total_us if total_us else None,
                      "host_ms_per_step": host / 1e3 / frames,
                      "host_share_of_wall": host / 1e3 / wall_ms}
        if events:
            ev_ms = sum(a.elapsed_time(b) for a, b in marks[label]) / frames
            out[label].update(
                event_ms_per_step=ev_ms,
                event_share_of_device=(ev_ms / (total_us / 1e3 / frames)
                                       if total_us else None),
                event_share_of_wall=ev_ms * frames / wall_ms)
    return out


# the spin kernels that bracket a profiled window: ~1 us each
PROFILE_SENTINEL_CYCLES = 2000


def profile_window(run_once, frames: int = 3,
                   min_kernels: float = 0.0) -> dict:
    """Device time by kernel and host time by operator over a short
    steady window of ``frames`` calls of ``run_once`` (informational: the
    checked numbers come from the phases above). ``min_kernels``: the
    device kernels a call launches at the least (the port's launches the
    wrappers count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # A window in which the profiler reports no device event at all, or
    # fewer kernels a call than ``min_kernels``, is taken again, up to
    # three times, and the take with the most kernels is kept: on H100
    # hosts it dropped every kernel of a window of a few short kernels, and
    # in some processes one kernel record in every take (7 of 8, 39 of 40;
    # the kernels ran, their launches were counted and their result
    # checked); it never adds one. So each take is also bracketed by two
    # short spin kernels (``torch.cuda._sleep``), which are not counted,
    # and 2 ms of host idle at each end keep the kernels off its edges.
    best = None
    for _ in range(3):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the profiler's one-cycle notice
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                time.sleep(0.002)
                torch.cuda._sleep(PROFILE_SENTINEL_CYCLES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(frames):
                    run_once()
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
                torch.cuda._sleep(PROFILE_SENTINEL_CYCLES)
                torch.cuda.synchronize()
                time.sleep(0.002)
            averages = prof.key_averages()
        rows, host = [], []
        for e in averages:
            if "spin_kernel" in e.key:  # the brackets
                continue
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                # kernels only: an operator's row repeats its kernels' time
                dev_us = getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0.0))
                if dev_us:
                    rows.append((dev_us, e.count, e.key))
            elif e.key.startswith("aten::"):
                host.append((e.self_cpu_time_total, e.count, e.key))
        count = sum(r[1] for r in rows)
        if best is None or count > best[0]:
            best = count, rows, host, wall_ms
        if rows and count >= min_kernels * frames:
            break
    _, rows, host, wall_ms = best
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


# ---------------------------------------------------------------------------
# the solve modes: colouring in the solve, uniform and split windows, the
# Jacobi solver (the README's quick start, the testbed's --solver jacobi,
# the bench's split-window pit and its settle)
# ---------------------------------------------------------------------------

NPZ_SOLVE_MODES = os.path.join(ROOT, "artifacts", "solve_modes_jax.npz")
QUICK_LEVELS = 20  # SCENES["pyramid3"]: 2,870 cuboids and the ground
QUICK_FRAMES = 300  # the last QUICK_TIMED of them timed
QUICK_TIMED = 50
# the last JACOBI_TIMED of JACOBI_FRAMES timed: 60 / 50 until the meshes
# came, 30 / 20 until the scale-out phases came (the run's time limit)
JACOBI_FRAMES = 20
JACOBI_TIMED = 10
# the last SETTLE_TIMED of SETTLE_FRAMES timed (60 / 50 until the
# scale-out phases came)
SETTLE_FRAMES = 40
SETTLE_TIMED = 30
# the tail window of B2's split-plan check on the settled pit's first
# frame: its tail classes (colour 9: 1,342 rows) fit the bench's 1,536, so
# the check narrows the window to cut one
CHECK_TAIL_WINDOW = 1024
# path -> its kernel counters
SOLVE_PATHS = {"quickstart": ("gs_math_block",), "quickstart_jacobi": (),
               "pit_split": ("gs_math_block",),
               "pit_uniform": ("gs_math_block",),
               "pit_settle": ("gs_math_block",)}


def solve_modes_arrays(prefix: str) -> dict:
    """The entries of ``solve_modes_jax.npz`` under ``prefix``, the prefix
    cut off."""
    return box_arrays(NPZ_SOLVE_MODES, prefix)


def quickstart_config(jacobi: bool = False) -> tuple:
    """(params, config) of the README's quick start, or of the testbed's
    ``--solver jacobi`` on the same scene."""
    if jacobi:
        return SimParams.jacobi(), PipelineConfig(pair_capacity=16384,
                                                  use_jacobi=True)
    return SimParams(), PipelineConfig(pair_capacity=16384)


def solve_modes_reference_phase() -> dict:
    """``pyramid(20)`` from the JAX package's warmed state under the quick
    start and under Jacobi: three ``step_checked`` frames each, each from
    JAX's state before it, against JAX's (counts within
    ``COUNT_REL_LIMIT``, translations within ``TRANSLATION_LIMITS``)."""
    out = {}
    for mode in ("quick", "jacobi"):
        params = quickstart_config(mode == "jacobi")[0]
        errs = []
        for f in range(len(TRANSLATION_LIMITS)):
            if f == 0:
                state = state_from_arrays(solve_modes_arrays(
                    "card.warmed.state."), device="cuda")
                cfg_key = f"card.{mode}.config_json"
            else:
                state = state_from_arrays(solve_modes_arrays(
                    f"card.{mode}.ref.{f - 1}.state."), device="cuda")
                cfg_key = f"card.{mode}.ref.{f - 1}.config_json"
            with np.load(NPZ_SOLVE_MODES) as z:
                cfg = PipelineConfig.from_dict(json.loads(str(z[cfg_key])))
            refs = solve_modes_arrays(f"card.{mode}.ref.{f}.")
            state, cfg = step_checked(state, params, cfg)
            check(_finite(state), f"quickstart {mode} frame {f}: non-finite")
            pc = state.pair_count.cpu().numpy()
            ref_pc = refs["pair_count"]
            d_tr = float(np.abs(state.bodies.poses.translation.cpu().numpy()
                                - refs["translation"]).max())
            d_v = float(np.abs(state.bodies.vels.linear.cpu().numpy()
                               - refs["linear"]).max())
            rel = [abs(int(pc[i]) - int(ref_pc[i]))
                   / max(abs(int(ref_pc[i])), 1) for i in (0, 1)]
            print(f"quickstart {mode} reference frame {f} (from JAX's state "
                  f"before it): pairs {pc[0]} (ref {ref_pc[0]}) contacts "
                  f"{pc[1]} (ref {ref_pc[1]}) head class {pc[2]} (ref "
                  f"{ref_pc[2]}) max|dx| {d_tr:.3e} (limit "
                  f"{TRANSLATION_LIMITS[f]:.0e}) max|dv| {d_v:.3e}")
            check(max(rel) <= COUNT_REL_LIMIT,
                  f"quickstart {mode} frame {f}: pair/contact counts off by "
                  f"{max(rel):.2e} (limit {COUNT_REL_LIMIT})")
            check(d_tr <= TRANSLATION_LIMITS[f],
                  f"quickstart {mode} frame {f}: translations off by "
                  f"{d_tr:.3e}")
            errs.append({"max_dx": d_tr, "max_dv": d_v, "pairs": int(pc[0]),
                         "contacts": int(pc[1])})
        out[mode] = errs
    return out


def quickstart_path(params, config, name: str, frames: int, timed: int,
                    expect: tuple) -> dict:
    """The README's loop with the port's names, on the card: the
    ``pyramid3`` scene stepped ``frames`` times by ``step_checked``
    (through :func:`run_path`: the last ``timed`` frames timed); then the
    physical checks: finite poses, no box rising more than ``RISE_TOL``
    and, for the quick start, level 0 within ``LEVEL0_TOL`` of y = 0.5
    (JAX's own 300 frames hold to it: ``card.physics.*``)."""
    from wgmath_tpu_torch.scenes.builders import SCENES

    state = SCENES["pyramid3"](device="cuda")
    y0 = state.bodies.poses.translation[:, 1].clone()
    run = run_path(name, state, config, params, None, expect,
                   warm=frames - timed, timed=timed, envelopes=box_envelopes)
    end, cfg = run["end"]
    m = _physics(end.bodies.poses.translation, y0, QUICK_LEVELS)
    run["metrics"].update(m, regrown_config={
        k: v for k, v in dataclasses.asdict(cfg).items()
        if v != getattr(config, k)})
    _print_physics(f"{name} after {frames} frames", m)
    print(f"{name}: regrown config {run['metrics']['regrown_config']}")
    check(m["max_rise"] <= RISE_TOL, f"{name}: a box rose "
          f"{m['max_rise']:.3e} m")
    if not expect:
        print(f"{name}: no port kernel launched on this path (the Jacobi "
              "solver is plain PyTorch, as the JAX package runs it in XLA)")
    run["params"] = params
    return run


def pit_mode_config(cfg_ladder: PipelineConfig, tail: bool):
    """The bench's ``steady_base`` (``bench.py:455-460``) from the settled
    checkpoint's configuration: no window ladder, no chain, no in-kernel
    rhs, no pair slots: cached pair colours under ``gs_cmax``, split
    windows (``gs_tail_window`` past ``gs_split``), or uniform ones
    (``tail`` False: ``gs_tail_window`` 0)."""
    cfg = dataclasses.replace(cfg_ladder, gs_windows=(), gs_chained=False,
                              gs_rhs_in_rung=False, gs_pair_slots=False)
    return cfg if tail else dataclasses.replace(cfg, gs_tail_window=0)


@contextlib.contextmanager
def window_records():
    """A list that gains (class counts, windows) of every windowless plan
    the solve builds inside the block (``solver.uniform_windows``)."""
    real = solver.uniform_windows
    seen = []

    def wrapped(counts, **kw):
        out = real(counts, **kw)
        seen.append((list(counts), out))
        return out

    solver.uniform_windows = wrapped
    try:
        yield seen
    finally:
        solver.uniform_windows = real


def pit_mode_gates(runs: dict, params) -> dict:
    """``pit_split`` and ``pit_uniform`` against the ladder: the short gate
    (three steps from the candidate's warmed state) and the envelopes."""
    out = {}
    lad = runs["ladder"]
    for name in ("pit_split", "pit_uniform"):
        st, cfg = runs[name]["warmed"]
        ends = []
        for c in (cfg, lad["warmed"][1]):
            s = st
            for _ in range(SHORT_GATE_STEPS):
                s = step(s, params, c)
            ends.append(s.bodies.poses.translation)
        err = _max_dp(*ends)
        m, m_l = runs[name]["metrics"], lad["metrics"]
        ke, pen = m["kinetic_energy"], m["max_penetration"]
        ke_l, pen_l = m_l["kinetic_energy"], m_l["max_penetration"]
        out[name] = {"vs_ladder_3_steps": err, "ke": ke, "pen": pen,
                     "ladder_ke": ke_l, "ladder_pen": pen_l}
        print(f"gate {name} vs ladder over {SHORT_GATE_STEPS} steps from one "
              f"warmed state: max|dp| {err:.3e} (limit {SHORT_GATE_LIMIT}); "
              f"envelopes after {WARM_FRAMES + TIMED_FRAMES} frames: KE "
              f"{ke:.4f} vs ladder {ke_l:.4f}, max penetration {pen:.5f} vs "
              f"{pen_l:.5f}")
        check(np.isfinite(err) and err <= SHORT_GATE_LIMIT,
              f"{name} diverges from the ladder by {err:.3e} m over "
              f"{SHORT_GATE_STEPS} steps")
        check(pen <= pen_l + ENVELOPE_PEN_SLACK
              and ke <= ENVELOPE_KE_FACTOR * ke_l + ENVELOPE_KE_SLACK,
              f"{name} envelope exceeds the ladder's (drift)")
    return out


def pit_settle_path(params) -> dict:
    """``ball_pit(10_000)`` from its lattice under the bench's settle
    configuration (``bench.py:416-430``: ``bp_slack`` 0, so the solve
    colours the contacts every frame, ``gs_cmax`` 4096, split windows past
    ``gs_tail_window`` 1536): finite, and the last frame within every
    capacity (each regrow converged)."""
    from wgmath_tpu_torch.pipeline import auto_manifold_points
    from wgmath_tpu_torch.scenes.builders import ball_pit

    state = ball_pit(10_000, device="cpu")
    cfg = PipelineConfig(
        pair_capacity=49152, contact_capacity=32768, max_colors=24,
        broad_phase_block=512, gs_cmax=4096, bp_slack=0.0,
        bc_pair_capacity=4096, gs_tail_window=1536,
        manifold_points=auto_manifold_points(
            state.shapes, 3, dynamic=state.bodies.is_dynamic()))
    run = run_path("pit_settle", state_to_arrays(state), cfg, params, None,
                   SOLVE_PATHS["pit_settle"],
                   warm=SETTLE_FRAMES - SETTLE_TIMED, timed=SETTLE_TIMED,
                   envelopes=box_envelopes)
    end, cfg = run["end"]
    pc = [int(x) for x in end.pair_count.cpu()]
    within = (0 <= pc[0] <= cfg.pair_capacity
              and pc[1] <= cfg.contact_capacity and pc[2] <= cfg.gs_cmax
              and pc[4] <= cfg.gs_tail_window)
    run["metrics"]["last_counts"] = pc[:5]
    print(f"pit_settle after {SETTLE_FRAMES} frames: counts {pc[:5]} under "
          f"pair_capacity {cfg.pair_capacity}, contact_capacity "
          f"{cfg.contact_capacity}, gs_cmax {cfg.gs_cmax}, gs_tail_window "
          f"{cfg.gs_tail_window}")
    check(within, f"pit_settle: the last frame overflowed {pc[:5]}")
    return run


def solve_modes_phase(params, runs: dict) -> dict:
    """The solve modes: the quick start's JAX frames, ``quickstart`` (300
    frames, the physical checks), ``quickstart_jacobi`` (20 frames),
    ``pit_split`` and ``pit_uniform`` from the settled checkpoint (the
    bench's warm and timed frames, the short gate and the envelopes against
    ``runs["ladder"]``), and ``pit_settle``. Returns path name -> run, plus
    ``solve_jax_frames`` and ``solve_checks``."""
    out = {"solve_jax_frames": solve_modes_reference_phase()}
    checks = {}
    with np.load(NPZ_SOLVE_MODES) as z:
        jax_phys = {k: float(z[f"card.physics.{k}"])
                    for k in ("level0_max_off", "max_rise")}
    out["quickstart"] = quickstart_path(
        *quickstart_config(), "quickstart", QUICK_FRAMES, QUICK_TIMED,
        SOLVE_PATHS["quickstart"])
    m = out["quickstart"]["metrics"]
    print(f"quickstart: JAX's own {QUICK_FRAMES} frames: level 0 within "
          f"{jax_phys['level0_max_off']:.3e} m, highest rise "
          f"{jax_phys['max_rise']:.3e} m")
    check(m["level0_max_off"] <= LEVEL0_TOL,
          f"quickstart: level 0 left the ground by {m['level0_max_off']:.3e}")
    checks["quickstart"] = dict(
        level0_max_off=m["level0_max_off"], max_rise=m["max_rise"],
        jax=jax_phys)
    out["quickstart_jacobi"] = quickstart_path(
        *quickstart_config(True), "quickstart_jacobi", JACOBI_FRAMES,
        JACOBI_TIMED, SOLVE_PATHS["quickstart_jacobi"])
    m = out["quickstart_jacobi"]["metrics"]
    checks["quickstart_jacobi"] = dict(level0_max_off=m["level0_max_off"],
                                       max_rise=m["max_rise"])
    z = dict(np.load(NPZ))
    cfg_lad = PipelineConfig.from_dict(json.loads(str(np.load(NPZ_LADDER)[
        "config_json"])))
    for name, tail in (("pit_split", True), ("pit_uniform", False)):
        out[name] = run_path(name, z, pit_mode_config(cfg_lad, tail), params,
                             None, SOLVE_PATHS[name])
    checks["pit_gates"] = pit_mode_gates({**runs, **out}, params)
    out["pit_settle"] = pit_settle_path(params)
    out["solve_checks"] = checks
    return out


def solve_modes_kernel_checks(runs: dict, params, summaries: dict) -> None:
    """B2 on the windowless plans: the two sweeps of substep 1 of the
    quick start's first frame after its warm frames (uniform windows, P =
    4) and of the settled pit's first frame under the split windows with
    the tail window at ``CHECK_TAIL_WINDOW`` (a tail class past it: a
    truncated rung), each one launch
    against the same kernel launched rung by rung and its repeats (bit for
    bit) and against the plain sweep; under ``quickstart_*`` and
    ``pit_split_*`` in B2's summary."""
    state, cfg = runs["quickstart"]["warmed"]
    cases = {}
    with window_records() as seen:
        calls = record_sweeps(lambda: step_checked(state, params, cfg), 2)
    check(bool(seen) and all(c.kw["p_max"] == 4 for c in calls),
          "quickstart: the recorded sweeps are not windowless 4-point ones")
    cases["quickstart"] = calls
    z = dict(np.load(NPZ))
    cfg_lad = PipelineConfig.from_dict(json.loads(str(np.load(NPZ_LADDER)[
        "config_json"])))
    split_cfg = dataclasses.replace(pit_mode_config(cfg_lad, True),
                                    gs_tail_window=CHECK_TAIL_WINDOW)
    with window_records() as seen:
        calls = record_sweeps(lambda: step_checked(
            state_from_arrays(z, device="cuda"), params, split_cfg), 2)
    counts, windows = seen[0]
    cut = [c for c in range(1, len(windows) + 1)
           if counts[c] > windows[c - 1] and c > split_cfg.gs_split]
    print(f"pit_split first frame: class counts {counts[1:]}, rows swept "
          f"{list(windows)}; truncated tail colours {cut}")
    check(bool(cut), "pit_split: no tail class past gs_tail_window on the "
          "checkpoint's first frame")
    cases["pit_split"] = calls
    row = summaries["gs_math_block"]
    for label, calls in cases.items():
        res = [_sweep_case("gs_math_block", f"{label} sweep {k + 1}", call,
                           True) for k, call in enumerate(calls)]
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [r["max_abs_err"] for r in res])
        nbytes = sum(r["bytes"] for r in res)
        flops = sum(r["flops"] for r in res)
        row.update({f"{label}_ms": sum(r["ms"] for r in res),
                    f"{label}_rungs_ms": sum(r["rungs_ms"] for r in res),
                    f"{label}_plain_ms": sum(r["plain_ms"] for r in res),
                    f"{label}_bound_ms": bound_ms(nbytes, flops)[0],
                    f"{label}_rows": res[0]["rows"],
                    f"{label}_rungs": res[0]["rungs"]})


def color_share(run_once, frames: int = 3) -> dict:
    """The share of a frame's device and host time spent colouring the
    contacts in the solve (``solver.color_constraints``,
    :func:`range_share`), with the range's time by CUDA events."""
    return range_share(run_once, solver, "color_constraints",
                       "color_constraints", frames, events=True)


# ---------------------------------------------------------------------------
# impulse joints (3D) in every contact solve: the JAX frames, the physical
# checks of tests/test_joints.py, and the 10,000-ball jointed net
# ---------------------------------------------------------------------------

NPZ_JOINTS = os.path.join(ROOT, "artifacts", "joints_jax.npz")
# the small cases of joints_jax.npz: the four chains, the drape scene of
# tests/test_joints.py under three configurations, ball_net3(16, 16)
JOINT_SMALL_CASES = ("joint_ball3", "joint_revolute3", "joint_fixed3",
                     "joint_prismatic3", "drape_ladder", "drape_chained_rr",
                     "drape_chained_ps", "net16")
# the 10k net: JAX's state after the drape (case "net100") and one frame
# from it under each steady configuration
JOINT_NET_CASES = ("net100_ladder", "net100_chained_ps")
# each frame from JAX's state before it: counts exactly, translations
# within 1e-5 m on the small scenes and 1.02e-4 m on the 10k net (a pure
# reordering of the GS sums moves the 10k pit's by ~1e-4 after a frame:
# TRANSLATION_LIMITS)
JOINT_SMALL_TR_LIMIT = 1e-5
JOINT_NET_TR_LIMIT = 1.02e-4
# the 10k net from JAX's drape state: warm and timed frames (together the
# export's NET_RUN, whose joint stretch after each frame is stored)
NET_WARM_FRAMES = 5
NET_TIMED_FRAMES = 8  # 15 until the scale-out phases (the time limit)
# the other solve modes on the net: frames run from JAX's drape state, to
# finite poses above the ground
NET_MODE_FRAMES = 4
NET_BALL_RADIUS = 0.25
# the largest joint stretch at most twice JAX's at the same frame plus 1 mm,
# and within 1 mm of JAX's
STRETCH_FACTOR, STRETCH_SLACK = 2.0, 1e-3
STRETCH_AGREE = 1e-3
# path -> (case of joints_jax.npz whose configuration it runs from the
# drape state, the kernel counters it moves)
# (net_fused: the ladder's configuration under the fused solver, B9 and
# B10 launched alone; the stretch gate against JAX's ladder run)
FUSED_JOINT_KERNELS = ("build_fused", "fused_sweep")
JOINT_PATHS = {"net_ladder": ("net100_ladder", ("gs_math_block",)),
               "net_chained_ps": ("net100_chained_ps", ("gs_math_rhs",)),
               "net_fused": ("net100_ladder", FUSED_JOINT_KERNELS)}
# net_fused's residue rung, as the pit's fused configuration follows from
# its ladder (bench.py:540-541)
NET_FUSED_RUNG0 = 256
NET_MODE_PATHS = {"net_chained": ("gs_math_block",),
                  "net_chained_rr": ("gs_math_rhs",),
                  "net_jacobi": (), "net_default": ("gs_math_block",)}
# tests/test_joints.py's configuration for its two-ball worlds and chains
JOINT_TEST_CFG = dict(pair_capacity=64, max_colors=8, broad_phase_block=64)


@functools.lru_cache(maxsize=None)
def _stored(npz: str) -> dict:
    """Every array of a stored-frames file, read once (read only)."""
    return load_arrays(npz)


def joints_case_state(case: str, prefix: str, device="cuda",
                      npz: str = NPZ_JOINTS):
    """The state ``<case>.<prefix>.*`` of ``joints_jax.npz`` (or ``npz``)
    with the case's joints."""
    z = _stored(npz)
    d = {k[len(case) + 1:]: v for k, v in z.items()
         if k.startswith(f"{case}.joints.")}
    p = f"{case}.{prefix}."
    d.update({k[len(p):]: v for k, v in z.items() if k.startswith(p)})
    return state_from_arrays(d, device=device)


def joints_case_value(key: str, npz: str = NPZ_JOINTS):
    return _stored(npz)[key]


def joints_case_config(key: str, npz: str = NPZ_JOINTS) -> PipelineConfig:
    return PipelineConfig.from_dict(json.loads(str(joints_case_value(
        key, npz))))


def joints_case_params(case: str, npz: str = NPZ_JOINTS) -> SimParams:
    kw = json.loads(str(joints_case_value(f"{case}.params_json", npz)))
    kw["gravity"] = tuple(kw["gravity"])
    return SimParams(**kw)


def joint_stretch(state) -> float:
    """The largest distance between a joint's two world anchors."""
    j, p = state.joints, state.bodies.poses
    a = sim_ops.mul_pt(p.take(j.body_a), j.local_frame_a.translation)
    b = sim_ops.mul_pt(p.take(j.body_b), j.local_frame_b.translation)
    return float(torch.linalg.norm(a - b, dim=-1).max())


def net_envelopes(state) -> tuple[float, float]:
    """Kinetic-energy proxy (sum |v|^2; the net's balls share one mass)
    and the deepest ball centre below a ball's radius over the ground."""
    vel = state.bodies.vels.linear
    low = float(state.bodies.poses.translation[2:, 1].min())
    return float((vel * vel).sum()), max(NET_BALL_RADIUS - low, 0.0)


def joints_reference_phase(cases=JOINT_SMALL_CASES + JOINT_NET_CASES,
                           npz: str = NPZ_JOINTS) -> dict:
    """Every case of ``joints_jax.npz`` (or ``cases`` of ``npz``) on the
    card against JAX's frames: the small ones three ``step_checked``
    frames, each from JAX's state before it (translations within
    ``JOINT_SMALL_TR_LIMIT``), the 10k net one frame from JAX's drape
    state under each steady configuration (within ``JOINT_NET_TR_LIMIT``);
    counts exactly."""
    out = {}
    for case in cases:
        net = case in JOINT_NET_CASES
        params = joints_case_params("net100" if net else case, npz)
        limit = JOINT_NET_TR_LIMIT if net else JOINT_SMALL_TR_LIMIT
        errs = []
        for f in range(1 if net else 3):
            prefix, cfg_key = (("warmed", f"{case}.config_json") if f == 0
                               else (f"ref.{f - 1}.state",
                                     f"{case}.ref.{f - 1}.config_json"))
            state = (joints_case_state("net100", "drape") if net
                     else joints_case_state(case, prefix, npz=npz))
            state, _ = step_checked(state, params,
                                    joints_case_config(cfg_key, npz))
            check(_finite(state), f"joints {case} frame {f}: non-finite")
            ref = f"{case}.ref.{f}."
            pc = state.pair_count.cpu().numpy()
            ref_pc = joints_case_value(ref + "pair_count", npz)
            d_tr = float(np.abs(state.bodies.poses.translation.cpu().numpy()
                                - joints_case_value(ref + "translation", npz))
                         .max())
            # the 10k net's reference keeps translations only (size)
            d_v = (None if net else float(np.abs(
                state.bodies.vels.linear.cpu().numpy()
                - joints_case_value(ref + "linear", npz)).max()))
            print(f"joints {case} frame {f} (from JAX's state before it): "
                  f"pair_count {pc[:5].tolist()} (ref {ref_pc[:5].tolist()}"
                  f") max|dx| {d_tr:.3e} (limit {limit:.2e}) max|dv| "
                  f"{'not stored' if net else f'{d_v:.3e}'}")
            check(np.array_equal(pc, ref_pc), f"joints {case} frame {f}: "
                  f"counts {pc.tolist()} against JAX's {ref_pc.tolist()}")
            check(d_tr <= limit, f"joints {case} frame {f}: translations "
                  f"off by {d_tr:.3e}")
            errs.append({"max_dx": d_tr, "max_dv": d_v,
                         "contacts": int(pc[1])})
        out[case] = errs
    return out


def two_ball_world(pos_b, joints_fn, *args, **kw):
    """tests/test_joints.py's world: a static ball at the origin and a
    dynamic one at ``pos_b`` (radius 0.2), joined by ``joints_fn``."""
    from wgmath_tpu_torch.pipeline import new_state

    dev = torch.device("cuda")
    r = torch.tensor([0.2, 0.2], device=dev)
    trans = torch.tensor([[0.0, 0.0, 0.0], list(pos_b)], device=dev)
    dyn = np.asarray([False, True])
    bodies = body_ops.Bodies(
        Sim(quat.identity((2,), device=dev), trans,
            torch.ones(2, device=dev)),
        body_ops.Velocity.zero(2, device=dev),
        body_ops.ball_local_mprops(r, dynamic=torch.from_numpy(dyn).to(dev)))
    joints = joints_fn([0], [1], *args, dynamic_mask=dyn, device=dev, **kw)
    return new_state(bodies, shp.ShapeSet.balls(r), joints)


def _frames(state, params, n: int, each=None):
    cfg = PipelineConfig(**JOINT_TEST_CFG)
    for _ in range(n):
        state, cfg = step_checked(state, params, cfg)
        if each is not None:
            each(state)
    return state


def joints_physics_phase() -> dict:
    """``tests/test_joints.py``'s behaviour checks on the card, with its
    frame counts and limits: the spherical pendulum keeps its anchor and
    swings, the fixed joint holds its pose, the revolute joint stays in
    its plane at its pivot distance, its motor reaches its speed, the
    swing cone holds, and the drape's chained configurations stay with
    the ladder."""
    from wgmath_tpu_torch.dynamics import joint as joint_ops

    params = SimParams()
    out = {}
    st = _frames(two_ball_world([1.0, 0.0, 0.0], joint_ops.spherical_joints,
                                [[0.0, 0.0, 0.0]], [[-1.0, 0.0, 0.0]]),
                 params, 90)
    p = st.bodies.poses
    err = float(torch.linalg.norm(sim_ops.mul_pt(
        p.take(slice(1, 2)), torch.tensor([[-1.0, 0.0, 0.0]],
                                          device="cuda"))))
    bob_y = float(p.translation[1, 1])
    out["spherical"] = {"anchor_err": err, "bob_y": bob_y}
    check(err < 0.02 and bob_y < -0.3, f"spherical pendulum: anchor error "
          f"{err:.3e} (limit 0.02), bob at y {bob_y:.3f} (limit -0.3)")

    st = _frames(two_ball_world([0.7, 0.0, 0.0], joint_ops.fixed_joints,
                                [[0.7, 0.0, 0.0]], [[0.0, 0.0, 0.0]]),
                 params, 90)
    off = float((st.bodies.poses.translation[1].cpu()
                 - torch.tensor([0.7, 0.0, 0.0])).abs().max())
    w_off = abs(abs(float(st.bodies.poses.rotation[1, 3])) - 1.0)
    out["fixed"] = {"pos_off": off, "rot_w_off": w_off}
    check(off <= 0.02 and w_off < 1e-2, f"fixed joint: moved {off:.3e} "
          f"(limit 0.02), |w| off 1 by {w_off:.3e} (limit 1e-2)")

    low = [0.0]
    st = _frames(two_ball_world([1.0, 0.0, 0.0], joint_ops.revolute_joints,
                                [[0.0, 0.0, 0.0]], [[-1.0, 0.0, 0.0]],
                                axes=[[0.0, 0.0, 1.0]]), params, 60,
                 lambda s: low.__setitem__(0, min(
                     low[0], float(s.bodies.poses.translation[1, 1]))))
    t = st.bodies.poses.translation[1].cpu().numpy()
    out["revolute"] = {"z": float(t[2]), "pivot_off": float(abs(
        np.linalg.norm(t) - 1.0)), "min_y": low[0]}
    check(abs(t[2]) < 0.01 and out["revolute"]["pivot_off"] < 0.02
          and low[0] < -0.7, f"revolute joint: {out['revolute']} (limits: "
          "|z| 0.01, pivot 0.02, lowest y below -0.7)")

    still = SimParams(gravity=(0.0, 0.0, 0.0))
    st = _frames(two_ball_world([1.0, 0.0, 0.0], joint_ops.revolute_joints,
                                [[0.0, 0.0, 0.0]], [[-1.0, 0.0, 0.0]],
                                axes=[[0.0, 0.0, 1.0]], motor_vel=2.0,
                                motor_damping=300.0), still, 90)
    w = st.bodies.vels.angular[1].cpu().numpy()
    out["motor"] = {"w": w.tolist()}
    check(abs(w[2] - 2.0) < 0.2 and abs(w[0]) < 0.05 and abs(w[1]) < 0.05,
          f"revolute motor: angular velocity {w} (target 2 rad/s about z, "
          "within 0.2; off-axis within 0.05)")

    half = float(np.deg2rad(35.0))
    swing = [0.0]

    def track(s):
        q = s.bodies.poses.translation[1].cpu().numpy()
        d = q / max(np.linalg.norm(q), 1e-9)
        swing[0] = max(swing[0], float(np.arccos(np.clip(d[0], -1, 1))))

    _frames(two_ball_world([1.0, 0.0, 0.0], joint_ops.spherical_joints,
                           [[0.0, 0.0, 0.0]], [[-1.0, 0.0, 0.0]],
                           swing_limit=half), params, 120, track)
    out["swing_cone_deg"] = float(np.rad2deg(swing[0]))
    check(np.deg2rad(25.0) < swing[0] < half + np.deg2rad(8.0),
          f"swing cone: largest swing {np.rad2deg(swing[0]):.2f} degrees "
          "(limits: above 25, below 35 + 8)")

    out["drape"] = drape_against_ladder(params)
    print(f"joint physical checks on the card: {out}")
    return out


def drape_scene():
    """``tests/test_joints.py``'s drape scene on the card: a ground slab,
    then a five-ball chain whose first ball is static 1.2 m up, linked by
    spherical joints."""
    from wgmath_tpu_torch.dynamics.joint import spherical_joints
    from wgmath_tpu_torch.pipeline import new_state
    from wgmath_tpu_torch.scenes.builders import _merge_mprops

    dev = torch.device("cuda")
    n_links, r = 4, 0.2
    n = n_links + 2
    slab = torch.tensor([[10.0, 0.5, 10.0]], device=dev)
    radii = torch.full((n_links + 1,), r, device=dev)
    trans = torch.zeros((n, 3), device=dev)
    trans[0, 1], trans[1, 1] = -0.5, 1.2
    for i in range(n_links):
        trans[2 + i, 0], trans[2 + i, 1] = (i + 1) * 0.5, 1.2
    dynamic = np.ones(n, bool)
    dynamic[:2] = False
    mp = _merge_mprops(
        body_ops.cuboid_local_mprops(slab, dynamic=torch.zeros(
            1, dtype=torch.bool, device=dev)),
        body_ops.ball_local_mprops(radii, dynamic=torch.from_numpy(
            dynamic[1:]).to(dev)))
    bodies = body_ops.Bodies(
        Sim(quat.identity((n,), device=dev), trans, torch.ones(n, device=dev)),
        body_ops.Velocity.zero(n, device=dev), mp)
    joints = spherical_joints(
        list(range(1, n_links + 1)), list(range(2, n_links + 2)),
        [[0.25, 0.0, 0.0]] * n_links, [[-0.25, 0.0, 0.0]] * n_links,
        dynamic_mask=dynamic, device=dev)
    shapes = shp.ShapeSet.concat(shp.ShapeSet.cuboids(slab),
                                 shp.ShapeSet.balls(radii))
    return new_state(bodies, shapes, joints)


def drape_against_ladder(params) -> dict:
    """The drape scene from its first state under the three drape
    configurations of ``joints_jax.npz`` (``ladder``, ``chained_rr``,
    ``chained_ps``) for 40 frames (``step``, no warmstart on the first):
    the chained ones within 1e-4 m of the ladder, the free end resting on
    the ground (y between 0.1 and 0.9)."""
    ends = {}
    for mode in ("ladder", "chained_rr", "chained_ps"):
        st = drape_scene()
        cfg = joints_case_config(f"drape_{mode}.config_json")
        for f in range(40):
            st = step(st, params, cfg, warmstart=f > 0)
        ends[mode] = st.bodies.poses.translation
        check(_finite(st), f"drape {mode}: non-finite")
    tip = float(ends["ladder"][-1, 1])
    errs = {m: float((ends[m] - ends["ladder"]).abs().max())
            for m in ("chained_rr", "chained_ps")}
    check(0.1 < tip < 0.9, f"drape: the free end at y {tip:.3f} did not "
          "come to rest on the ground (0.1..0.9)")
    check(max(errs.values()) < 1e-4, f"drape: the chained configurations "
          f"left the ladder by {errs} (limit 1e-4)")
    return {"tip_y": tip, "vs_ladder": errs}


def _net_gates(name: str, run: dict, jax_stretch,
               agree_at_warm: bool = False) -> dict:
    """The 10k net's gates on a run from JAX's drape state: finite poses
    (``run_path``), no ball centre below the ground, and (with
    ``jax_stretch``, JAX's largest stretch after each frame from the same
    state) the largest joint stretch at most ``STRETCH_FACTOR`` times
    JAX's at the same frame plus ``STRETCH_SLACK``, and within
    ``STRETCH_AGREE`` of JAX's. ``agree_at_warm``: the agreement is held
    after the warm frames instead (another solver than JAX's run, whose
    landing parts from it chaotically later), the stretch at the end
    recorded beside JAX's."""
    end = run["end"][0]
    warm = len(run["trail"])
    frames = warm + run["metrics"]["frames_timed"]
    low = float(end.bodies.poses.translation[2:, 1].min())
    stretch = joint_stretch(end)
    m = {"frames": frames, "lowest_centre_y": low, "stretch": stretch}
    line = (f"{name} after {frames} frames from JAX's drape state: lowest "
            f"centre y {low:.4f}, largest joint stretch {stretch:.3e} m")
    check(low >= 0.0, f"{name}: a ball centre sank below the ground "
          f"(y {low:.4f})")
    if jax_stretch is not None:
        ref = float(jax_stretch[frames - 1])
        limit = STRETCH_FACTOR * ref + STRETCH_SLACK
        m.update(jax_stretch=ref, stretch_limit=limit)
        line += f" (JAX's {ref:.3e}, limit {limit:.3e})"
        check(stretch <= limit, f"{name}: joint stretch {stretch:.3e} m "
              f"past {limit:.3e}")
        at, s_at, r_at = frames, stretch, ref
        if agree_at_warm:
            at, s_at = warm, joint_stretch(run["warmed"][0])
            r_at = float(jax_stretch[warm - 1])
            m.update(warm_stretch=s_at, warm_jax_stretch=r_at)
            line += (f"; after {warm} frames {s_at:.3e} m (JAX's "
                     f"{r_at:.3e})")
        check(abs(s_at - r_at) <= STRETCH_AGREE, f"{name}: joint stretch "
              f"{s_at:.3e} m after {at} frames more than "
              f"{STRETCH_AGREE:.0e} m from JAX's {r_at:.3e}")
    print(line)
    run["metrics"]["net"] = m
    return m


def net_mode_configs() -> dict:
    """The solve modes run on the 10k net besides the timed two: the
    ladder's steady configuration chained and chained with the rhs in the
    rung, and ``scripts/run_jointed10k.py``'s drape configuration (the
    windowless default: colouring in the solve, uniform windows) as it is
    and under the Jacobi solver. Name -> (config, params)."""
    lad = joints_case_config("net100_ladder.config_json")
    drape = joints_case_config("net100.drape_config_json")
    return {"net_chained": (dataclasses.replace(lad, gs_chained=True),
                            SimParams()),
            "net_chained_rr": (dataclasses.replace(
                lad, gs_chained=True, gs_rhs_in_rung=True), SimParams()),
            "net_jacobi": (dataclasses.replace(drape, use_jacobi=True),
                           SimParams.jacobi()),
            "net_default": (drape, SimParams())}


def joints_phase() -> dict:
    """The joints: every JAX case of ``joints_jax.npz`` frame by frame and
    the small jointed cases under the fused solver of
    ``lbvh_fused_joints_jax.npz`` likewise, the physical checks, then
    ``ball_net3(100, 100)`` from JAX's drape state: ``net_ladder``,
    ``net_chained_ps`` and ``net_fused`` (``NET_WARM_FRAMES`` warm,
    ``NET_TIMED_FRAMES`` timed, the stretch gate against JAX's;
    ``net_fused`` also against the ladder, :func:`net_fused_gates`), and
    ``NET_MODE_FRAMES`` frames of each of ``net_mode_configs``. Returns
    path name -> run, plus ``joint_jax_frames``,
    ``fused_joint_jax_frames`` and ``joint_checks``."""
    out = {"joint_jax_frames": joints_reference_phase(),
           "fused_joint_jax_frames": joints_reference_phase(
               FUSED_JOINT_CASES, NPZ_LBVH_FUSED)}
    checks = {"physics": joints_physics_phase()}
    for path, (case, expect) in JOINT_PATHS.items():
        cfg = joints_case_config(f"{case}.config_json")
        if path == "net_fused":
            cfg = dataclasses.replace(cfg, gs_fused=True,
                                      gs_rung0=NET_FUSED_RUNG0)
        run = run_path(path, joints_case_state("net100", "drape"), cfg,
                       joints_case_params("net100"), None, expect,
                       warm=NET_WARM_FRAMES, timed=NET_TIMED_FRAMES,
                       envelopes=net_envelopes)
        checks[path] = _net_gates(path, run,
                                  joints_case_value(f"{case}.stretch"),
                                  agree_at_warm=path == "net_fused")
        out[path] = run
    checks["net_fused_vs_ladder"] = net_fused_gates(
        out, joints_case_params("net100"))
    for path, (cfg, params) in net_mode_configs().items():
        run = run_path(path, joints_case_state("net100", "drape"),
                       cfg, params, None, NET_MODE_PATHS[path],
                       warm=NET_MODE_FRAMES // 2,
                       timed=NET_MODE_FRAMES - NET_MODE_FRAMES // 2,
                       envelopes=net_envelopes)
        run["params"] = params
        checks[path] = _net_gates(path, run, None)
        out[path] = run
    out["joint_checks"] = checks
    return out


def joints_kernel_checks(runs: dict, params, summaries: dict) -> None:
    """B1 and B2 on the 10k net's own plans: the two sweeps of substep 1
    of the first frame after the warm frames of ``net_chained_ps`` (B1)
    and ``net_ladder`` (B2), each one launch against the same kernel
    launched rung by rung and its repeats (bit for bit) and against the
    plain sweep; under ``net10k_*`` in each kernel's summary. Then B10 on
    ``net_fused``'s plan (:func:`net_fused_kernel_checks`)."""
    for path, kernel in (("net_chained_ps", "gs_math_rhs"),
                         ("net_ladder", "gs_math_block")):
        state, cfg = runs[path]["warmed"]
        calls = record_sweeps(lambda: step_checked(state, params, cfg), 2)
        check(len(calls) == 2, f"{path}: fewer than two sweeps recorded")
        res = [_sweep_case(kernel, f"net10k sweep {k + 1}", call, True)
               for k, call in enumerate(calls)]
        row = summaries[kernel]
        row["max_abs_err"] = max([row["max_abs_err"]]
                                 + [r["max_abs_err"] for r in res])
        nbytes = sum(r["bytes"] for r in res)
        flops = sum(r["flops"] for r in res)
        row.update({"net10k_ms": sum(r["ms"] for r in res),
                    "net10k_rungs_ms": sum(r["rungs_ms"] for r in res),
                    "net10k_plain_ms": sum(r["plain_ms"] for r in res),
                    "net10k_bound_ms": bound_ms(nbytes, flops)[0],
                    "net10k_rows": res[0]["rows"],
                    "net10k_rungs": res[0]["rungs"]})
    net_fused_kernel_checks(runs, summaries)


def joint_share(run_once, frames: int = 3) -> dict:
    """The share of a frame's device and host time spent in the joints'
    constraint build (``solver.JointSolve.build``) and in their passes
    (``JointSolve.run``), each range also timed by CUDA events, both in
    one profiled window (:func:`range_shares`)."""
    shares = range_shares(run_once, solver.JointSolve,
                          {"joint_build": "build", "joint_pass": "run"},
                          frames, events=True)
    return {"build": shares["joint_build"], "passes": shares["joint_pass"]}


# ---------------------------------------------------------------------------
# the fused solver with joints on the 10k net, and the LBVH broad phase on
# the 10k pit and the 43k pyramid
# ---------------------------------------------------------------------------

NPZ_LBVH_FUSED = os.path.join(ROOT, "artifacts",
                              "lbvh_fused_joints_jax.npz.xz")
# its cases run three frames each from JAX's state before it: the drape
# and a chain under gs_fused with joints
FUSED_JOINT_CASES = ("drape_fused", "chain_fused")
# pit_lbvh: chained_ps with the LBVH broad phase, warm and timed frames
# (each frame regrows the pair capacity, ROADMAP C11)
LBVH_WARM_FRAMES, LBVH_TIMED_FRAMES = 2, 10  # 20 timed before scale-out
# repeats of one LBVH refresh timed by CUDA events
LBVH_REPEATS = 5


def jointed_fused_calls(device) -> list:
    """The first substep's two B10 calls (biased, then unbiased, each
    launched alone) of ``ball_net3(16, 16)`` under the fused solver with
    joints (``net16_fused`` of ``lbvh_fused_joints_jax.npz.xz``): its first
    frame from JAX's warmed state under the configuration JAX's third frame
    ran (every rung regrown)."""
    case = "net16_fused"
    state = joints_case_state(case, "warmed", device, NPZ_LBVH_FUSED)
    cfg = joints_case_config(f"{case}.ref.2.config_json", NPZ_LBVH_FUSED)
    params = joints_case_params(case, NPZ_LBVH_FUSED)
    return record_fused(lambda: step_checked(state, params, cfg), 2,
                        ("fused_sweep",))


def net_fused_gates(runs: dict, params) -> dict:
    """``net_fused`` against ``net_ladder``: three plain steps each from
    ``net_fused``'s warmed state under both configurations (max |dp| within
    ``SHORT_GATE_LIMIT``), and the end states' envelopes (deepest centre
    below a ball's radius within the ladder's plus
    ``ENVELOPE_PEN_SLACK``, KE within ``ENVELOPE_KE_FACTOR`` x the
    ladder's plus ``ENVELOPE_KE_SLACK``)."""
    lad, fus = runs["net_ladder"], runs["net_fused"]
    st, cfg_f = fus["warmed"]
    ends = []
    for cfg in (cfg_f, lad["warmed"][1]):
        s = st
        for _ in range(SHORT_GATE_STEPS):
            s = step(s, params, cfg)
        check(_finite(s), "net_fused gate: non-finite state")
        ends.append(s.bodies.poses.translation)
    err = _max_dp(*ends)
    m_f, m_l = fus["metrics"], lad["metrics"]
    ke_f, pen_f = m_f["kinetic_energy"], m_f["max_penetration"]
    ke_l, pen_l = m_l["kinetic_energy"], m_l["max_penetration"]
    print(f"gate net_fused vs net_ladder over {SHORT_GATE_STEPS} steps from "
          f"one warmed state: max|dp| {err:.3e} (limit {SHORT_GATE_LIMIT}); "
          f"envelopes after {NET_WARM_FRAMES + NET_TIMED_FRAMES} frames: KE "
          f"{ke_f:.4f} vs ladder {ke_l:.4f}, depth below a radius "
          f"{pen_f:.5f} vs {pen_l:.5f}")
    check(np.isfinite(err) and err <= SHORT_GATE_LIMIT,
          f"net_fused diverges from net_ladder by {err:.3e} m over "
          f"{SHORT_GATE_STEPS} steps")
    check(pen_f <= pen_l + ENVELOPE_PEN_SLACK
          and ke_f <= ENVELOPE_KE_FACTOR * ke_l + ENVELOPE_KE_SLACK,
          "net_fused envelope exceeds net_ladder's")
    # recorded: how far the two runs from the drape state part, frame by
    # frame through the warm frames, and at the end
    parted = {f + 1: _max_dp(a, b) for f, (a, b) in
              enumerate(zip(fus["trail"], lad["trail"]))}
    parted[NET_WARM_FRAMES + NET_TIMED_FRAMES] = _max_dp(
        fus["end"][0].bodies.poses.translation,
        lad["end"][0].bodies.poses.translation)
    print("net_fused against net_ladder from the drape state, max|dp| "
          "after each frame (recorded): " + ", ".join(
              f"{f}: {d:.3e}" for f, d in parted.items()))
    return {f"vs_ladder_{SHORT_GATE_STEPS}_steps": err,
            "vs_ladder_from_drape": parted,
            "envelopes": {"net_fused": {"ke": ke_f, "pen": pen_f},
                          "net_ladder": {"ke": ke_l, "pen": pen_l}}}


def net_fused_kernel_checks(runs: dict, summaries: dict) -> None:
    """B10 launched alone on the 10k net's own plan: the biased and the
    unbiased sweep of substep 1 of the first frame after ``net_fused``'s
    warm frames, recorded from ``step_checked``, each one launch against
    the same kernel launched colour by colour and its repeats (bit for
    bit) and against its plain version (bit for bit), timed with the
    plain version; under ``net10k_*`` in B10's summary."""
    state, cfg = runs["net_fused"]["warmed"]
    params = joints_case_params("net100")
    calls = record_fused(lambda: step_checked(state, params, cfg), 2,
                         ("fused_sweep",))
    sub = params.substep()
    check(len(calls) == 2 and all(c.kw.get("integrate") is None
                                  for c in calls),
          "net_fused: the first two sweeps are not B10 launched alone")
    row = summaries["fused_sweep"]
    res = []
    for label, call, cfm in (("biased", calls[0], sub.contact_cfm_factor),
                             ("unbiased", calls[1], 1.0)):
        check(float(call.args[6]) == float(cfm), f"fused_sweep net10k "
              f"{label}: cfm {call.args[6]} where {cfm} was expected")
        got = fused_bits(call, f"net10k {label}")
        want = run_fused(call, "plain")
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"fused_sweep net10k {label}: one launch differs from the "
              f"plain version (max abs diff {err:.3e})")
        k_ms = _median_ms(lambda: run_fused(call, "kernel"))
        counts_h = call.args[-1].cpu()
        p_ms = _median_ms(lambda: FUSED_FNS["fused_sweep"][1](
            *call.args[:-1], counts_h, **call.kw))
        meta = call.kw["meta"]
        k_load = max(meta[f][0] + gs_math._size(meta[f][1])
                     for f in gs_math.UPDATE_FIELDS)
        z = dict(p_max=call.kw["p_max"], windows=call.kw["windows"],
                 counts=call.args[-1], ctot=call.args[1].shape[1],
                 w_g=call.args[0].shape[1])
        res.append(_report("fused_sweep", f"net10k {label} (C={z['ctot']}, "
                           f"Wg={z['w_g']}, {_fused_rows(z)} swept rows)",
                           err, 0.0, "bit for bit against the plain version, "
                           f"= colour by colour, {FUSED_REPEATS} repeats",
                           k_ms, p_ms, sweep_work(z, k_load, False)))
        res[-1]["grid"] = gs_fused.LAST_GRID["fused_sweep"]
    row["max_abs_err"] = max([row["max_abs_err"]]
                             + [r["max_abs_err"] for r in res])
    row.update({"net10k_ms": [r["ms"] for r in res],
                "net10k_plain_ms": [r["plain_ms"] for r in res],
                "net10k_bound_ms": [r["bound_ms"] for r in res],
                "net10k_grid": [r["grid"] for r in res]})


def _pair_set(p) -> set:
    v = p.valid
    return set(zip(p.body_a[v].tolist(), p.body_b[v].tolist()))


def _contact_set(state) -> set:
    c = state.prev_constraints
    return set(zip(c.body_a[c.valid].tolist(), c.body_b[c.valid].tolist()))


def lbvh_window_bodies(mins, maxs) -> set:
    """The bodies whose LBVH leaf overlaps more later-ranked leaves than
    its window holds (``lbvh._PER_LEAF_CAP``, 64): ``find_pairs_lbvh``
    keeps the first 64 of their pairs, as the JAX package's does, and
    reports the overflow through ``count`` (ROADMAP C11)."""
    n = mins.shape[0]
    tree = lbvh_mod.build(mins, maxs)
    counts, _ = lbvh_mod._traverse(tree, tree.node_min[n - 1:],
                                   tree.node_max[n - 1:])
    return set(tree.order[counts > lbvh_mod._PER_LEAF_CAP].tolist())


def lbvh_against_grid(label: str, lbvh_set: set, grid_set: set,
                      window: set, count: int, capacity: int) -> dict:
    """The LBVH's pairs (or contacts) against the grid's on the same
    boxes, under the JAX package's semantics (ROADMAP C11): none the grid
    lacks; every one it misses has a body whose leaf overflowed its
    window, and then ``count`` reports it (past ``capacity``). Without an
    overflowing leaf the two sets are equal."""
    missed = grid_set - lbvh_set
    extra = lbvh_set - grid_set
    bad = [pr for pr in missed if not (set(pr) & window)]
    out = {"lbvh": len(lbvh_set), "grid": len(grid_set),
           "missed": len(missed), "window_bodies": sorted(window)[:16],
           "count": count, "capacity": capacity}
    print(f"lbvh {label}: {len(lbvh_set)} (grid {len(grid_set)}); "
          f"{len(missed)} missed, each with a body past the 64-pair window "
          f"(bodies {sorted(window)[:8]}{' ...' if len(window) > 8 else ''}"
          f"), count {count} against capacity {capacity}")
    check(not extra, f"lbvh {label}: {len(extra)} the grid does not have")
    check(not bad, f"lbvh {label}: {len(bad)} missed without a body past "
          f"the window, e.g. {bad[:4]}")
    check(count > capacity if window else missed == set(),
          f"lbvh {label}: the window's overflow is not reported "
          f"(count {count}, capacity {capacity}, {len(window)} bodies)")
    return out


def lbvh_refresh_figures(mins, maxs, capacity: int, label: str) -> dict:
    """One ``find_pairs_lbvh`` call on the card: its time by CUDA events
    (median of ``LBVH_REPEATS``, host reads included, as the step sees
    it), host wall time, host reads (``core.dispatch.HOST_SYNCS``), device
    kernels and device kernel time (one profiled call)."""
    fn = lambda: find_pairs_lbvh(mins, maxs, capacity=capacity)  # noqa
    fn()
    torch.cuda.synchronize()
    ev, wall = [], []
    for _ in range(LBVH_REPEATS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s0 = dispatch.HOST_SYNCS
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        ev.append(a.elapsed_time(b))
        reads = dispatch.HOST_SYNCS - s0
    prof = profile_window(fn, 1)
    out = {"boxes": int(mins.shape[0]), "event_ms": statistics.median(ev),
           "host_wall_ms": statistics.median(wall), "host_reads": reads,
           "kernels": prof["kernels_per_step"],
           "device_kernel_ms": prof["device_ms_per_step"]}
    print(f"lbvh refresh {label}: {out['boxes']} boxes, "
          f"{out['event_ms']:.3f} ms by CUDA events (median of "
          f"{LBVH_REPEATS}), host wall {out['host_wall_ms']:.3f} ms, "
          f"{reads} host reads, {out['kernels']:.0f} device kernels, "
          f"kernel time {out['device_kernel_ms']:.3f} ms")
    return out


def pyramid_lbvh_check(params) -> dict:
    """``find_pairs_lbvh`` on ``pyramid(BOX_LEVELS)``'s boxes (42,925
    cuboids and the ground, first state, the prediction margin) against
    the grid's pairs (budgets wide enough not to overflow) under
    :func:`lbvh_against_grid`, and one call's figures. No step is
    taken."""
    from wgmath_tpu_torch.scenes.builders import pyramid

    st = pyramid(BOX_LEVELS, device="cuda")
    mn, mx = shp.world_aabbs(st.shapes, st.bodies.poses,
                             margin=params.prediction_distance)
    cap = 1 << 20
    grid = find_pairs_grid(mn, mx, capacity=cap, max_per_body=64,
                           cell_cap=32, global_cap=64, cand_budget=432)
    g_set = _pair_set(grid)
    check(int(grid.count) == len(g_set) > 0, f"lbvh pyramid: the grid "
          f"overflowed or dropped pairs (count {int(grid.count)})")
    lb = find_pairs_lbvh(mn, mx, capacity=cap)
    out = lbvh_against_grid(f"pyramid({BOX_LEVELS}) pairs", _pair_set(lb),
                            g_set, lbvh_window_bodies(mn, mx),
                            int(lb.count), cap)
    out["refresh"] = lbvh_refresh_figures(mn, mx, cap,
                                          f"pyramid({BOX_LEVELS})")
    return out


def lbvh_phase(params) -> dict:
    """The LBVH broad phase on the card. The settled 10k pit under
    ``chained_ps`` with ``bp_algo="lbvh"`` (``pit_lbvh``): from the stored
    state, one checked frame with a full broad-phase refresh under the LBVH
    and under the grid; the pairs after the post-filters and the contacts
    against the grid's (:func:`lbvh_against_grid`: the pit's ground and
    walls overlap more than the 64-pair window of later leaves, and the
    LBVH keeps the first 64 as the JAX package's does, ROADMAP C11); two
    more checked frames each (finite; their distance to the grid's run
    recorded); then ``LBVH_WARM_FRAMES`` warm and ``LBVH_TIMED_FRAMES``
    timed frames from the LBVH's first frame (each regrows the pair
    capacity, C11). One LBVH refresh at the pit's step inputs (recorded
    from that frame) and ``pyramid(BOX_LEVELS)``'s boxes
    (:func:`pyramid_lbvh_check`), timed. Returns ``pit_lbvh`` (a run) and
    ``lbvh_checks``."""
    z = dict(np.load(NPZ))
    cfg_ps = PipelineConfig.from_dict(json.loads(str(z["config_json"])))
    cfgs = {"grid": cfg_ps, "lbvh": dataclasses.replace(cfg_ps,
                                                         bp_algo="lbvh")}
    seen = []
    real = pipeline_mod.find_pairs_lbvh

    def recording(mn, mx, *, capacity):
        out = real(mn, mx, capacity=capacity)
        seen.append((mn.clone(), mx.clone(), capacity, int(out.count)))
        return out

    first, ends = {}, {}
    pipeline_mod.find_pairs_lbvh = recording
    try:
        for algo, cfg in cfgs.items():
            s, c = step_checked(state_from_arrays(z, device="cuda"), params,
                                dataclasses.replace(cfg, bp_force="miss"))
            check(_finite(s), f"pit_lbvh {algo} first frame: non-finite")
            first[algo] = (s, dataclasses.replace(c, bp_force=None))
    finally:
        pipeline_mod.find_pairs_lbvh = real
    check(len(seen) >= 1, "pit_lbvh: the LBVH was not called")
    mn, mx, cap, count = seen[-1]
    window = lbvh_window_bodies(mn, mx)
    (s_g, _), (s_l, _) = first["grid"], first["lbvh"]
    out = {"pairs": lbvh_against_grid(
               "pit pairs after the post-filters", _pair_set(s_l.bp_pairs),
               _pair_set(s_g.bp_pairs), window, count, cap),
           "contacts": lbvh_against_grid(
               "pit contacts", _contact_set(s_l), _contact_set(s_g), window,
               count, cap),
           "first_frame_calls": len(seen)}
    for algo, (s, c) in first.items():
        for _ in range(SHORT_GATE_STEPS - 1):
            s, c = step_checked(s, params, c)
        check(_finite(s), f"pit_lbvh {algo}: non-finite after "
              f"{SHORT_GATE_STEPS} frames")
        ends[algo] = s.bodies.poses.translation
    err = _max_dp(ends["lbvh"], ends["grid"])
    out[f"vs_grid_{SHORT_GATE_STEPS}_frames"] = err
    print(f"pit_lbvh vs chained_ps (grid) after {SHORT_GATE_STEPS} frames "
          f"from one state: max|dp| {err:.3e} (recorded: the LBVH misses "
          f"{out['contacts']['missed']} of the ground's and walls' "
          "contacts, C11)")
    out["refresh_pit"] = lbvh_refresh_figures(mn, mx, cap, "pit")
    out["pyramid"] = pyramid_lbvh_check(params)
    s, c = first["lbvh"]
    run = run_path("pit_lbvh", s, c, params, None, ("gs_math_rhs",),
                   warm=LBVH_WARM_FRAMES, timed=LBVH_TIMED_FRAMES)
    run["metrics"]["pair_capacity"] = run["end"][1].pair_capacity
    return {"pit_lbvh": run, "lbvh_checks": out}


# ---------------------------------------------------------------------------
# the meshes: trimesh3, the small mesh / convex / standalone cases, and
# mesh10k (10,000 bodies on the 100k-triangle field)
# ---------------------------------------------------------------------------

NPZ_MESH = os.path.join(ROOT, "artifacts", "mesh_jax.npz.xz")
# trimesh3 after JAX's state, mesh10k after its three reference frames:
# warm and timed frames
MESH_WARM_FRAMES, MESH_TIMED_FRAMES = 3, 10
MESH10K_REF_FRAMES = 3
MESH_DEPTH_LIMIT = 0.05  # the deepest contact after the timed frames, m
STANDALONE_FRAMES = 40  # each scene rests from frame 16 on (80 in JAX's)
STANDALONE_END_LIMIT = 1e-3  # the end against JAX's, m
MESH_PATHS = {"trimesh3": ("gs_math_block",), "mesh10k": ("gs_math_block",)}
# mesh10k's convex rows against JAX's (tests/test_torch_gjk.py's GJK_ATOL),
# and the share of them JAX's float32 GJK may misjudge (C13: 1,128 of
# 20,000 on the first frame, scripts/check_mesh_gjk.py)
GJK_ROW_ATOL = 1e-4
C13_ROW_SHARE = 0.08
# mesh10k against JAX's translations, the cuboids at limits set from the
# card's readings (H100 80GB HBM3, 700 W; the same in four runs): frame 1,
# the cuboids no misjudged row touches (their rows' normals may still part
# in float32 on world-scale triangles; 3.17e-4 m read, 2.3e-4 on the CPU)
# and the cuboids a misjudged row touches (3.19e-3 m read: JAX pushes them
# off false overlaps); frame 3, every cuboid (7.98e-3 m read, 2,253 past
# 1 mm: each frame JAX misjudges ~1,100 other rows)
CUBOID_FRAME1_LIMIT = 5e-4
CUBOID_TOUCHED_LIMIT = 4e-3
CUBOID_FRAME3_LIMIT, CUBOID_FRAME3_PAST_1MM = 1e-2, 2500


def mesh10k_scene(device="cuda"):
    """10,000 bodies on the 225 x 225 field at 0.2 m (100,352 triangles,
    the static body 0) from the port's public constructors: the 5,000 balls
    and 5,000 cuboids of ``tests/mesh_inputs.mesh10k_layout``.
    ``scripts/export_mesh_npz.py``'s ``mesh10k_scene`` builds the JAX
    package's; ``tests/test_torch_pipeline_mesh.py`` holds the two equal
    array for array."""
    from tests.mesh_inputs import (
        MESH10K_BALL_R,
        MESH10K_BOX_HE,
        MESH10K_SPACING,
        mesh10k_layout,
    )
    from wgmath_tpu_torch.pipeline import new_state
    from wgmath_tpu_torch.scenes.builders import _merge_mprops
    from wgmath_tpu_torch.shapes.mesh import heightfield

    dev = torch.device(device)
    h, balls, boxes = mesh10k_layout()
    r = torch.full((len(balls),), MESH10K_BALL_R, device=dev)
    he = torch.full((len(boxes), 3), MESH10K_BOX_HE, device=dev)
    shapes = shp.ShapeSet.concat(
        heightfield(h, MESH10K_SPACING, MESH10K_SPACING, device=dev),
        shp.ShapeSet.balls(r), shp.ShapeSet.cuboids(he))
    trans = torch.from_numpy(np.concatenate(
        [np.zeros((1, 3), np.float32), balls, boxes])).to(dev)
    n = trans.shape[0]
    rot = torch.zeros((n, 4), device=dev)
    rot[:, 3] = 1.0
    mp = _merge_mprops(
        body_ops.cuboid_local_mprops(
            torch.tensor([[25.0, 1.0, 25.0]], device=dev),
            dynamic=torch.tensor([False], device=dev)),
        body_ops.ball_local_mprops(r), body_ops.cuboid_local_mprops(he))
    return new_state(body_ops.Bodies(Sim(rot, trans, torch.ones(n,
                                                                 device=dev)),
                                     body_ops.Velocity.zero(n, device=dev),
                                     mp), shapes)


def mesh10k_pipeline_config(shapes) -> PipelineConfig:
    """The testbed runner's configuration (``PipelineConfig(pair_capacity=
    16384)`` with ``auto_manifold_points``) with
    ``tests/mesh_inputs.mesh10k_config``'s mesh batch of 16,384 pairs."""
    from tests.mesh_inputs import mesh10k_config
    from wgmath_tpu_torch.pipeline import auto_manifold_points

    cfg = dataclasses.replace(
        PipelineConfig(pair_capacity=16384,
                       manifold_points=auto_manifold_points(shapes, 3)),
        **mesh10k_config())
    check(cfg.manifold_points == 4, "mesh10k: not a 4-point scene")
    return cfg


def standalone_scene(name: str, device="cuda"):
    """``scripts/export_mesh_npz.py``'s standalone cases from the port's
    constructors: a ball of radius 0.4 over a bare triangle (0.55 m up)
    and over a wire (0.5 m; ``tests/test_standalone_shapes.py``'s), and a
    convex polyhedron (a 0.3-cube's corners) 0.45 m over a slab whose top
    is at 0.1 m. Returns the state and its configuration."""
    from tests.mesh_inputs import cube_corners
    from wgmath_tpu_torch.pipeline import new_state
    from wgmath_tpu_torch.scenes.builders import _merge_mprops
    from wgmath_tpu_torch.shapes.mesh import convex_polyhedron

    dev = torch.device(device)
    ball = shp.ShapeSet.balls(torch.tensor([0.4], device=dev))
    if name == "triangle":
        base = shp.ShapeSet.triangles(torch.tensor(
            [[[-2.0, 0.0, -2.0], [2.0, 0.0, -2.0], [0.0, 0.0, 2.0]]],
            device=dev))
        body, y0 = ball, 0.55
    elif name == "segment":
        base = shp.ShapeSet.segments(torch.tensor([[-2.0, 0.0, 0.0]],
                                                  device=dev),
                                     torch.tensor([[2.0, 0.0, 0.0]],
                                                  device=dev))
        body, y0 = ball, 0.5
    else:
        base = shp.ShapeSet.cuboids(torch.tensor([[3.0, 0.1, 3.0]],
                                                 device=dev))
        body, y0 = convex_polyhedron(cube_corners(0.3), device=dev), 0.45
    shapes = shp.ShapeSet.concat(base, body)
    trans = torch.tensor([[0.0, 0.0, 0.0], [0.0, y0, 0.0]], device=dev)
    rot = torch.zeros((2, 4), device=dev)
    rot[:, 3] = 1.0
    mp_body = (body_ops.ball_local_mprops(body.params[:, 0])
               if name != "convex" else body_ops.cuboid_local_mprops(
                   torch.tensor([[0.3, 0.3, 0.3]], device=dev)))
    mp = _merge_mprops(body_ops.cuboid_local_mprops(
        torch.tensor([[1.0, 1.0, 1.0]], device=dev),
        dynamic=torch.tensor([False], device=dev)), mp_body)
    state = new_state(body_ops.Bodies(Sim(rot, trans, torch.ones(
        2, device=dev)), body_ops.Velocity.zero(2, device=dev), mp), shapes)
    cfg = PipelineConfig(pair_capacity=64, max_colors=4,
                         manifold_points=4 if name == "convex" else 1)
    return state, cfg


def field_surface(h: np.ndarray, spacing: float, xz: np.ndarray):
    """The height of ``heightfield(h, spacing, spacing)`` under each
    (x, z) (its two triangles a cell: [a, b, c] and [b, d, c])."""
    c = (h.shape[0] - 1) / 2.0
    g = xz / spacing + c
    i = np.clip(np.floor(g[:, 0]).astype(int), 0, h.shape[0] - 2)
    j = np.clip(np.floor(g[:, 1]).astype(int), 0, h.shape[1] - 2)
    u, w = g[:, 0] - i, g[:, 1] - j
    ha, hb, hc, hd = h[i, j], h[i, j + 1], h[i + 1, j], h[i + 1, j + 1]
    return np.where(u + w <= 1.0, ha + (hc - ha) * u + (hb - ha) * w,
                    hd + (hb - hd) * (1.0 - u) + (hc - hd) * (1.0 - w))


@contextlib.contextmanager
def cluster_rounds():
    """The cluster rounds of every ``point_topk_prims`` call the mesh
    contacts make inside the block (a list, one entry a call)."""
    from wgmath_tpu_torch.queries import mesh_contact

    rounds, real = [], mesh_contact.point_topk_prims

    def counted(*args, **kw):
        kw["rounds"] = rounds
        return real(*args, **kw)

    mesh_contact.point_topk_prims = counted
    try:
        yield rounds
    finally:
        mesh_contact.point_topk_prims = real


def mesh_rows(state, cfg) -> list:
    """Valid rows of the ball and of the convex mesh batches in the
    uncompacted constraint buffer after a step."""
    valid = state.prev_constraints.valid
    lo = cfg.pair_capacity
    mid = lo + cfg.mesh_pair_capacity * cfg.mesh_k_best
    return [int(valid[lo:mid].sum()), int(valid[mid:].sum())]


def grid_pairs(state, cfg, params):
    """The pairs the step's grid broad phase finds for ``state`` (no
    slack: the mesh scenes refresh every frame), read outside the step."""
    poses = state.bodies.poses
    mn, mx = shp.world_aabbs(state.shapes, poses,
                             margin=params.prediction_distance)
    return find_pairs_grid(
        mn, mx, capacity=cfg.pair_capacity,
        max_per_body=cfg.broad_phase_max_per_row, cell_cap=cfg.bp_cell_cap,
        global_cap=cfg.bp_global_cap, cand_budget=cfg.bp_cand_budget,
        ball_radius=shp.ball_radii_or_nan(state.shapes, poses),
        margin=params.prediction_distance,
        dynamic=state.bodies.is_dynamic())


def mesh_demand(state, cfg, params) -> list:
    """The trimesh-ball and trimesh-convex pairs of the state's broad phase,
    read outside the step: the demand on the mesh batches, which the step
    neither counts nor regrows (C12)."""
    from wgmath_tpu_torch.queries.mesh_contact import mesh_pair_demand

    return mesh_pair_demand(state.shapes,
                            grid_pairs(state, cfg, params)).tolist()


def convex_row_referee(state, cfg, params, rows: torch.Tensor):
    """The triangle-to-convex core distances of the given rows of the
    step's convex mesh batch from ``state`` (the rows
    ``mesh_convex_contacts`` lays out: its pair compaction and its exact
    top-k triangles), by the port's GJK in float64, less the triangle
    margin: the referee of a row where the port and the JAX package part.
    Returns (distances [R], the rows' convex bodies [R])."""
    from wgmath_tpu_torch.queries import gjk
    from wgmath_tpu_torch.queries import mesh_contact as mc
    from wgmath_tpu_torch.shapes.mesh import TRI_MARGIN

    shapes, poses = state.shapes, state.bodies.poses
    pairs = grid_pairs(state, cfg, params)
    _, flags = mc._mesh_flags(shapes, pairs)
    k = cfg.mesh_k_best
    sel, active, _ = narrow_mod._compact_mask(flags,
                                              cfg.mesh_pair_capacity // 2)
    pa, pb = pairs.body_a[sel], pairs.body_b[sel]
    mesh_is_a = shapes.tag[pa] == shp.TRIMESH
    mesh_body = torch.where(mesh_is_a, pa, pb)
    cvx_body = torch.where(mesh_is_a, pb, pa)
    mesh_pose, cvx_pose = poses.take(mesh_body), poses.take(cvx_body)
    c_local = sim_ops.inv_mul_pt(mesh_pose, cvx_pose.translation)
    he = shp.local_aabb_half_extents(shapes, 3)[cvx_body]
    reach = (gjk.norm_fma(he) * cvx_pose.scale + TRI_MARGIN
             + params.prediction_distance) / mesh_pose.scale
    best, _ = mc._topk_by_score(
        shapes, shapes.params[mesh_body, 2].long(),
        shapes.params[mesh_body, 3].long(), c_local, active, k,
        mc._tri_dist, 0.0, reach)
    pair, slot = rows // k, rows % k
    tri = shapes.vertices[shapes.indices[best[pair, slot]]].double()
    mp, cp = mesh_pose.take(pair), cvx_pose.take(pair)

    def f64(p):
        return Sim(p.rotation.double(), p.translation.double(),
                   p.scale.double())

    body = cvx_body[pair]
    res = gjk.gjk_distance(
        torch.full_like(body, shp.TRIANGLE),
        torch.zeros((len(rows), shp.NUM_PARAMS), dtype=torch.float64,
                    device=body.device), f64(mp), shapes.tag[body],
        shapes.params[body].double(), f64(cp), tri_verts_a=tri, window=0)
    return res.distance - TRI_MARGIN, body


def mesh10k_frame1(state0, state1, cfg, params, z) -> dict:
    """``mesh10k``'s first frame against the JAX package's. Pairs and the
    ball rows exactly. The convex batch row by row: a row whose distance is
    within ``GJK_ROW_ATOL`` of JAX's (and alike valid) agrees; every other
    row must be one where JAX's float32 GJK on the triangle left the true
    distance (C13): the port within ``GJK_ROW_ATOL`` of the float64
    referee (:func:`convex_row_referee`) and valid as the referee's
    distance makes it, and at most ``C13_ROW_SHARE`` of the rows. So the
    convex rows and the contacts count exactly JAX's, each such row
    counted by the referee. The balls within ``TRANSLATION_LIMITS[0]`` of
    JAX's translations; the cuboids no such row touches within
    ``CUBOID_FRAME1_LIMIT`` (rows alike in distance may part in normal),
    the others within ``CUBOID_TOUCHED_LIMIT``."""
    from wgmath_tpu_torch.shapes.mesh import TRI_MARGIN

    ref = "mesh10k.ref.0."
    pc = state1.pair_count.cpu().numpy()
    rows = mesh_rows(state1, cfg)
    want_rows = z[ref + "mesh_rows"].tolist()
    check(pc[0] == z[ref + "pair_count"][0] and rows[0] == want_rows[0],
          f"mesh10k frame 0: pairs {pc[0]} / ball rows {rows[0]} against "
          f"JAX's {z[ref + 'pair_count'][0]} / {want_rows[0]}")
    cons = state1.prev_constraints
    mid = cfg.pair_capacity + cfg.mesh_pair_capacity * cfg.mesh_k_best
    d_port = cons.info_dist[mid:mid + 20_000, 0]
    v_port = cons.valid[mid:mid + 20_000].cpu().numpy()
    d_jax = z[ref + "convex_dist"]
    off = (np.abs(d_port.cpu().numpy() - d_jax) > GJK_ROW_ATOL) | (
        v_port != z[ref + "convex_valid"])
    idx = torch.from_numpy(np.nonzero(off)[0]).to(d_port.device)
    d64, bodies = convex_row_referee(state0, cfg, params, idx)
    d64 = d64.cpu().numpy()
    port_ok = np.abs(d_port[idx].double().cpu().numpy() - d64) <= GJK_ROW_ATOL
    jax_off = np.abs(d_jax[off] - d64) > 1e-3
    jax_overlaps = int((d_jax[off] == -0.02).sum())
    # the referee's validity (mesh_convex_contacts' rule on its distance);
    # a row within GJK_ROW_ATOL of the threshold counts as the port has it
    thr = params.prediction_distance + TRI_MARGIN * 0.5
    ambiguous = np.abs(d64 - thr) <= GJK_ROW_ATOL
    ref_valid = np.where(ambiguous, v_port[off], d64 < thr)
    want_convex = int(z[ref + "convex_valid"][~off].sum() + ref_valid.sum())
    want_contacts = int(z[ref + "pair_count"][1]) - want_rows[1] + want_convex
    out = {"convex_rows_off_jax": int(off.sum()),
           "of_which_jax_overlaps": jax_overlaps,
           "port_within_referee": int(port_ok.sum()),
           "jax_off_referee": int(jax_off.sum()),
           "referee_ambiguous_rows": int(ambiguous.sum()),
           "convex_valid_rows": [int(v_port.sum()), want_rows[1],
                                 want_convex],
           "contacts": [int(pc[1]), int(z[ref + "pair_count"][1]),
                        want_contacts]}
    print(f"mesh10k frame 0 convex rows (port, JAX, JAX with the referee's "
          f"rows): {out}")
    check(int(z[ref + "convex_valid"].sum()) == want_rows[1]
          and rows[1] == int(v_port.sum()),
          f"mesh10k frame 0: the convex rows past the first 20,000: {out}")
    check(bool(np.all(port_ok)) and off.sum() <= C13_ROW_SHARE * len(off),
          f"mesh10k frame 0: convex rows off JAX's not all JAX's misjudged "
          f"GJK rows: {out}")
    check(rows[1] == want_convex and int(pc[1]) == want_contacts
          and bool(np.all(v_port[off] == ref_valid)),
          f"mesh10k frame 0: convex rows or contacts off the count of JAX's "
          f"rows with the referee's: {out}")
    ball = (state0.shapes.tag == shp.BALL).cpu().numpy()
    touched = np.zeros_like(ball)
    touched[bodies.cpu().numpy()] = True
    d = np.abs((state1.bodies.poses.translation
                - state0.bodies.poses.translation).cpu().numpy()
               - z[ref + "offset"]).max(-1)
    cub = ~ball & ~touched
    cub[0] = False  # the field
    out.update(max_dx_balls=float(d[ball].max()),
               max_dx_cuboids_untouched=float(d[cub].max()),
               cuboids_touched=int(touched.sum()),
               max_dx_touched=float(d[touched].max()))
    check(out["max_dx_balls"] <= TRANSLATION_LIMITS[0]
          and out["max_dx_cuboids_untouched"] <= CUBOID_FRAME1_LIMIT
          and out["max_dx_touched"] <= CUBOID_TOUCHED_LIMIT,
          f"mesh10k frame 0: translations off JAX's: {out}")
    return out


def mesh_small_cases() -> dict:
    """The CPU tests' small cases on the card (``tests/test_torch_mesh.py``
    holds them on the CPU): ``_topk_by_score``'s ids on the dense and the
    clustered field exactly against JAX's, the ball and convex contacts
    on both (ids and validity exactly, the rest as that file's rule), and
    the clustered field's ray cast."""
    from tests.mesh_inputs import (
        LARGE_FIELD,
        SMALL_FIELD,
        contact_scene,
        field_heights,
        field_rays,
        random_hull,
        topk_points,
    )
    from wgmath_tpu_torch.broad_phase.brute_force import PairList
    from wgmath_tpu_torch.queries import mesh_contact
    from wgmath_tpu_torch.shapes.mesh import convex_polyhedron, heightfield

    z = _stored(NPZ_MESH)
    out = {}
    for route, spec in (("dense", SMALL_FIELD), ("clustered", LARGE_FIELD)):
        h = field_heights(spec["n"], seed=spec["seed"])
        field = heightfield(h, spec["spacing"], spec["spacing"],
                            device="cuda")
        pts = _cuda(topk_points(h, spec["spacing"]))
        n_q = pts.shape[0]
        radius = _cuda(np.random.default_rng(12).uniform(0.05, 0.3, n_q))
        num = torch.full((n_q,), int(field.params[0, 3]), device="cuda")
        active = torch.from_numpy(np.arange(n_q) % 7 != 3).cuda()

        def score_fn(pt, va, vb, vc):
            return mesh_contact._tri_dist(pt, va, vb, vc) - radius[:, None]

        for cut, max_score in (("far", 1e8), ("near", 0.05)):
            ids, s = mesh_contact._topk_by_score(
                field, torch.zeros_like(num), num, pts, active, 4, score_fn,
                radius, max_score)
            key = f"topk.{route}.{cut}"
            check(np.array_equal(ids.cpu().numpy(), z[f"{key}.ids"]),
                  f"mesh {key}: triangle ids differ from JAX's")
            err = float(np.abs(s.cpu().numpy() - z[f"{key}.scores"]).max())
            check(err <= 1e-6, f"mesh {key}: scores off by {err:.3e}")
            out[f"topk_{route}_{cut}_score_err"] = err
        trans, q, r, he, hh, cr = contact_scene(h, spec["spacing"])
        shapes = shp.ShapeSet.concat(
            field, shp.ShapeSet.balls(torch.full((4,), r, device="cuda")),
            shp.ShapeSet.cuboids(torch.full((4, 3), he, device="cuda")),
            shp.ShapeSet.capsules(torch.full((4,), hh, device="cuda"),
                                  torch.full((4,), cr, device="cuda")),
            *(convex_polyhedron(random_hull(5 + i), device="cuda")
              for i in range(4)))
        poses = Sim(_cuda(q), _cuda(trans), torch.ones(17, device="cuda"))
        pairs = PairList(
            torch.zeros(20, dtype=torch.int64, device="cuda"),
            torch.from_numpy(np.r_[np.arange(1, 17), 0, 0, 0, 0]).cuda(),
            torch.arange(20, device="cuda") < 16,
            torch.tensor(16, device="cuda"))
        for kind, fn, cap, tol, n_tol, off_rows in (
                ("ball", mesh_contact.mesh_ball_contacts, 8, 1e-5, 1e-5, 0),
                ("convex", mesh_contact.mesh_convex_contacts, 16, 1e-4, 2e-3,
                 1)):
            c = fn(poses, shapes, pairs, 0.05, pair_cap=cap, k_best=4)
            key = f"contacts.{route}.{kind}"
            for f in ("body_a", "body_b", "valid"):
                check(np.array_equal(getattr(c, f).cpu().numpy(),
                                     z[f"{key}.{f}"]),
                      f"mesh {key}: {f} differs from JAX's")
            v = c.valid.cpu().numpy()
            n_j = z[f"{key}.normal_a"][v]
            d_d = np.abs(c.dist[:, 0].cpu().numpy()[v] - z[f"{key}.dist"][v])
            d_n = np.abs(c.normal_a.cpu().numpy()[v] - n_j).max(-1)
            d_p = np.abs(np.sum((c.points_a[:, 0].cpu().numpy()[v]
                                 - z[f"{key}.point"][v]) * n_j, -1))
            off = int(((d_d > tol) | (d_n > n_tol) | (d_p > tol)).sum())
            print(f"mesh {key}: {int(v.sum())} rows, ids and validity as "
                  f"JAX's, {off} off JAX's numbers (allowed {off_rows}); "
                  f"max |dd| {d_d.max():.3e}")
            check(off <= off_rows, f"mesh {key}: {off} rows off JAX's")
            out[f"{key}_off_rows"] = off
        o, d = field_rays(h, spec["spacing"])
        n = len(o)
        tiled = shp.ShapeSet(field.tag.repeat(n), field.params.repeat(n, 1),
                             field.vertices, field.indices,
                             field.cluster_min, field.cluster_max,
                             kinds=field.kinds)
        rot = torch.zeros((n, 4), device="cuda")
        rot[:, 3] = 1.0
        t = ray.cast(tiled, Sim(rot, torch.zeros((n, 3), device="cuda"),
                                torch.ones(n, device="cuda")),
                     _cuda(o), _cuda(d)).cpu().numpy()
        want = z[f"ray.{route}"]
        both = np.isfinite(t) & np.isfinite(want)
        ok = (np.array_equal(np.isfinite(t), np.isfinite(want))
              and bool(np.all(np.abs(t[both] - want[both])
                              <= 1e-6 + 1e-5 * np.abs(want[both]))))
        check(ok, f"mesh ray.{route}: the field cast differs from JAX's")
    print(f"mesh small cases on the card: {out}")
    return out


def standalone_checks(params) -> dict:
    """The standalone segment / triangle / convex scenes
    ``STANDALONE_FRAMES`` frames on the card against JAX's trails (the end
    within ``STANDALONE_END_LIMIT``) and ``tests/test_standalone_shapes.py``'s
    rest checks."""
    z = _stored(NPZ_MESH)
    out = {}
    for name, y_tol in (("triangle", 5e-3), ("segment", 2e-2),
                        ("convex", 5e-3)):
        state, cfg = standalone_scene(name)
        for f in range(STANDALONE_FRAMES):
            state = step(state, params, cfg, warmstart=f > 0)
        tr = state.bodies.poses.translation[1].cpu().numpy()
        v = float(torch.linalg.norm(state.bodies.vels.linear[1]))
        want = z[f"standalone.{name}.trail"][STANDALONE_FRAMES - 1]
        err = float(np.abs(tr - want).max())
        out[name] = {"end": tr.tolist(), "vs_jax": err, "speed": v}
        print(f"standalone {name}: end {tr.tolist()} (JAX "
              f"{want.tolist()}, max|d| {err:.3e}), speed {v:.3e}")
        check(_finite(state) and err <= STANDALONE_END_LIMIT
              and abs(tr[1] - 0.4) < y_tol and v < 0.05,
              f"standalone {name}: not at rest on its collider as JAX's")
    return out


def mesh_phase(params) -> dict:
    """trimesh3 from JAX's states and timed; the small cases and the
    standalone scenes; mesh10k's three frames from its built state against
    JAX's, then timed, with its physical checks."""
    from tests.mesh_inputs import MESH10K_SPACING, mesh10k_layout

    z = _stored(NPZ_MESH)
    checks = {"trimesh3": joints_reference_phase(("trimesh3",),
                                                 NPZ_MESH)["trimesh3"],
              "small": mesh_small_cases(), "standalone":
              standalone_checks(params)}
    refs = {k[len("trimesh3."):]: v for k, v in z.items()
            if k.startswith("trimesh3.ref.")}
    runs = {"trimesh3": run_path(
        "trimesh3", joints_case_state("trimesh3", "warmed", npz=NPZ_MESH),
        joints_case_config("trimesh3.config_json", NPZ_MESH), params, refs,
        MESH_PATHS["trimesh3"], warm=MESH_WARM_FRAMES,
        timed=MESH_TIMED_FRAMES, envelopes=box_envelopes)}

    state = mesh10k_scene()
    cfg = mesh10k_pipeline_config(state.shapes)
    want_cfg = json.loads(str(z["mesh10k.config_json"]))
    want_cfg["gs_windows"] = tuple(want_cfg["gs_windows"])
    check(dataclasses.asdict(cfg) == want_cfg,
          "mesh10k: the configuration differs from the JAX run's")
    state0 = state
    tr0 = state.bodies.poses.translation.clone()
    balls = state.shapes.tag == shp.BALL
    frames = []
    with cluster_rounds() as rounds:
        for f in range(MESH10K_REF_FRAMES):
            n_calls, syncs = len(rounds), dispatch.HOST_SYNCS
            t0 = time.perf_counter()
            state, cfg = step_checked(state, params, cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ref = f"mesh10k.ref.{f}."
            pc = state.pair_count.cpu().numpy()
            rec = {"pair_count": pc.tolist(),
                   "mesh_rows": mesh_rows(state, cfg),
                   "jax_pair_count": z[ref + "pair_count"].tolist(),
                   "jax_mesh_rows": z[ref + "mesh_rows"].tolist(),
                   "rounds": rounds[n_calls:],
                   "host_syncs": dispatch.HOST_SYNCS - syncs,
                   "host_ms": 1e3 * dt}
            if f == 0:
                rec.update(mesh10k_frame1(state0, state, cfg, params, z))
            elif ref + "offset" in z:
                # chained: the balls (their rows are JAX's bit for bit)
                # within the chained limit; the cuboids within the limits
                # read on the card (JAX misjudges rows every frame, C13)
                d = np.abs((state.bodies.poses.translation - tr0).cpu()
                           .numpy() - z[ref + "offset"]).max(-1)
                b = balls.cpu().numpy()
                rec.update(max_dx_balls=float(d[b].max()),
                           max_dx_cuboids=float(d[~b].max()),
                           cuboids_past_1mm=int((d[~b] > 1e-3).sum()))
                check(rec["max_dx_balls"] <= TRANSLATION_LIMITS[2]
                      and rec["max_dx_cuboids"] <= CUBOID_FRAME3_LIMIT
                      and rec["cuboids_past_1mm"] <= CUBOID_FRAME3_PAST_1MM,
                      f"mesh10k frame {f}: translations off JAX's: {rec}")
            print(f"mesh10k frame {f} from the built state: {rec}")
            frames.append(rec)
    checks["mesh10k_frames"] = frames
    with cluster_rounds() as rounds:
        run = run_path("mesh10k", state, cfg, params, None,
                       MESH_PATHS["mesh10k"], warm=MESH_WARM_FRAMES,
                       timed=MESH_TIMED_FRAMES, envelopes=box_envelopes)
    end, end_cfg = run["end"]
    m = run["metrics"]
    m["cluster_rounds_per_frame"] = (
        sum(rounds) / (MESH_WARM_FRAMES + MESH_TIMED_FRAMES))
    m["rounds_per_call"] = sorted(set(rounds))
    h, _, _ = mesh10k_layout()
    tr = end.bodies.poses.translation.cpu().numpy()[1:]
    surface = field_surface(h, MESH10K_SPACING, tr[:, [0, 2]])
    below = int((tr[:, 1] < surface).sum())
    demand = mesh_demand(end, end_cfg, params)
    cap = end_cfg.mesh_pair_capacity
    phys = {"below_surface": below,
            "min_clearance": float((tr[:, 1] - surface).min()),
            "deepest_contact": m["max_penetration"],
            "mesh_pair_demand": demand, "mesh_pair_capacity": [cap,
                                                                cap // 2]}
    print(f"mesh10k physical checks: {phys}")
    check(below == 0, f"mesh10k: {below} centres below the field")
    check(m["max_penetration"] <= MESH_DEPTH_LIMIT,
          f"mesh10k: a contact {m['max_penetration']:.3f} m deep")
    check(demand[0] <= cap and demand[1] <= cap // 2,
          f"mesh10k: mesh pairs {demand} past the batches {cap}, "
          f"{cap // 2} would be dropped silently (C12)")
    checks["mesh10k_physics"] = phys
    runs["mesh10k"] = run
    runs["mesh_checks"] = checks
    return runs


def mesh_kernel_checks(runs: dict, params, summaries: dict) -> None:
    """B2 on mesh10k's own plan: the two sweeps of substep 1 of the first
    frame after the warm frames, each one launch against the same kernel
    launched rung by rung and its repeats (bit for bit) and against the
    plain sweep; under ``mesh10k_*`` in B2's summary."""
    state, cfg = runs["mesh10k"]["warmed"]
    calls = record_sweeps(lambda: step_checked(state, params, cfg), 2)
    check(len(calls) == 2 and all(c.kw["p_max"] == 4 for c in calls),
          "mesh10k: the recorded sweeps are not two 4-point ones")
    res = [_sweep_case("gs_math_block", f"mesh10k sweep {k + 1}", call, True)
           for k, call in enumerate(calls)]
    row = summaries["gs_math_block"]
    row["max_abs_err"] = max([row["max_abs_err"]]
                             + [r["max_abs_err"] for r in res])
    nbytes = sum(r["bytes"] for r in res)
    flops = sum(r["flops"] for r in res)
    row.update({"mesh10k_ms": sum(r["ms"] for r in res),
                "mesh10k_rungs_ms": sum(r["rungs_ms"] for r in res),
                "mesh10k_plain_ms": sum(r["plain_ms"] for r in res),
                "mesh10k_bound_ms": bound_ms(nbytes, flops)[0],
                "mesh10k_rows": res[0]["rows"],
                "mesh10k_rungs": res[0]["rungs"]})


def event_shares(run_once, ranges: dict, frames: int = 1) -> dict:
    """Each range of ``ranges`` (label -> (module, attribute)) counted and
    timed by CUDA events over ``frames`` unprofiled calls of ``run_once``
    after one untimed call (a path's first frame after another path may
    capture a CUDA graph again): calls a step, event ms a step and the
    share of the wall."""
    real = {at: getattr(*at) for at in ranges.values()}
    marks = {label: [] for label in ranges}

    def wrapper(label, fn):
        def wrapped(*args, **kw):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = fn(*args, **kw)
            end.record()
            marks[label].append((start, end))
            return out
        return wrapped

    run_once()
    for label, at in ranges.items():
        setattr(*at, wrapper(label, real[at]))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            run_once()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        for (mod, attr), fn in real.items():
            setattr(mod, attr, fn)
    out = {}
    for label, m in marks.items():
        ev_ms = sum(a.elapsed_time(b) for a, b in m)
        out[label] = {"calls_per_step": len(m) / frames,
                      "event_ms_per_step": ev_ms / frames,
                      "event_share_of_wall": ev_ms / wall_ms}
    return out


def mesh_event_share(run_once, frames: int = 3) -> dict:
    """The mesh contacts' time by CUDA events over ``frames`` unprofiled
    calls of ``run_once`` against their wall (the profiler stretches a
    step of ~37,000 kernels several times over), after one untimed call:
    the first frame after another path captures the mesh GJK's CUDA graph
    again (one graph is kept, ``narrow_phase.graph_call``)."""
    from wgmath_tpu_torch.queries import mesh_contact

    return event_shares(run_once, {"mesh": (
        mesh_contact, "append_mesh_contacts")}, frames)["mesh"]


def mesh_share(run_once, calls_per_step: float, frames: int = 1) -> dict:
    """The share of a frame's device and host time spent appending the
    mesh contacts (``mesh_contact.append_mesh_contacts``, a
    ``record_function`` range), with the range timed by CUDA events, and
    the profiled window's own figures under ``window``. The range's
    figures stand only where the profiled window counts ``calls_per_step``
    ranges a step (the count of the unprofiled frames,
    :func:`mesh_event_share`) and its device time is within the window's;
    else they read "not measured" with the reason."""
    from wgmath_tpu_torch.queries import mesh_contact

    shares = range_shares(run_once, mesh_contact,
                          {"mesh_contacts": "append_mesh_contacts"}, frames,
                          events=True)
    out = shares["mesh_contacts"]
    if not (out["calls_per_step"] == calls_per_step
            and out["device_share"] is not None
            and out["device_share"] <= 1.0):
        out = {"range": f"not measured (inconsistent: {out} against "
                        f"{calls_per_step} calls a step unprofiled)"}
    return dict(out, window=shares["window"])


# ---------------------------------------------------------------------------
# 2D: every 2D scene three frames from JAX's states, the 10k revolute net
# and the 10k box-and-ball pile (no port kernel: the JAX package's 2D
# frame is plain XLA, its Pallas sweep 3D only)
# ---------------------------------------------------------------------------

PLANAR_PATHS = ("net2d10k", "mix2d10k")
NET2D_SHAPE = (100, 100)  # 10,000 balls, 19,800 revolute joints
PLANAR_WARM = 3
PLANAR_TIMED = 5  # 10 until the scale-out phases (the time limit)
MIX2D_BODIES = 10_000
MIX2D_FRAMES = 120  # checked frames from the built state
MIX2D_EVERY = 10  # JAX's recording: one envelope every 10 frames
# the pile's deepest contact and 99th percentile of depths above JAX's, m
# (the H100 read up to 5.8 and 2.2 mm, PERF.md)
MIX2D_PEN_SLACK, MIX2D_P99_SLACK = 2e-2, 1e-2


def planar_envelopes(state) -> tuple[float, float]:
    """Kinetic-energy proxy (sum |v|^2) and the deepest live contact point
    of the state's last frame (its constraints), as the export records
    JAX's."""
    vel = state.bodies.vels.linear
    depth = contact_depths(state)
    return (float((vel * vel).sum()),
            max(float(depth.max()) if depth.numel() else 0.0, 0.0))


def planar_small_phase() -> dict:
    """Every stored 2D case of ``artifacts/planar_jax.npz.xz`` three
    frames on the card, each from JAX's state before it, held as on the
    CPU (``tests.planar_inputs.frame_ok``: counts exact and translations
    within 1e-5 m; on ``capsules2`` the bodies joined to JAX's C14 rows
    within 2e-2 m and the contacts JAX's rows with the witness's validity
    there, ROADMAP C14), no port kernel launched."""
    from tests.planar_inputs import (
        case_mode,
        config_of,
        frame_errors,
        frame_ok,
        params_of,
        planar_state,
        small_cases,
    )

    out = {}
    for case in small_cases():
        rows = []
        for f in range(3):
            st = planar_state(case, f, device="cuda")
            cfg = config_of(f"{case}.config_json" if f == 0
                            else f"{case}.ref.{f - 1}.config_json")
            for mod, attr in PIT_COUNTERS.values():
                setattr(mod, attr, 0)
            new, _ = step_checked(st, params_of(case_mode(case)), cfg)
            launched = {k: n for k, n in _pit_counts().items() if n}
            check(not launched, f"{case} frame {f}: port kernels "
                  f"{launched} launched on a 2D step")
            check(_finite(new), f"{case} frame {f}: non-finite state")
            m = frame_errors(case, f, st, new)
            check(frame_ok(m), f"{case} frame {f}: off JAX's frame {m}")
            rows.append(m)
        out[case] = rows
        print(f"planar {case}: {rows}")
    return out


def net2d_reference(params) -> tuple:
    """``joint_net2(100, 100)`` built on the card, three frames against
    JAX's (counts exact; the seeded sample within ``TRANSLATION_LIMITS``;
    the largest joint stretch within ``STRETCH_AGREE`` of JAX's at frame
    3). Returns (the state, its configuration, the frames' figures)."""
    from tests.planar_inputs import config_of, planar_arrays

    from wgmath_tpu_torch.scenes.builders import joint_net2

    z = planar_arrays()
    state = joint_net2(*NET2D_SHAPE, device="cuda")
    cfg = config_of("net.config_json")
    ids = torch.from_numpy(z["net.sample_ids"].astype(np.int64)).cuda()
    frames = []
    for f in range(3):
        t0 = time.perf_counter()
        state, cfg = step_checked(state, params, cfg)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ref = f"net.ref.{f}."
        pc = state.pair_count.cpu().numpy()
        err = float(np.abs(state.bodies.poses.translation[ids].cpu().numpy()
                           - z[ref + "sample"]).max())
        stretch = joint_stretch(state)
        rec = {"pair_count": pc[:5].tolist(),
               "jax_pair_count": z[ref + "pair_count"][:5].tolist(),
               "sample_max_dx": err, "stretch": stretch,
               "jax_stretch": float(z[ref + "stretch"]), "host_ms": 1e3 * dt}
        frames.append(rec)
        print(f"net2d10k reference frame {f}: {rec}")
        check(np.array_equal(pc, z[ref + "pair_count"]),
              f"net2d10k frame {f}: counts {pc[:5].tolist()} against JAX's")
        check(err <= TRANSLATION_LIMITS[f], f"net2d10k frame {f}: sample "
              f"off by {err:.3e}")
        check(_finite(state), f"net2d10k frame {f}: non-finite state")
    check(abs(frames[-1]["stretch"] - frames[-1]["jax_stretch"])
          <= STRETCH_AGREE, "net2d10k: the largest stretch after frame 3 "
          "is not JAX's within 1 mm")
    return state, cfg, frames


def mix2d_reference(params) -> tuple:
    """``boxes_and_balls(10_000, dim=2)`` built on the card,
    ``MIX2D_FRAMES`` checked frames: every pose finite, no dynamic centre
    below the ground's top; every ``MIX2D_EVERY`` frames the deepest
    contact at most JAX's + ``MIX2D_PEN_SLACK``, the 99th percentile of
    the contact depths at most JAX's + ``MIX2D_P99_SLACK``, the 90th at
    most JAX's + ``ENVELOPE_PEN_SLACK`` and the kinetic-energy proxy at
    most ``ENVELOPE_KE_FACTOR`` x JAX's + ``ENVELOPE_KE_SLACK`` (the
    bench's envelope gates). In this fall of a 100-layer column the
    deepest contact is one body's impact, as deep as its travel in the
    frame its contact is first seen (0.23 m in JAX's own run), so a
    rounding that moves that frame moves it by millimetres: hence the
    wider slacks of the deepest contact and the 99th percentile. Returns
    (the state, its configuration, the record)."""
    from tests.planar_inputs import config_of, planar_arrays

    from wgmath_tpu_torch.scenes.builders import boxes_and_balls

    z = planar_arrays()
    env = z["mix.envelope"]
    state = boxes_and_balls(MIX2D_BODIES, dim=2, device="cuda")
    cfg = config_of("mix.config_json")
    record = []
    t0 = time.perf_counter()
    for f in range(1, MIX2D_FRAMES + 1):
        state, cfg = step_checked(state, params, cfg)
        if f % MIX2D_EVERY:
            continue
        check(_finite(state), f"mix2d10k frame {f}: non-finite state")
        low = float(state.bodies.poses.translation[1:, 1].min())
        depth = contact_depths(state).cpu().numpy()
        ke = float((state.bodies.vels.linear ** 2).sum())
        j_f, j_ke, j_pen, j_p99, j_p90, j_mean, j_low = (
            float(x) for x in env[f // MIX2D_EVERY - 1])
        check(int(j_f) == f, "mix2d10k: the JAX record is out of step")
        pen = float(depth.max()) if depth.size else 0.0
        p99, p90, mean = ((float(np.percentile(depth, 99.0)),
                           float(np.percentile(depth, 90.0)),
                           float(depth.mean())) if depth.size
                          else (0.0, 0.0, 0.0))
        rec = {"frame": f, "ke": ke, "jax_ke": j_ke, "p90": p90,
               "jax_p90": j_p90, "pen": pen, "jax_pen": j_pen,
               "p99": p99, "jax_p99": j_p99, "mean": mean,
               "jax_mean": j_mean, "low": low, "jax_low": j_low,
               "pairs": int(state.pair_count[0]),
               "jax_pairs": int(z[f"mix.ref.{f}.pair_count"][0])}
        record.append(rec)
        check(low > 0.0, f"mix2d10k frame {f}: a centre at y = {low:.3f}, "
              "below the ground")
        check(pen <= j_pen + MIX2D_PEN_SLACK
              and p99 <= j_p99 + MIX2D_P99_SLACK
              and p90 <= j_p90 + ENVELOPE_PEN_SLACK
              and ke <= ENVELOPE_KE_FACTOR * j_ke + ENVELOPE_KE_SLACK,
              f"mix2d10k frame {f}: outside JAX's envelope {rec}")
    torch.cuda.synchronize()
    print(f"mix2d10k: {MIX2D_FRAMES} checked frames in "
          f"{time.perf_counter() - t0:.1f} s; every {MIX2D_EVERY}: "
          f"{record}")
    return state, cfg, record


def planar_phase() -> dict:
    """The 2D paths: the small scenes from JAX's states, then the 10k net
    and the 10k pile against JAX's, each timed (``PLANAR_WARM`` warm and
    ``PLANAR_TIMED`` timed frames, no port kernel launched)."""
    from tests.planar_inputs import params_of

    params = params_of("default")
    checks = {"small": planar_small_phase()}
    state, cfg, checks["net2d10k"] = net2d_reference(params)
    runs = {"net2d10k": run_path(
        "net2d10k", state, cfg, params, None, (), warm=PLANAR_WARM,
        timed=PLANAR_TIMED, envelopes=planar_envelopes)}
    state, cfg, checks["mix2d10k"] = mix2d_reference(params)
    runs["mix2d10k"] = run_path(
        "mix2d10k", state, cfg, params, None, (), warm=0,
        timed=PLANAR_TIMED, envelopes=planar_envelopes)
    for name in PLANAR_PATHS:
        runs[name]["params"] = params
    runs["planar_checks"] = checks
    return runs


def planar_shares(name: str, run_once) -> dict:
    """The 2D step's shares: the narrow phase (``pipeline.narrow_phase``)
    and, in it, the 2D SAT on the pile; the sweeps
    (``solver.gs_color_major_pass``, plain PyTorch in 2D); the joints'
    build and passes (``JointSolve``) on the net. ``unprofiled``: each
    range by CUDA events (:func:`event_shares`); ``profiled``: one
    profiled frame (:func:`range_shares`), a range's figures kept only
    where it counts the unprofiled calls a step and its device time lies
    within the window's (else "not measured" with the reason: a range
    counted twice, or a graph captured again in the window); ``window``:
    that frame's figures, as :func:`profile_window` gives them."""
    ranges = {"narrow": (pipeline_mod, "narrow_phase"),
              "solve_sweeps": (solver, "gs_color_major_pass")}
    if name == "mix2d10k":
        ranges["sat2d"] = (narrow_mod, "cuboid_cuboid_manifold_2d")
    if name == "net2d10k":
        ranges["joint_build"] = (solver.JointSolve, "build")
        ranges["joint_passes"] = (solver.JointSolve, "run")
    unprof = event_shares(run_once, ranges)
    prof = range_shares(run_once, None, ranges, 1, events=True)
    window = prof.pop("window")
    for label, fig in prof.items():
        calls = unprof[label]["calls_per_step"]
        if not (fig["calls_per_step"] == calls
                and fig["device_share"] is not None
                and fig["device_share"] <= 1.0):
            prof[label] = (f"not measured (inconsistent: {fig} against "
                           f"{calls} calls a step unprofiled)")
    return {"unprofiled": unprof, "profiled": prof, "window": window}


# ---------------------------------------------------------------------------
# scale-out: the sharded pipeline and the body-sharded step on ranks of one
# card (NCCL at world size 1, gloo at world size 2), and the testbed CLI
# ---------------------------------------------------------------------------

NPZ_PARALLEL = os.path.join(ROOT, "artifacts", "parallel_jax.npz.xz")
SHARD_FRAMES = 3  # checked frames from the settled state
SHARD_TIMED = 10
SHARD_TR_LIMIT = 1e-6  # against the single-device step
SHARD_WORLDS = ((1, "nccl"), (2, "gloo"))
TESTBED_FRAMES = 3
CONVEYOR_TR_LIMIT = 1e-5


def _pit_start() -> tuple:
    """The settled pit's state arrays and the stored ladder configuration
    with the JAX package's ladder frames."""
    z = dict(np.load(NPZ))
    arrays = {k: v for k, v in z.items() if k != "config_json"}
    zl = dict(np.load(NPZ_LADDER))
    cfg = PipelineConfig.from_dict(json.loads(str(zl["config_json"])))
    return arrays, cfg, zl


def _single_frames(arrays, cfg, params, frames: int, timed: int) -> dict:
    """The single-device ``step`` under a fixed configuration, as the
    sharded step runs: each frame's translations and counts, then
    ``timed`` frames on the host's clock after a sync."""
    state = state_from_arrays(arrays, device="cuda")
    out = {"translation": [], "pair_count": []}
    for _ in range(frames):
        state = step(state, params, cfg, warmstart=True)
        out["translation"].append(state.bodies.poses.translation.cpu()
                                  .numpy())
        out["pair_count"].append(state.pair_count.cpu().numpy())
    step(state, params, cfg, warmstart=True)
    torch.cuda.synchronize()
    s0 = dispatch.HOST_SYNCS
    b0 = gs_math.LAUNCHES_BLOCK
    t0 = time.perf_counter()
    for _ in range(timed):
        state = step(state, params, cfg, warmstart=True)
    torch.cuda.synchronize()
    out["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / timed
    out["host_syncs_per_step"] = (dispatch.HOST_SYNCS - s0) / timed
    out["b2_launches_per_step"] = (gs_math.LAUNCHES_BLOCK - b0) / timed
    return out


def sharded_pit_checks(label: str, res: list, single: dict, zl) -> dict:
    """One world size's ranks against the single-device frames and the
    JAX package's ladder frames; the ranks' states equal bit for bit."""
    r0 = res[0][0]
    for f in range(SHARD_FRAMES):
        digests = {r[0]["digest"][f] for r in res}
        check(len(digests) == 1, f"{label} frame {f}: the ranks' states "
              "differ")
    check(len({r[0]["timed"]["digest"] for r in res}) == 1,
          f"{label}: the ranks' states differ after the timed frames")
    dx = []
    for f in range(SHARD_FRAMES):
        pc, want = r0["pair_count"][f], single["pair_count"][f]
        check(list(pc[:2]) == list(want[:2]), f"{label} frame {f}: pairs / "
              f"contacts {list(pc[:2])}, single device {list(want[:2])}")
        d = float(np.abs(r0["translation"][f]
                         - single["translation"][f]).max())
        dx.append(d)
        check(d <= SHARD_TR_LIMIT, f"{label} frame {f}: translations "
              f"{d:.3e} m from the single-device step")
        ref_pc = zl[f"ref.{f}.pair_count"]
        rel = max(abs(int(pc[i]) - int(ref_pc[i])) / max(abs(int(
            ref_pc[i])), 1) for i in (0, 1))
        d_jax = float(np.abs(r0["translation"][f]
                             - zl[f"ref.{f}.translation"]).max())
        check(rel <= COUNT_REL_LIMIT and d_jax <= TRANSLATION_LIMITS[f],
              f"{label} frame {f}: off the JAX ladder frame (counts "
              f"{rel:.2e}, translations {d_jax:.3e})")
        print(f"{label} frame {f}: pairs {pc[0]} contacts {pc[1]} (single "
              f"device {want[0]} / {want[1]}, JAX {ref_pc[0]} / "
              f"{ref_pc[1]}), max|dx| {d:.3e} against the single device, "
              f"{d_jax:.3e} against JAX (limit {TRANSLATION_LIMITS[f]:.0e})")
    t = r0["timed"]
    check(t["b2_launches_per_step"] > 0, f"{label}: no B2 one-rung launch")
    print(f"{label}: {t['ms_per_step']:.2f} ms/step over {t['frames']} "
          f"frames (host clock after a sync), {t['collectives_per_step']:.1f}"
          f" collectives/step, {t['bytes_per_step'] / 1e6:.3f} MB/step, B2 "
          f"one-rung launches {t['b2_launches_per_step']:.1f}/step, host "
          f"syncs {t['host_syncs_per_step']:.2f}/step; single-device ladder "
          f"{single['ms_per_step']:.2f} ms/step")
    return {"max_dx_vs_single": dx, **{k: v for k, v in t.items()
                                       if k != "digest"}}


def round1_pit_check(res: list, arrays, cfg, params) -> dict:
    """The body-sharded step's frame: finite, its pair count the brute
    force's on the same state, padded as ``shard_state`` pads it (the
    10,005 bodies to 10,006 at world size 2: a static zero-radius ball at
    the origin, which touches the ground's box, as in the JAX package)."""
    from wgmath_tpu_torch.broad_phase.brute_force import find_pairs_partial
    from wgmath_tpu_torch.core.collectives import Shard
    from wgmath_tpu_torch.parallel.sharded import shard_state

    state = state_from_arrays(arrays, device="cuda")
    n = state.bodies.num_bodies
    tr = np.concatenate([r[1]["translation"] for r in res])[:n]
    check(bool(np.isfinite(tr).all()), "round-1 step: non-finite poses")
    blocks = [shard_state(state, Shard(None, len(res), k))
              for k in range(len(res))]
    poses = Sim(*(torch.cat([getattr(b.poses, f) for b, _ in blocks])
                  for f in ("rotation", "translation", "scale")))
    shapes = blocks[0][1]
    mins, maxs = shp.world_aabbs(shapes, poses,
                                 margin=params.prediction_distance)
    radii = shp.ball_radii_or_nan(shapes, poses)
    brute = find_pairs_partial(mins, maxs, 0, mins, maxs,
                               capacity=cfg.pair_capacity,
                               block=cfg.broad_phase_block,
                               max_per_row=cfg.broad_phase_max_per_row,
                               ball_radius=radii,
                               margin=params.prediction_distance)
    counts = {r[1]["pair_count"] for r in res}
    check(counts == {int(brute.count)}, f"round-1 step: pair counts "
          f"{counts}, brute force {int(brute.count)}")
    print(f"round-1 body-sharded step at world size {len(res)} (gloo): "
          f"{counts.pop()} pairs (the brute force's on the padded "
          f"{mins.shape[0]} bodies), finite, {res[0][1]['ms']:.1f} ms on "
          "rank 0")
    return {"pairs": int(brute.count), "ms": res[0][1]["ms"]}


def _b2_args(rec, device="cuda") -> tuple[tuple, dict]:
    """A recorded B2 launch's arguments back on ``device``."""
    args, kw, _ = rec
    win, meta, view, *rest = args
    view = SimpleNamespace(**{k: v.to(device) for k, v in view.items()})
    return ((win.to(device), meta, view) + tuple(x.to(device)
                                                 for x in rest)), kw


def b2_slice_check(res: list) -> dict:
    """B2's one-rung launches as the sharded pit runs them: each rank's
    launches of the first frame's first sweep, recorded inside the ranks
    (``tests/parallel_ranks.py``, ``record_b2``), rank k's slice of a rung
    of m rows being ``[k·l, (k+1)·l)`` with l = m over the rank count,
    rounded up (``solver._sweep_torch``). Each recorded launch is launched
    again on its own inputs (the recorded bits) and held against its plain
    version (max abs error, the kernel's tolerance); the ranks' inputs of
    a rung, put together, are the whole rung's, whose one launch gives
    every rank's rows bit for bit. Rank 0's launches are timed one by one,
    beside their plain versions and bounds."""
    n = len(res)
    rung_rows = res[0][0]["b2_rungs"]
    check(len(rung_rows) > 0 and all(r[0]["b2_rungs"] == rung_rows
                                     for r in res),
          f"B2 rungs recorded by rank: {[r[0]['b2_rungs'] for r in res]}")
    recs = [iter(r[0]["b2_calls"]) for r in res]
    err, rows, k_ms, p_ms, b_ms = 0.0, [], [], [], []
    for i, m in enumerate(rung_rows):
        lw = -(-m // n)
        parts = []
        for k in range(n):
            lo = min(k * lw, m)
            hi = min(lo + lw, m)
            if hi > lo:
                rec = next(recs[k], None)
                check(rec is not None and rec[0][0].shape[0] == hi - lo,
                      f"B2 rung {i} rank {k}: no launch of {hi - lo} rows")
                parts.append((k, rec, _b2_args(rec)))
        outs = []
        for k, rec, (args, kw) in parts:
            got = gs_math.gs_math_block(*args, **kw)
            plain = gs_block_plain(*args, **kw)
            for g, want, q in zip(got, rec[2], plain):
                check(torch.equal(g.cpu(), want), f"B2 rung {i} rank {k}: "
                      "not the bits the rank launched")
                err = max(err, float((g - q).abs().max()))
                check(bool(torch.allclose(g, q, rtol=RTOL, atol=ATOL)),
                      f"B2 rung {i} rank {k}: off its plain version")
            outs.append(got)
        (win, meta, view, *_), kw = parts[0][2]
        cat = [torch.cat(xs) for xs in zip(*(
            (a[0],) + tuple(a[3:]) for _, _, (a, _) in parts))]
        v = SimpleNamespace(**{f: torch.cat([getattr(a[2], f)
                                             for _, _, (a, _) in parts])
                               for f in vars(view)})
        whole = gs_math.gs_math_block(cat[0], meta, v, *cat[1:], **kw)
        for j, w in enumerate(whole):
            check(torch.equal(torch.cat([o[j] for o in outs]), w),
                  f"B2 rung {i}: the ranks' rows are not the whole rung's")
        args, kw = parts[0][2]
        rows.append(args[0].shape[0])
        k_ms.append(statistics.median(device_times_ms(
            lambda: gs_math.gs_math_block(*args, **kw))))
        p_ms.append(statistics.median(device_times_ms(
            lambda: gs_block_plain(*args, **kw), n=5)))
        b_ms.append(bound_ms(*gs_block_work(rows[-1], kw["p_max"]))[0])
    check(all(next(it, None) is None for it in recs),
          "B2: launches recorded beyond the sweep's rungs")
    out = {
        "rungs": rung_rows, "rank0_rows": rows,
        "max_abs_err_vs_plain": err,
        "ms_per_launch": sum(k_ms) / len(k_ms),
        "plain_ms_per_launch": sum(p_ms) / len(p_ms),
        "bound_ms_per_launch": sum(b_ms) / len(b_ms),
        "ms_per_sweep_rank0": sum(k_ms), "plain_ms_per_sweep_rank0":
            sum(p_ms), "bound_ms_per_sweep_rank0": sum(b_ms),
        "bound_by": bound_ms(*gs_block_work(max(rows), kw["p_max"]))[1]}
    print(f"B2 one-rung on the sharded pit's slices ({n} ranks, the first "
          f"sweep's rungs {rung_rows}, rank 0's rows {rows}): the recorded "
          f"bits, the whole rung's bits; rank 0's launches "
          f"{out['ms_per_launch'] * 1e3:.2f} us each on average (plain "
          f"{out['plain_ms_per_launch'] * 1e3:.2f} us, bound "
          f"{out['bound_ms_per_launch'] * 1e3:.3f} us, {out['bound_by']}), "
          f"a sweep {out['ms_per_sweep_rank0']:.4f} ms (plain "
          f"{out['plain_ms_per_sweep_rank0']:.4f}, bound "
          f"{out['bound_ms_per_sweep_rank0']:.4f} ms), max abs err "
          f"{err:.3e} against the plain version")
    return out


def parallel_phase(params) -> dict:
    """The settled pit under the ``ladder`` configuration, stepped by
    ranks of ``parallel.sharded_pipeline`` (NCCL at world size 1, gloo at
    world size 2 with both ranks on the card, spawned by
    ``tests/parallel_ranks.py``): ``SHARD_FRAMES`` frames against the
    single-device step and the JAX ladder frames, the ranks' bits equal
    every frame, then ``SHARD_TIMED`` timed frames; and one frame of the
    round-1 body-sharded step at world size 2."""
    from tests.parallel_ranks import run_ranks

    arrays, cfg, zl = _pit_start()
    single = _single_frames(arrays, cfg, params, SHARD_FRAMES, SHARD_TIMED)
    print(f"single-device ladder (step, fixed configuration): "
          f"{single['ms_per_step']:.2f} ms/step over {SHARD_TIMED} frames, "
          f"B2 {single['b2_launches_per_step']:.1f} launches/step, "
          f"{single['host_syncs_per_step']:.2f} host syncs/step")
    pipeline_job = ("pipeline", dict(arrays=arrays, params=params, config=cfg,
                                     frames=SHARD_FRAMES, timed=SHARD_TIMED))
    out = {"single": {k: v for k, v in single.items()
                      if k not in ("translation", "pair_count")}}
    for world, backend in SHARD_WORLDS:
        jobs = [pipeline_job]
        if world == 2:
            jobs = [(pipeline_job[0], dict(pipeline_job[1], record_b2=True))]
            jobs.append(("round1", dict(arrays=arrays, params=params,
                                        config=cfg)))
        t0 = time.perf_counter()
        try:
            res = run_ranks(jobs, world, backend, device="cuda")
        except RuntimeError as e:
            raise SmokeFailure(str(e))
        label = f"sharded pit ({backend}, world size {world})"
        out[f"{backend}{world}"] = sharded_pit_checks(label, res, single, zl)
        out[f"{backend}{world}"]["wall_s"] = time.perf_counter() - t0
        if world == 2:
            out["b2_slices"] = b2_slice_check(res)
            out["round1"] = round1_pit_check(res, arrays, cfg, params)
    return out


def testbed_phase(params) -> dict:
    """The testbed CLI as a user runs it: every scene ``TESTBED_FRAMES``
    checked frames on the card with ``--verify --json``, ``conveyor3`` on
    the oracle backend, and ``conveyor3`` three frames against the JAX
    package's frames."""
    from wgmath_tpu_torch.scenes.builders import SCENES
    from wgmath_tpu_torch.testbed.runner import BackendConfig

    env = dict(os.environ, PYTHONPATH=ROOT)
    cli = [sys.executable, "-m", "wgmath_tpu_torch.testbed.runner"]
    t0 = time.perf_counter()
    proc = subprocess.run(cli + ["--run-all", "--frames",
                                 str(TESTBED_FRAMES), "--verify", "--json"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    run_all_s = time.perf_counter() - t0
    check(proc.returncode == 0, "testbed --run-all failed: "
          + proc.stderr[-2000:])
    lines = [json.loads(x) for x in proc.stdout.splitlines()
             if x.startswith("{")]
    check([x["scene"] for x in lines] == list(SCENES),
          f"testbed --run-all gave {len(lines)} scenes")
    for x in lines:
        check(x["counters"]["steps"] == TESTBED_FRAMES and x["finite"],
              f"testbed {x['scene']}: {x}")
    ms = {x["scene"]: round(x["phase_ms"].get("step", 0.0)
                            / max(TESTBED_FRAMES - 1, 1), 2) for x in lines}
    print(f"testbed --run-all --frames {TESTBED_FRAMES} --verify --json: "
          f"{len(lines)} scenes, every pose finite, {run_all_s:.1f} s; "
          f"ms/step {ms}")
    t0 = time.perf_counter()
    proc = subprocess.run(cli + ["--example", "conveyor3", "--backend",
                                 "oracle", "--frames", "5"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    check(proc.returncode == 0 and "steps" in proc.stdout,
          "testbed --backend oracle failed: " + proc.stderr[-2000:])
    oracle_s = time.perf_counter() - t0
    z = load_arrays(NPZ_PARALLEL)
    st = SCENES["conveyor3"](device="cuda")
    prm = SimParams.tgs_soft()
    cfg = BackendConfig().pipeline_config(
        manifold_points=pipeline_mod.auto_manifold_points(st.shapes, 3))
    dx = []
    for f in range(3):
        st, cfg = step_checked(st, prm, cfg)
        tr = st.bodies.poses.translation.cpu().numpy()
        dx.append(float(np.abs(tr - z[f"conveyor3.frame{f}.translation"])
                        .max()))
        pc = st.pair_count.cpu().numpy()
        check(list(pc[:2]) == list(z[f"conveyor3.frame{f}.pair_count"][:2])
              and dx[-1] <= CONVEYOR_TR_LIMIT,
              f"conveyor3 frame {f}: counts {list(pc[:2])}, max|dx| "
              f"{dx[-1]:.3e} against JAX's")
    print(f"conveyor3 on the card against JAX's frames: max|dx| {dx} "
          f"(limit {CONVEYOR_TR_LIMIT:.0e}), counts exact; the oracle "
          f"backend {oracle_s:.1f} s for 5 frames")
    return {"run_all_s": run_all_s, "ms_per_step": ms, "conveyor3_dx": dx,
            "oracle_s": oracle_s}


KERNEL_TABLE = (
    ("gs_math_rhs", "chained_ps", "wgmath_tpu_torch/csrc/gs_math.cu",
     "wgmath_tpu/dynamics/gs_pallas.py:330",
     "dynamics/gs_pallas.py:_gs_math_rhs_pallas_call"),
    ("gs_math_block", "ladder", "wgmath_tpu_torch/csrc/gs_math_block.cu",
     "wgmath_tpu/dynamics/gs_pallas.py:246",
     "dynamics/gs_pallas.py:_gs_math_pallas_call"),
    ("build_fused", "fused", "wgmath_tpu_torch/csrc/build_fused.cu",
     "wgmath_tpu/dynamics/build_pallas.py:234",
     "dynamics/build_pallas.py:_build_pallas_call"),
    ("fused_sweep", "fused", "wgmath_tpu_torch/csrc/gs_fused.cu",
     "wgmath_tpu/dynamics/gs_fused.py:320",
     "dynamics/gs_fused.py:_fused_sweep_pallas"),
    ("fused_substep1", "fused", "wgmath_tpu_torch/csrc/gs_fused.cu",
     "wgmath_tpu/dynamics/gs_fused.py:448",
     "dynamics/gs_fused.py:_substep1_pallas"),
    ("fused_integrate", "fused", "wgmath_tpu_torch/csrc/gs_fused.cu",
     "wgmath_tpu/dynamics/gs_fused.py:582",
     "dynamics/gs_fused.py:fused_integrate"),
)
# a kernel whose main-path launches another counter counts: B12, carried
# by B10's opening on the fused path
PATH_COUNTER = {"fused_integrate": "fused_integrate_in_sweep"}
# name, route, source, file:line of the pallas_call, TPU function, and the
# path whose launch count is the kernel's `launches`
LINALG_KERNEL_TABLE = (
    ("gemm", "cuda", "wgmath_tpu_torch/csrc/gemm.cu",
     "wgmath_tpu/ops/gemm.py:196", "ops/gemm.py:_gemm_pallas",
     "gemm4096_highest"),
    ("gemm_split", "cuda", "wgmath_tpu_torch/csrc/gemm_split.cu",
     "wgmath_tpu/ops/gemm.py:302", "ops/gemm.py:gemm_split",
     "gemm_split4096_6"),
    ("reduce", "cuda", "wgmath_tpu_torch/csrc/reduce.cu",
     "wgmath_tpu/ops/reduce.py:74", "ops/reduce.py:_reduce_pallas",
     "graph2048"),
    ("op_assign", "triton", "wgmath_tpu_torch/ops/elementwise.py",
     "wgmath_tpu/ops/elementwise.py:54",
     "ops/elementwise.py:op_assign_pallas", "op_assign2048"),
    ("gemv", "cuda", "wgmath_tpu_torch/csrc/gemv.cu",
     "wgmath_tpu/ops/gemv.py:70", "ops/gemv.py:_gemv_pallas", "gemv4096"),
    ("gemv_tr", "cuda", "wgmath_tpu_torch/csrc/gemv.cu",
     "wgmath_tpu/ops/gemv.py:110", "ops/gemv.py:_gemv_tr_pallas",
     "gemv_tr4096"),
)
CONFIGS = ("chained_ps", "ladder", "chained", "chained_rr", "fused",
           "chained_ss")


def _pit_stepper(state, cfg, params):
    """One checked frame per call, carrying the state along."""
    box = [state, cfg]

    def one():
        box[0], box[1] = step_checked(box[0], params, box[1])

    return one


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on a "
              "GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    try:
        setup = setup_phase()
        t_setup = time.perf_counter()
        ladders = {}
        for name, path in (("chained_ps", NPZ), ("ladder", NPZ_LADDER)):
            cfg0 = json.loads(str(np.load(path)["config_json"]))
            ladders[name] = tuple(cfg0["gs_windows"][:cfg0["max_colors"]])
        summaries = sweep_phase(kernel_phase(ladders))
        zf = np.load(NPZ_FUSED)
        cfg_f = json.loads(str(zf["config_json"]))
        summaries.update(fused_kernel_phase(cfg_f, [
            int(x) for x in zf["ref.0.pair_count"][
                8:8 + cfg_f["max_colors"] + 2]]))
        summaries.update(linalg_kernel_phase())
        t_kernels = time.perf_counter()
        linalg_paths = linalg_path_phase()
        linalg_paths.update(gemv_path_phase())
        query_paths = geometry_path_phase()
        query_paths.update(ray_path_phase())
        t_q = time.perf_counter()
        decomps = decomp_phase()
        t_decomp = time.perf_counter()
        params = SimParams()
        t0 = time.perf_counter()
        runs = path_phase()
        t1 = time.perf_counter()
        runs.update(box_phase(params))
        box_kernel_checks(runs, params, summaries)
        t2 = time.perf_counter()
        runs.update(primitives_phase(params))
        primitives_kernel_checks(runs, params, summaries)
        t3 = time.perf_counter()
        runs.update(solve_modes_phase(params, runs))
        solve_modes_kernel_checks(runs, params, summaries)
        t4 = time.perf_counter()
        runs.update(joints_phase())
        joints_kernel_checks(runs, params, summaries)
        t5 = time.perf_counter()
        runs.update(lbvh_phase(params))
        t6 = time.perf_counter()
        runs.update(mesh_phase(params))
        mesh_kernel_checks(runs, params, summaries)
        t7 = time.perf_counter()
        runs.update(planar_phase())
        t8 = time.perf_counter()
        runs["parallel"] = parallel_phase(params)
        t9 = time.perf_counter()
        runs["testbed"] = testbed_phase(params)
        t10 = time.perf_counter()
        examples = examples_phase()
        print(f"phase seconds: setup {t_setup - t_start:.1f}, kernels "
              f"{t_kernels - t_setup:.1f}, linalg and query paths "
              f"{t_q - t_kernels:.1f}, small-matrix geometry "
              f"{t_decomp - t_q:.1f}, pit paths (with chained_ss) "
              f"{t1 - t0:.1f}, box "
              f"{t2 - t1:.1f}, primitives {t3 - t2:.1f}, solve modes "
              f"{t4 - t3:.1f}, joints {t5 - t4:.1f}, lbvh {t6 - t5:.1f}, "
              f"meshes {t7 - t6:.1f}, planar {t8 - t7:.1f}, parallel "
              f"{t9 - t8:.1f}, testbed {t10 - t9:.1f}, examples "
              f"{time.perf_counter() - t10:.1f}")
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    paths = {}
    step_paths = (CONFIGS + tuple(BOX_PATHS) + tuple(PRIM_PATHS)
                  + tuple(SOLVE_PATHS) + tuple(JOINT_PATHS)
                  + tuple(NET_MODE_PATHS) + ("pit_lbvh",)
                  + tuple(MESH_PATHS) + PLANAR_PATHS)
    profile_s = {}
    for name in step_paths:
        t_prof = time.perf_counter()
        paths[name] = runs[name]["metrics"]
        stepper = _pit_stepper(*runs[name]["end"],
                               runs[name].get("params", params))
        if name in NET_MODE_PATHS:
            # the net's untimed modes: ms/step and launches only
            paths[name]["profile"] = "not profiled (an untimed mode)"
            continue
        if name == "quickstart_jacobi":
            # ~33,000 eager ops a step take ~40 s under the profiler:
            # the earlier profile in PERF.md stands, ms/step is timed above
            paths[name]["profile"] = "not profiled (the run's time limit)"
            continue
        # a 10k primitives step is ~40,000 kernels, a mesh step ~37,000, a
        # 10k net step ~10,000 (~7 s under the profiler): one frame a
        # window but for the pit's five configurations; each share (a
        # range in a profiled window of its own) one frame
        frames = 3 if name in CONFIGS else 1
        try:
            if name in MESH_PATHS:
                # one profiled frame gives the step's figures and the
                # mesh contacts' range (~40,000 kernels a step)
                unprof = mesh_event_share(stepper)
                paths[name]["mesh_unprofiled"] = unprof
                paths[name]["mesh"] = mesh_share(
                    stepper, unprof["calls_per_step"], 1)
                prof = paths[name]["mesh"].pop("window")
            elif name in PLANAR_PATHS:
                # the shares' profiled frame is the step's window
                paths[name]["shares"] = planar_shares(name, stepper)
                prof = paths[name]["shares"].pop("window")
            else:
                prof = profile_window(stepper, frames)
            paths[name]["profile"] = prof
            # the profiler stretches the step: the busy share of the
            # timed, unprofiled step is kernel time over that step
            paths[name]["device_busy_share"] = (
                prof["device_ms_per_step"] / paths[name]["ms_per_step"])
            if name in BOX_PATHS:
                paths[name]["sat"] = sat_share(stepper, 1)
                print(f"{name}: {paths[name]['ms_per_step']:.2f} ms/step, "
                      f"device {prof['device_ms_per_step']:.3f} ms/step, "
                      f"{prof['kernels_per_step']:.1f} kernels/step, busy "
                      f"{paths[name]['device_busy_share']:.3f}; SAT "
                      f"{paths[name]['sat']}")
            if name in PRIM_PATHS:
                m = paths[name]
                m["pfm"] = pfm_share(stepper, 1)
                print(f"{name}: {m['ms_per_step']:.2f} ms/step, device "
                      f"{prof['device_ms_per_step']:.3f} ms/step, "
                      f"{prof['kernels_per_step']:.1f} kernels/step, "
                      f"{m['host_syncs_per_step']:.2f} host syncs/step, busy "
                      f"{m['device_busy_share']:.3f}, support-mapped pairs "
                      f"{m['pfm_pairs_per_frame']}, EPA demand "
                      f"{m['epa_demand_per_frame']} (cap 256), peak "
                      f"{m['peak_mem_gb']:.3f} GB; PFM {m['pfm']}")
            if name in SOLVE_PATHS:
                m = paths[name]
                if name != "quickstart_jacobi":
                    m["coloring"] = color_share(stepper, 1)
                print(f"{name}: {m['ms_per_step']:.2f} ms/step, device "
                      f"{prof['device_ms_per_step']:.3f} ms/step, "
                      f"{prof['kernels_per_step']:.1f} kernels/step, "
                      f"{m['host_syncs_per_step']:.2f} host syncs/step, B2 "
                      f"{m['gs_math_block_launches_per_step']:.2f} "
                      f"launches/step, busy {m['device_busy_share']:.3f}, "
                      f"peak {m['peak_mem_gb']:.3f} GB; colouring "
                      f"{m.get('coloring', 'none (no colours)')}")
            if name in JOINT_PATHS or name == "pit_lbvh":
                m = paths[name]
                if name in JOINT_PATHS:
                    m["joints"] = joint_share(stepper, 1)
                    expect = JOINT_PATHS[name][1]
                else:
                    expect = ("gs_math_rhs",)
                per_kernel = ", ".join(
                    f"{k} {m[k + '_launches_per_step']:.2f}" for k in expect)
                print(f"{name}: {m['ms_per_step']:.2f} ms/step, device "
                      f"{prof['device_ms_per_step']:.3f} ms/step, "
                      f"{prof['kernels_per_step']:.1f} kernels/step, "
                      f"{m['host_syncs_per_step']:.2f} host syncs/step, "
                      f"launches/step: {per_kernel}, busy "
                      f"{m['device_busy_share']:.3f}, peak "
                      f"{m['peak_mem_gb']:.3f} GB, bp_path mix "
                      f"{m['bp_path_mix']}; joints "
                      f"{m.get('joints', 'none')}")
            if name in PLANAR_PATHS:
                m = paths[name]
                print(f"{name}: {m['ms_per_step']:.2f} ms/step, device "
                      f"{prof['device_ms_per_step']:.3f} ms/step, "
                      f"{prof['kernels_per_step']:.1f} kernels/step, "
                      f"{m['host_syncs_per_step']:.2f} host syncs/step, "
                      f"B1 {m['gs_math_rhs_launches_per_step']:.2f} B2 "
                      f"{m['gs_math_block_launches_per_step']:.2f} "
                      f"launches/step, busy {m['device_busy_share']:.3f}, "
                      f"peak {m['peak_mem_gb']:.3f} GB; shares "
                      f"{m['shares']}")
            if name in MESH_PATHS:
                m = paths[name]
                print(f"{name}: {m['ms_per_step']:.2f} ms/step, device "
                      f"{prof['device_ms_per_step']:.3f} ms/step, "
                      f"{prof['kernels_per_step']:.1f} kernels/step, "
                      f"{m['host_syncs_per_step']:.2f} host syncs/step, B2 "
                      f"{m['gs_math_block_launches_per_step']:.2f} "
                      f"launches/step, busy {m['device_busy_share']:.3f}, "
                      f"peak {m['peak_mem_gb']:.3f} GB, cluster rounds a "
                      f"frame {m.get('cluster_rounds_per_frame')}; mesh "
                      f"contacts {m['mesh_unprofiled']} (unprofiled), "
                      f"{m['mesh']} (profiled)")
        except Exception as e:  # the profiler is untried on this machine
            paths[name]["profile"] = (f"not measured ({type(e).__name__}: "
                                      f"{e})")
        profile_s[name] = round(time.perf_counter() - t_prof, 1)
    ss, ps = paths["chained_ss"], paths["chained_ps"]
    print("chained_ss beside chained_ps: " + "; ".join(
        f"{k} " + " / ".join(
            (f"{m[k]:.3f}" if k in m else
             f"{m['profile'][k]:.3f}" if isinstance(m["profile"], dict)
             else "not measured") for m in (ss, ps))
        for k in ("ms_per_step", "device_ms_per_step", "kernels_per_step",
                  "host_syncs_per_step", "gs_math_rhs_launches_per_step")))
    print(f"profile seconds: {profile_s}; chip_smoke so far "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"paths": paths, "linalg_paths": linalg_paths,
                      "query_paths": query_paths, "gates": runs["gates"],
                      "box_jax_frames": runs["jax_frames"],
                      "box_checks": runs["box_checks"],
                      "prim_jax_frames": runs["prim_jax_frames"],
                      "prim_checks": runs["prim_checks"],
                      "solve_jax_frames": runs["solve_jax_frames"],
                      "solve_checks": runs["solve_checks"],
                      "joint_jax_frames": runs["joint_jax_frames"],
                      "fused_joint_jax_frames":
                          runs["fused_joint_jax_frames"],
                      "joint_checks": runs["joint_checks"],
                      "lbvh_checks": runs["lbvh_checks"],
                      "mesh_checks": runs["mesh_checks"],
                      "planar_checks": runs["planar_checks"],
                      "parallel": runs["parallel"],
                      "testbed": runs["testbed"],
                      "static_slots": runs["chained_ss"]["static"],
                      "decomp": decomps, "examples": examples}))
    print(setup["nvidia_smi"])
    kernels = []
    for name, path, source, replaces, tpu_source in KERNEL_TABLE:
        m, summary = paths[path], summaries[name]
        counter = PATH_COUNTER.get(name, name)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "tpu_source": tpu_source,
            "launches": m["launches"][counter],
            "launches_per_step": m[f"{counter}_launches_per_step"],
            "launches_by_path": {c: paths[c]["launches"][counter]
                                 for c in step_paths},
            **({"standalone_launches": m["launches"][name]}
               if counter != name else {}),
            **({"sharded_one_rung_launches_per_step": {
                w: runs["parallel"][w]["b2_launches_per_step"]
                for w in ("nccl1", "gloo2")}}
               if name == "gs_math_block" else {}),
            **({"static_slots_launches_per_step":
                paths["chained_ss"]["gs_math_rhs_launches_per_step"]}
               if name == "gs_math_rhs" else {}),
            "max_abs_err": summary["max_abs_err"], "ms": summary["ms"],
            "plain_ms": summary["plain_ms"],
            "bound_ms": summary["bound_ms"],
            "bound_by": summary["bound_by"], "library_ms": None,
            "work": summary["work"],
            **{k: v for k, v in summary.items() if k not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "work")},
        })
    for name, route, source, replaces, tpu_source, path in \
            LINALG_KERNEL_TABLE:
        summary = summaries[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "tpu_source": tpu_source,
            "launches": linalg_paths[path]["launches"][name],
            "launches_by_path": {p: m["launches"][name]
                                 for p, m in linalg_paths.items()},
            **summary,
        })
    for k in kernels:
        check(k["launches"] > 0, f"kernel {k['name']} was launched no time "
              "on its main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
