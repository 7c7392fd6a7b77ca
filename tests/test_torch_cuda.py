"""The port on the card: each CUDA or Triton kernel against its plain
PyTorch version, and the port's own step on the card against the same step
on the CPU.

These tests need a CUDA device and skip without one. They import no JAX,
so the machine with the card runs them without the repository's conftest::

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import dataclasses
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (
    B9_FIELD_ATOL,
    B9_FIELD_RTOL,
    B9_PAD_ATOL,
    B9_PAD_RTOL,
    GEMM_TOL,
    GEMV_SHAPES,
    GEMV_TOL,
    INTEGRATE_ATOL,
    INTEGRATE_RTOL,
    NPZ,
    NPZ_FUSED,
    NPZ_LADDER,
    NPZ_LBVH_FUSED,
    NPZ_MESH,
    NPZ_PRIMITIVES,
    NPZ_SOLVE_MODES,
    NPZ_STATIC,
    OP_ASSIGN_RTOL,
    PRIM_FAR_ATOL,
    PRIM_NEAR_SHARE,
    REDUCE_TOL,
    b9_args,
    box_arrays,
    box_build_call,
    box_fused_calls,
    box_state,
    box_sweeps,
    carrying_integrate,
    redirect_op,
    elementwise_ops,
    fused_calls,
    fused_inputs,
    fused_operands,
    fused_trace,
    gemm_ops,
    gemv_case_operands,
    gemv_ops,
    gs_block_inputs,
    gs_block_plain,
    gs_math_inputs,
    joints_case_config,
    joints_case_params,
    joints_case_state,
    jointed_fused_calls,
    mesh10k_pipeline_config,
    mesh10k_scene,
    mesh_small_cases,
    standalone_checks,
    pit_build_call,
    pit_fused_calls,
    pit_sweeps,
    prim_counts_match,
    record_sweeps,
    ray_bench_arrays,
    run_fused,
    run_recorded,
    synthetic_sweep,
    synthetic_windowless_sweep,
    ray_scene,
    reduce_ops,
    sweep_trace,
    traced_sweep_kernels,
)
from wgmath_tpu_torch.core.module import compile_check
from wgmath_tpu_torch.convert import state_from_arrays
from wgmath_tpu_torch.dynamics import build_fused, gs_fused, gs_math
from wgmath_tpu_torch.dynamics.constraint import update_rhs_sorted
from wgmath_tpu_torch.geometry.sim import Sim
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked
from wgmath_tpu_torch.pipeline import step as solver_step
from wgmath_tpu_torch.queries import ray

# the JAX package's tolerance for this math (tests/test_physics.py)
RTOL, ATOL = 1e-4, 1e-5


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [128, 1000, 5504])
@pytest.mark.parametrize("p_max", [1, 4])
@pytest.mark.parametrize("mode", ["biased", "unbiased"])
def test_gs_math_kernel_matches_plain_on_card(mode, p_max, L):
    _need_card()
    args, kw = gs_math_inputs(np.random.default_rng(L + p_max), L, p_max,
                              mode, "cuda")
    launches = gs_math.LAUNCHES
    got = gs_math.gs_math_block_rhs(*args, **kw)
    want = gs_math._gs_math_rhs_torch(*args, **kw)
    torch.cuda.synchronize()
    assert gs_math.LAUNCHES == launches + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [128, 1000, 4096])
@pytest.mark.parametrize("p_max", [1, 4])
def test_gs_math_block_kernel_matches_plain_on_card(p_max, L):
    _need_card()
    args, kw = gs_block_inputs(np.random.default_rng(L + p_max), L, p_max,
                               "cuda")
    launches = gs_math.LAUNCHES_BLOCK
    got = gs_math.gs_math_block(*args, **kw)
    want = gs_block_plain(*args, **kw)
    torch.cuda.synchronize()
    assert gs_math.LAUNCHES_BLOCK == launches + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    # an inactive row returns its previous impulses bit for bit
    off = ~args[3]
    assert torch.equal(got[0][off], args[6][off])
    assert torch.equal(got[1][off], args[7][off])


@pytest.mark.cuda
@pytest.mark.parametrize("p_max", [1, 4])
def test_rhs_in_rung_equals_rhs_passed_in_bit_for_bit(p_max):
    """The rhs rebuilt inside ``gs_math.cu`` and the rhs that
    ``update_rhs_sorted`` hands to ``gs_math_block.cu`` are the same bits
    (so ``chained_rr`` and ``ladder`` are one trajectory on the card):
    ``update_rhs_sorted`` sums its dot products in the kernel's order, which
    a ``torch.sum`` reduction on the card does not."""
    _need_card()
    L = 4096
    args, kw = gs_math_inputs(np.random.default_rng(p_max), L, p_max,
                              "biased", "cuda")
    win, meta, num_points, active, p1, p2, prev_n, prev_t = args
    out_rr = gs_math.gs_math_block_rhs(*args, **kw)
    pose = torch.cat([kw["pose1"], kw["pose2"]])
    idx = torch.arange(L, device="cuda")
    ss = SimpleNamespace(body_a=idx, body_b=idx + L,
                         **gs_math._fields(win, meta))
    inv_dt, erp_inv_dt, allowed, max_corr, cfm = kw["consts"]
    n_rhs, n_rhs_wo, t_rhs = update_rhs_sorted(
        ss, Sim(pose[:, :4], pose[:, 4:7], pose[:, 7]),
        SimpleNamespace(inv_dt=inv_dt, contact_erp_inv_dt=erp_inv_dt,
                        allowed_linear_error=allowed,
                        max_corrective_velocity=max_corr))
    view = SimpleNamespace(
        cfm_factor=torch.full((L,), cfm, device="cuda"), n_rhs=n_rhs,
        t_rhs=t_rhs, num_points=num_points)
    out = gs_math.gs_math_block(win, meta, view, active, p1[:, :6],
                                p2[:, :6], prev_n, prev_t, p_max=p_max,
                                s_len=2)
    torch.cuda.synchronize()
    assert torch.equal(n_rhs_wo, out_rr[4])
    for got, want in zip(out, out_rr[:4]):
        assert torch.equal(got, want)


# --- B1 / B2 over whole sweeps: one launch, rungs ordered by readiness ---

SWEEP_CASES = ("pit-chained_ps-biased", "pit-chained_ps-unbiased",
               "pit-ladder-biased", "pyr6-ladder-biased",
               "pyr6-ladder-unbiased", "p4-chained-biased",
               "p4-chained-unbiased", "p4-chained", "p4-ladder",
               "uniform-p1", "uniform-p4", "split-p1", "split-p4",
               "ss-balls-biased", "ss-balls-unbiased")
# the split windows of the synthetic windowless sweeps: colours past
# SPLIT_AT sweep TAIL_ROWS rows, fewer than their classes hold
SPLIT_AT, TAIL_ROWS = 4, 96
_SWEEPS = {}


@pytest.fixture
def sweep(request):
    """A recorded sweep on the card: the first substep of the settled 10k
    pit's first frame (``chained_ps``: B1 biased and unbiased; the ladder:
    B2), of the warmed ``pyramid(6)``'s first frame under the ladder (B2
    at P = 4), ``chip_smoke.synthetic_sweep`` at P = 4, or B2 on a
    seeded windowless plan (``chip_smoke.synthetic_windowless_sweep``):
    uniform windows, or split ones with truncated tail rungs; or B1 on the
    static pair slots' plan (``ss-``: ``balls(256)`` from the JAX package's
    warmed state under ``chained_ss``, its rungs at the ladder's fixed
    offsets)."""
    _need_card()
    name = request.param
    if name not in _SWEEPS:
        if name.startswith("ss-"):
            state, cfg = _static_balls("cuda")
            calls = record_sweeps(lambda: step_checked(state, SimParams(),
                                                       cfg), 2)
            _SWEEPS["ss-balls-biased"] = calls[0]
            _SWEEPS["ss-balls-unbiased"] = calls[1]
        elif name.startswith("pyr6-"):
            calls = box_sweeps("cuda")
            _SWEEPS["pyr6-ladder-biased"] = calls[0]
            _SWEEPS["pyr6-ladder-unbiased"] = calls[1]
        elif name.startswith("pit-"):
            for path, tag in ((NPZ, "chained_ps"), (NPZ_LADDER, "ladder")):
                calls = pit_sweeps(path, "cuda")
                _SWEEPS[f"pit-{tag}-biased"] = calls[0]
                _SWEEPS[f"pit-{tag}-unbiased"] = calls[1]
        elif name.startswith(("uniform-", "split-")):
            split = name.startswith("split-")
            _SWEEPS[name] = synthetic_windowless_sweep(
                np.random.default_rng(len(name) + 3), int(name[-1]),
                device="cuda", tail_window=TAIL_ROWS if split else 0,
                split=SPLIT_AT)
        else:
            chained = "chained" in name
            mode = name.split("-")[2] if name.count("-") == 2 else None
            _SWEEPS[name] = synthetic_sweep(
                np.random.default_rng(len(name)), 4, chained=chained,
                rhs_mode=mode, device="cuda")
    return _SWEEPS[name]


def _counter(call):
    return "LAUNCHES" if call.kw.get("rhs_mode") else "LAUNCHES_BLOCK"


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", SWEEP_CASES, indirect=True)
def test_sweep_is_one_launch_and_equals_rung_by_rung_bit_for_bit(sweep):
    """One launch for the whole sweep, ordered by the readiness flags,
    gives the bits of the same kernel launched once per rung (ordered by
    the launch boundaries)."""
    counter = _counter(sweep)
    n0 = getattr(gs_math, counter)
    got = run_recorded(sweep, "kernel")
    assert getattr(gs_math, counter) == n0 + 1
    rungs = run_recorded(sweep, "rungs")
    torch.cuda.synchronize()
    assert getattr(gs_math, counter) == n0 + 1 + sum(
        1 for r in sweep.plan.rungs if r.rows)
    for g, r in zip(got, rungs):
        assert torch.equal(g, r)
    assert not torch.equal(got[1], sweep.imp)  # the impulses moved


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", SWEEP_CASES, indirect=True)
def test_sweep_matches_the_plain_sweep_on_card(sweep):
    got = run_recorded(sweep, "kernel")
    want = run_recorded(sweep, "plain")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", SWEEP_CASES, indirect=True)
def test_sweep_repeats_bitwise_on_card(sweep):
    """The order in which blocks take their chunks and meet their flags
    changes from launch to launch; the result does not."""
    first = run_recorded(sweep, "kernel")
    for _ in range(20):
        again = run_recorded(sweep, "kernel")
        assert all(torch.equal(f, a) for f, a in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", SWEEP_CASES, indirect=True)
def test_sweep_writes_only_what_its_rungs_own(sweep):
    """Rows no rung runs (window slots past their class, the residue,
    padding) keep their impulses bit for bit; so do the rows a rung runs
    but finds inactive, in their impulse columns; the buffer changes only
    in the rows some side writes."""
    buf, imp = run_recorded(sweep, "kernel")
    torch.cuda.synchronize()
    plan = sweep.plan
    sides = plan.sides.cpu().numpy()
    run = np.zeros(imp.shape[0], bool)
    active = np.zeros(imp.shape[0], bool)
    for r in plan.rungs:
        rows = slice(r.start, r.start + r.rows)
        run[rows] = True
        active[rows] = sides[2 * r.w_off:2 * r.w_off + r.rows, 3] & 1
    p_max = sweep.kw["p_max"]
    cols = p_max * (1 + sweep.kw["s_len"])
    rest = torch.from_numpy(~run).cuda()
    idle = torch.from_numpy(run & ~active).cuda()
    assert torch.equal(imp[rest], sweep.imp[rest])
    assert torch.equal(imp[idle, :cols], sweep.imp[idle, :cols])
    written = np.zeros(buf.shape[0], bool)
    written[sides[:, 1][sides[:, 1] >= 0]] = True
    keep = torch.from_numpy(~written).cuda()
    assert torch.equal(buf[keep], sweep.buf[keep])


@pytest.mark.cuda
def test_traced_sweep_build_gives_the_untraced_bits_on_card():
    """B1 and B2 built with ``-DWG_SWEEP_TRACE=1`` (what
    ``scripts/exp_sweep_trace.py`` reads) compile, give the untraced
    build's bits, and leave five ordered marks for every row a sweep
    runs."""
    _need_card()
    rng = np.random.default_rng(8)
    calls = [synthetic_sweep(rng, 1, chained=True, rhs_mode="biased",
                             device="cuda"),
             synthetic_sweep(rng, 1, chained=False, rhs_mode=None,
                             device="cuda")]
    want = [run_recorded(c, "kernel") for c in calls]
    with traced_sweep_kernels():
        for call, w in zip(calls, want):
            got = run_recorded(call, "kernel")
            torch.cuda.synchronize()
            assert all(torch.equal(g, x) for g, x in zip(got, w))
            marks = sweep_trace(call)
            run = np.concatenate([2 * r.w_off + np.arange(r.rows)
                                  for r in call.plan.rungs])
            m = marks[run].astype(np.int64)
            assert (m > 0).all() and (np.diff(m, axis=1) >= 0).all()
    got = run_recorded(calls[0], "kernel")  # untraced again
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, want[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("sweep", ["uniform-p4", "split-p4"], indirect=True)
def test_windowless_plan_is_one_rung_a_colour_on_card(sweep, request):
    """A windowless plan holds one rung a colour, its sides sized by the
    rows it runs; the split plan's tail rungs stop at the tail window,
    short of their classes, where the uniform plan's run whole."""
    split = request.node.callspec.params["sweep"].startswith("split-")
    rungs = sweep.plan.rungs
    assert all(r.window == r.rows > 0 for r in rungs)
    colours = [r.colour for r in rungs]
    assert colours == sorted(set(colours))
    assert sweep.plan.sides.shape[0] == 2 * sum(r.rows for r in rungs)
    tail = [r.rows for r in rungs if r.colour > SPLIT_AT]
    if split:
        assert max(tail) == TAIL_ROWS
    else:
        assert max(tail) > TAIL_ROWS


@pytest.mark.cuda
def test_quickstart_frames_on_card_match_cpu():
    """Two checked frames of the README's quick start from the warmed
    ``pyramid(6)`` (colouring in the solve, uniform windows, 4-point
    manifolds) on the card and on the CPU: the same integers, poses to
    float32 reordering; on the card two B2 launches a substep."""
    _need_card()
    with np.load(NPZ_SOLVE_MODES) as z:
        arrays = {k[len("pyramid6.warmed."):]: z[k] for k in z.files
                  if k.startswith("pyramid6.warmed.")}
        cfg0 = PipelineConfig.from_dict(json.loads(str(
            z["pyramid6.config_json"])))
    out = {}
    for dev in ("cpu", "cuda"):
        state, cfg = state_from_arrays(arrays, device=dev), cfg0
        n0 = gs_math.LAUNCHES_BLOCK
        for _ in range(2):
            state, cfg = step_checked(state, SimParams(), cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert gs_math.LAUNCHES_BLOCK - n0 == 2 * 2 * 4
        out[dev] = (state, cfg)
    (sc, cc), (sg, cg) = out["cpu"], out["cuda"]
    assert cc == cg
    for a, b in ((sg.pair_count, sc.pair_count),
                 (sg.prev_colors, sc.prev_colors),
                 (sg.prev_constraints.body_a, sc.prev_constraints.body_a)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.numpy())
    np.testing.assert_allclose(
        sg.bodies.poses.translation.cpu().numpy(),
        sc.bodies.poses.translation.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("path", [NPZ, NPZ_LADDER], ids=["chained_ps",
                                                         "ladder"])
def test_pit_step_launches_one_kernel_per_sweep_on_card(path):
    """A frame of the settled 10k pit makes two sweep launches a substep
    (biased and unbiased) of B1 (``chained_ps``) or B2 (the ladder)."""
    _need_card()
    z = dict(np.load(NPZ))
    cfg = PipelineConfig.from_dict(
        json.loads(str(np.load(path)["config_json"])))
    state = state_from_arrays(z, device="cuda")
    counter = "LAUNCHES" if cfg.gs_rhs_in_rung else "LAUNCHES_BLOCK"
    params = SimParams()
    for _ in range(2):
        n0 = getattr(gs_math, counter)
        state = solver_step(state, params, cfg)
        torch.cuda.synchronize()
        assert getattr(gs_math, counter) - n0 == \
            2 * params.num_solver_iterations


@pytest.mark.cuda
@pytest.mark.parametrize("path", [NPZ, NPZ_LADDER, NPZ_FUSED],
                         ids=["chained_ps", "ladder", "fused"])
def test_pit10k_frames_on_card_match_cpu(path):
    """Two frames of the settled 10k pit (a full refresh with a Luby
    recolour, then a cache hit) on the card and on the CPU, under the
    stored ``chained_ps``, ``ladder`` and ``fused`` configurations: sorts,
    scans, scatter-mins and the colouring give the same integers; poses
    agree to float32 reordering."""
    _need_card()
    z = dict(np.load(NPZ))
    cfg0 = PipelineConfig.from_dict(
        json.loads(str(np.load(path)["config_json"])))
    out = {}
    for dev in ("cpu", "cuda"):
        state, cfg = state_from_arrays(z, device=dev), cfg0
        for _ in range(2):
            state, cfg = step_checked(state, SimParams(), cfg)
        out[dev] = (state, cfg)
    (sc, cc), (sg, cg) = out["cpu"], out["cuda"]
    assert cc == cg
    np.testing.assert_array_equal(sg.pair_count.cpu().numpy(),
                                  sc.pair_count.numpy())
    np.testing.assert_array_equal(sg.bp_colors[0].cpu().numpy(),
                                  sc.bp_colors[0].numpy())
    for f in ("body_a", "body_b", "valid"):
        np.testing.assert_array_equal(
            getattr(sg.bp_pairs, f).cpu().numpy(),
            getattr(sc.bp_pairs, f).numpy())
    np.testing.assert_allclose(
        sg.bodies.poses.translation.cpu().numpy(),
        sc.bodies.poses.translation.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ladder", "fused"])
def test_box_frames_on_card_match_cpu(name):
    """Two frames of the warmed ``pyramid(6)`` (4-point cuboid manifolds)
    on the card and on the CPU: the same integers, poses to float32
    reordering."""
    _need_card()
    out = {}
    for dev in ("cpu", "cuda"):
        state, cfg = box_state("pyramid6", name, dev)
        for _ in range(2):
            state, cfg = step_checked(state, SimParams(), cfg)
        out[dev] = (state, cfg)
    (sc, cc), (sg, cg) = out["cpu"], out["cuda"]
    assert cc == cg
    np.testing.assert_array_equal(sg.pair_count.cpu().numpy(),
                                  sc.pair_count.numpy())
    for f in ("body_a", "body_b", "valid", "num_points"):
        np.testing.assert_array_equal(
            getattr(sg.prev_constraints, f).cpu().numpy(),
            getattr(sc.prev_constraints, f).numpy())
    assert sg.prev_constraints.n_impulse.shape[1] == 4
    np.testing.assert_allclose(
        sg.bodies.poses.translation.cpu().numpy(),
        sc.bodies.poses.translation.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("sat_capacity", [0, 1024, 64])
def test_sat_narrow_phase_on_card_matches_cpu(sat_capacity):
    """The narrow phase's cuboid-cuboid branch (plain tensor code) over the
    warmed ``pyramid(6)``'s cached pairs, dense, compacted and past its
    capacity, on the card and on the CPU: the same counts and manifold
    widths; normals, points and depths to 1e-6 (the card's float32
    arithmetic is IEEE, each op rounded as on the CPU)."""
    _need_card()
    from wgmath_tpu_torch.queries.narrow_phase import narrow_phase

    out = {}
    for dev in ("cpu", "cuda"):
        state, _ = box_state("pyramid6", "ladder", dev)
        out[dev] = narrow_phase(state.bodies.poses, state.shapes,
                                state.bp_pairs,
                                SimParams().prediction_distance, p_max=4,
                                sat_capacity=sat_capacity)
    (cc, nc), (cg, ng) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(ng.cpu().numpy(), nc.numpy())
    if sat_capacity:
        assert int(nc[1]) > 64
    for f in ("valid", "num_points"):
        np.testing.assert_array_equal(getattr(cg, f).cpu().numpy(),
                                      getattr(cc, f).numpy())
    assert int(cc.num_points.max()) == 4
    for f in ("normal_a", "points_a", "dist"):
        torch.testing.assert_close(getattr(cg, f).cpu(), getattr(cc, f),
                                   rtol=1e-6, atol=1e-6)


def _prim_state(name, dev):
    """``primitives3(40)`` as the JAX package warmed it under ``name``:
    (state on ``dev``, configuration)."""
    z = box_arrays(NPZ_PRIMITIVES, f"primitives3.{name}.")
    return (state_from_arrays(box_arrays(
        NPZ_PRIMITIVES, f"primitives3.{name}.state."), device=dev),
        PipelineConfig.from_dict(json.loads(str(z["config_json"]))))


PFM_VARIANTS = {"dense": (4, 0), "compacted": (4, 4096),
                "past_capacity": (4, 64), "p_max1": (1, 4096)}


def _pfm_narrow(dev, p_max, cap, state=None):
    from wgmath_tpu_torch.queries.narrow_phase import narrow_phase

    state = state or _prim_state("ladder", dev)[0]
    return narrow_phase(state.bodies.poses, state.shapes, state.bp_pairs,
                        SimParams().prediction_distance, p_max=p_max,
                        sat_capacity=1024, bc_capacity=256,
                        pfm_capacity=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(PFM_VARIANTS))
def test_pfm_narrow_phase_on_card_matches_cpu(variant):
    """The narrow phase's support-mapped branch (GJK, EPA and the clip,
    plain tensor code, as a CUDA graph on the card) over the warmed
    ``primitives3(40)``'s cached pairs, dense, compacted, past its capacity
    and at ``p_max`` 1, on the card and on the CPU: the same demands,
    counts and validity; normals, points and depths to 1e-6 (the card's
    float32 arithmetic is IEEE and the port writes out every sum and the
    square roots correctly rounded on both)."""
    _need_card()
    p_max, cap = PFM_VARIANTS[variant]
    (cc, nc), (cg, ng) = (_pfm_narrow(dev, p_max, cap)
                          for dev in ("cpu", "cuda"))
    np.testing.assert_array_equal(ng.cpu().numpy(), nc.numpy())
    if variant == "past_capacity":
        assert int(nc[2]) > 64
    for f in ("valid", "num_points"):
        np.testing.assert_array_equal(getattr(cg, f).cpu().numpy(),
                                      getattr(cc, f).numpy())
    for f in ("normal_a", "points_a", "dist"):
        torch.testing.assert_close(getattr(cg, f).cpu(), getattr(cc, f),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.cuda
def test_gjk_fixed_loop_gives_the_same_bits_at_32_and_64_on_card():
    """GJK's sync-free form on the card (a fixed loop, no host read) on
    ``tests/test_torch_gjk.py``'s pairs of every band and on
    ``tests/test_torch_mesh.py``'s triangle pairs: 32 and 64 iterations
    give the same bits, so a lane retired within 32 is frozen as JAX's
    early exit leaves it; the overlap flags are the CPU's."""
    _need_card()
    from tests.test_torch_gjk import NPZ as NPZ_GJK, _pair_args
    from tests.test_torch_mesh import _tri_args
    from wgmath_tpu_torch.queries import gjk

    def card(x):
        if isinstance(x, Sim):
            return Sim(*(y.cuda() for y in (x.rotation, x.translation,
                                            x.scale)))
        return x.cuda()

    with np.load(NPZ_GJK) as f:
        pairs = _pair_args(dict(f))
    tri_args, tri, hull = _tri_args()
    cases = ((pairs, {}), (tri_args, {"vertices": hull.vertices,
                                      "tri_verts_a": tri}))
    for args, kw in cases:
        on_card = [card(a) for a in args]
        kw_card = {k: v.cuda() for k, v in kw.items()}
        a, b = (gjk.gjk_distance(*on_card, max_iters=n, **kw_card)
                for n in (32, 64))
        for k in vars(a):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
        cpu = gjk.gjk_distance(*args, **kw)
        assert torch.equal(a.intersecting.cpu(), cpu.intersecting)


@pytest.mark.cuda
def test_pfm_graph_replays_give_the_eager_bits_on_card(monkeypatch):
    """The support-mapped kernel's CUDA graph, captured on one state and
    replayed on another, gives the bits of the eager run of each; a batch
    of another shape replaces the graph of its (device, p_max,
    prediction) and gives the eager bits too."""
    _need_card()
    from wgmath_tpu_torch.queries import narrow_phase as narrow_mod

    first = _prim_state("ladder", "cuda")[0]
    later = state_from_arrays(box_arrays(
        NPZ_PRIMITIVES, "primitives3.ladder.ref.1.state."), device="cuda")
    runs = ((first, 4096), (later, 4096), (first, 4096), (later, 2048))
    with monkeypatch.context() as m:
        m.setattr(narrow_mod, "_pfm_call", narrow_mod._pfm)
        eager = [_pfm_narrow("cuda", 4, cap, st) for st, cap in runs]
    narrow_mod._GRAPHS.clear()
    graphed = [_pfm_narrow("cuda", 4, cap, st) for st, cap in runs]
    for (e, ne), (g, ng) in zip(eager, graphed):
        assert torch.equal(ne, ng)
        for f in ("normal_a", "points_a", "dist", "num_points", "valid"):
            assert torch.equal(getattr(e, f), getattr(g, f)), f
    assert not torch.equal(eager[0][0].dist, eager[1][0].dist)
    assert len(narrow_mod._GRAPHS) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ladder", "fused"])
def test_primitive_frames_on_card_match_cpu(name):
    """Two frames of the warmed ``primitives3(40)`` on the card and on the
    CPU: the same configuration and counts, but a contact an unsettled
    f32 GJK / EPA pair gains or loses (``chip_smoke.prim_counts_match``);
    at least ``PRIM_NEAR_SHARE`` of the bodies within 1e-5 m and all within
    ``PRIM_FAR_ATOL`` (the card's sweeps add in another order than the
    plain sweep, and GJK / EPA carry an ulp into another simplex)."""
    _need_card()
    out = {}
    for dev in ("cpu", "cuda"):
        state, cfg = _prim_state(name, dev)
        for _ in range(2):
            state, cfg = step_checked(state, SimParams(), cfg)
        out[dev] = (state, cfg)
    (sc, cc), (sg, cg) = out["cpu"], out["cuda"]
    assert cc == cg
    assert prim_counts_match(sg.pair_count.cpu().numpy(),
                             sc.pair_count.numpy())
    assert sg.prev_constraints.n_impulse.shape[1] == 4
    dx = (sg.bodies.poses.translation.cpu()
          - sc.bodies.poses.translation).abs().amax(-1)
    assert float((dx <= 1e-5).float().mean()) >= PRIM_NEAR_SHARE
    assert float(dx.max()) <= PRIM_FAR_ATOL


# --- the fused solver: B9 - B12 ---------------------------------------------


def _fused_case(p_max, seed=5):
    """Inputs of the four fused kernels on the card (chip_smoke's layout: a
    proper colouring, a residue, empty colours), B9's matrix from
    its plain version."""
    rng = np.random.default_rng(seed + p_max)
    counts = [40] + [int(x) for x in rng.integers(0, 257, 12)]
    counts[-2:] = [0, 0]
    z = fused_inputs(rng, 2000, (256,) * 12, 64, counts, p_max, "cuda")
    meta, k_all = build_fused.field_meta(p_max, 2)
    params = SimParams()
    consts = (params.restitution, params.inv_dt, params.friction,
              params.contact_cfm_factor)
    packed = build_fused._packed_bodies(z["poses"], z["vels"], z["mprops"])
    b9 = (packed, z["contacts"], consts, meta, k_all, p_max)
    big = build_fused._build_torch(*b9)
    return z, b9, fused_operands(z, big, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("p_max", [1, 4])
def test_build_fused_kernel_matches_plain_on_card(p_max):
    _need_card()
    z, b9, _ = _fused_case(p_max)
    launches = build_fused.LAUNCHES
    got = build_fused.build_constraints_fused(
        z["poses"], z["vels"], z["mprops"], z["contacts"], SimParams())[1]
    want = build_fused._build_torch(*b9)
    torch.cuda.synchronize()
    assert build_fused.LAUNCHES == launches + 1
    live = z["contacts"].valid
    for f, (at, tail) in b9[3].items():
        rows = slice(at, at + (int(np.prod(tail)) if tail else 1))
        w = want[rows][:, live]
        tol = 1e-5 + 2e-6 * float(w.abs().max())
        assert float((got[rows][:, live] - w).abs().max()) <= tol, f


def _strided(contacts):
    """``contacts`` with its float fields as the compaction leaves them:
    column views of one matrix [C, 3 + 4P]."""
    c = contacts.capacity
    big = torch.cat([contacts.normal_a, contacts.points_a.reshape(c, -1),
                     contacts.dist], dim=1)
    p_max = contacts.points_a.shape[1]
    return dataclasses.replace(
        contacts, normal_a=big[:, :3],
        points_a=big[:, 3:3 + 3 * p_max].reshape(c, p_max, 3),
        dist=big[:, 3 + 3 * p_max:])


def _b9_case_args(case):
    if case in ("pit", "pyr6"):
        call = (pit_build_call if case == "pit" else box_build_call)("cuda")
        poses, vels, mprops, contacts, params = call.args
        return b9_args(dict(p_max=contacts.points_a.shape[1], poses=poses,
                            vels=vels, mprops=mprops, contacts=contacts),
                       params)
    z, b9, _ = _fused_case(int(case[1:]))
    return (b9[0], _strided(z["contacts"])) + b9[2:]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["p1", "p4", "pit", "pyr6"])
def test_build_fused_reads_strided_contact_fields_in_place_on_card(case):
    """B9 on the contact fields as strided views of one matrix (the pit's
    and the warmed ``pyramid(6)``'s at P = 4: as their compaction made
    them) reads them in place: the bits of B9 on
    contiguous copies, its plain version within chip_smoke's B9
    tolerances, live columns and rung padding alike."""
    _need_card()
    args = _b9_case_args(case)
    c = args[1]
    assert not c.normal_a.is_contiguous() and not c.points_a.is_contiguous()
    copies = dataclasses.replace(c, normal_a=c.normal_a.contiguous(),
                                 points_a=c.points_a.contiguous(),
                                 dist=c.dist.contiguous())
    assert args[0].shape[1] == build_fused.W_SIDE == 32
    launches = build_fused.LAUNCHES
    got = build_fused._launch(*args)
    want = build_fused._launch(args[0], copies, *args[2:])
    plain = build_fused._build_torch(*args)
    torch.cuda.synchronize()
    assert build_fused.LAUNCHES == launches + 2
    assert torch.equal(got, want)
    live = c.valid
    assert (~live).any()
    for f, (at, tail) in args[3].items():
        rows = slice(at, at + (int(np.prod(tail)) if tail else 1))
        w = plain[rows][:, live]
        tol = B9_FIELD_ATOL + B9_FIELD_RTOL * float(w.abs().max())
        assert float((got[rows][:, live] - w).abs().max()) <= tol, f
    torch.testing.assert_close(got[:, ~live], plain[:, ~live],
                               rtol=B9_PAD_RTOL, atol=B9_PAD_ATOL)


@pytest.mark.cuda
def test_build_fused_kernel_refuses_a_field_it_cannot_read_in_place():
    """A contact field whose innermost stride is not 1 raises, and nothing
    is launched: no silent copy."""
    _need_card()
    z, b9, _ = _fused_case(1)
    c = z["contacts"]
    wide = torch.zeros((c.capacity, 6), device="cuda")
    wide[:, 0::2] = c.normal_a
    bad = dataclasses.replace(c, normal_a=wide[:, 0::2])
    launches = build_fused.LAUNCHES
    with pytest.raises(ValueError, match="stride"):
        build_fused._launch(b9[0], bad, *b9[2:])
    assert build_fused.LAUNCHES == launches


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["kernel", "colours"])
@pytest.mark.parametrize("p_max", [1, 4])
def test_fused_sweep_carrying_integrate_on_card(p_max, how):
    """B10 carrying B12 (one launch, or the same kernel colour by colour):
    its velocities and impulses B10's without it, bit for bit; its poses a
    fresh tensor with the standalone B12's bits, and the plain version's
    within chip_smoke's B12 tolerance; counted as one carried integrate,
    no standalone B12."""
    _need_card()
    z, _, op = _fused_case(p_max)
    sweep = fused_calls(z, op)[0]
    call = carrying_integrate(sweep, op)
    n0 = (gs_fused.INTEGRATES_IN_SWEEP, gs_fused.LAUNCHES_INTEGRATE)
    got = run_fused(call, how)
    assert (gs_fused.INTEGRATES_IN_SWEEP, gs_fused.LAUNCHES_INTEGRATE) == \
        (n0[0] + 1, n0[1])
    alone = run_fused(sweep, how)
    standalone = gs_fused.fused_integrate(op["pose"], op["vt"], op["com"],
                                          op["dt"])
    want = gs_fused._cm_integrate(op["pose"], op["vt"], op["com"], op["dt"])
    torch.cuda.synchronize()
    assert len(got) == 4 and len(alone) == 3
    assert all(torch.equal(g, a) for g, a in zip(got[:3], alone))
    assert got[3].data_ptr() not in (op["pose"].data_ptr(),
                                     op["vt"].data_ptr(),
                                     got[0].data_ptr())
    assert torch.equal(got[3], standalone)
    torch.testing.assert_close(got[3], want, rtol=INTEGRATE_RTOL,
                               atol=INTEGRATE_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("p_max", [1, 4])
@pytest.mark.parametrize("kernel", ["fused_sweep", "fused_substep1"])
def test_fused_sweep_kernels_match_plain_and_repeat_bitwise_on_card(
        kernel, p_max):
    _need_card()
    z, _, op = _fused_case(p_max)
    kw = dict(windows=z["windows"], rung0=z["rung0"], p_max=p_max, s_len=2,
              meta=op["meta"])
    if kernel == "fused_sweep":
        args = (op["vt"], op["n_imp"], op["t_imp"], op["win"], op["active"],
                op["nump"], 1.0, op["n_rhs"], op["t_rhs"], op["idx"],
                op["inv"])
        fn, plain, counter = (gs_fused.fused_sweep,
                              gs_fused._fused_sweep_torch, "LAUNCHES_SWEEP")
    else:
        args = (op["vt"], op["n_imp"], op["t_imp"], op["win"], op["src"],
                op["pose"], op["active"], op["nump"], op["idx"], op["inv"])
        kw.update(src_meta=op["src_meta"], scalars=op["scalars"])
        fn, plain, counter = (gs_fused.fused_substep1,
                              gs_fused._substep1_torch, "LAUNCHES_SUBSTEP1")
    launches = getattr(gs_fused, counter)
    got = fn(*args, z["counts"], **kw)
    again = fn(*args, z["counts"], **kw)
    want = plain(*args, z["counts"].cpu(), **kw)
    torch.cuda.synchronize()
    assert getattr(gs_fused, counter) == launches + 2
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_fused_integrate_kernel_matches_plain_on_card():
    _need_card()
    _, _, op = _fused_case(1)
    launches = gs_fused.LAUNCHES_INTEGRATE
    got = gs_fused.fused_integrate(op["pose"], op["vt"], op["com"], op["dt"])
    want = gs_fused._cm_integrate(op["pose"], op["vt"], op["com"], op["dt"])
    torch.cuda.synchronize()
    assert gs_fused.LAUNCHES_INTEGRATE == launches + 1
    torch.testing.assert_close(got, want, rtol=INTEGRATE_RTOL,
                               atol=INTEGRATE_ATOL)


@pytest.mark.cuda
def test_fused_wrappers_never_run_their_plain_versions_on_card(monkeypatch):
    """On CUDA tensors the four wrappers launch their kernels: with every
    plain version made to raise, they still return."""
    _need_card()
    z, _, op = _fused_case(1)

    def refuse(*a, **k):
        raise AssertionError("plain version called on the card")

    for mod, name in ((build_fused, "_cm_build"),
                      (build_fused, "_build_torch"),
                      (gs_fused, "_fused_sweep_plain"),
                      (gs_fused, "_fused_sweep_torch"),
                      (gs_fused, "_substep1_torch"),
                      (gs_fused, "_cm_integrate")):
        monkeypatch.setattr(mod, name, refuse)
    kw = dict(windows=z["windows"], rung0=z["rung0"], p_max=1, s_len=2,
              meta=op["meta"])
    build_fused.build_constraints_fused(z["poses"], z["vels"], z["mprops"],
                                        z["contacts"], SimParams())
    gs_fused.fused_sweep(op["vt"], op["n_imp"], op["t_imp"], op["win"],
                         op["active"], op["nump"], 1.0, op["n_rhs"],
                         op["t_rhs"], op["idx"], op["inv"], z["counts"], **kw)
    vt = gs_fused.fused_substep1(
        op["vt"], op["n_imp"], op["t_imp"], op["win"], op["src"], op["pose"],
        op["active"], op["nump"], op["idx"], op["inv"], z["counts"],
        src_meta=op["src_meta"], scalars=op["scalars"], **kw)[0]
    gs_fused.fused_integrate(op["pose"], vt, op["com"], op["dt"])
    gs_fused.fused_sweep(vt, op["n_imp"], op["t_imp"], op["win"],
                         op["active"], op["nump"], 1.0, op["n_rhs"],
                         op["t_rhs"], op["idx"], op["inv"], z["counts"],
                         integrate=(op["pose"], op["com"], op["dt"]), **kw)
    torch.cuda.synchronize()


# --- B10 / B11: one launch, colours ordered by readiness flags -------------

FUSED_CASES = tuple(f"{layout}-{kernel}"
                    for layout in ("p1", "p4", "pit", "pyr6")
                    for kernel in ("fused_sweep", "fused_substep1")) + (
    "net16j-fused_sweep", "net16j-fused_sweep_unbiased")
_FUSED = {}


@pytest.fixture
def fused_call(request):
    """A B10 or B11 call on the card: ``_fused_case``'s synthetic layouts
    at P = 1 and 4 (a residue, empty colours), or the first substep of the
    settled 10k pit's first frame under the stored ``fused``
    configuration, or of the warmed ``pyramid(6)``'s first frame (P = 4);
    or B10 launched alone on a jointed plan, the biased and the unbiased
    sweep of ``ball_net3(16, 16)``'s first substep under the fused solver
    (``net16j``, :func:`chip_smoke.jointed_fused_calls`)."""
    _need_card()
    name = request.param
    if name not in _FUSED:
        layout, kernel = name.split("-")
        if layout == "net16j":
            biased, unbiased = jointed_fused_calls("cuda")
            _FUSED["net16j-fused_sweep"] = biased
            _FUSED["net16j-fused_sweep_unbiased"] = unbiased
        elif layout in ("pit", "pyr6"):
            calls = (pit_fused_calls if layout == "pit"
                     else box_fused_calls)("cuda")
            for call in calls:
                _FUSED[f"{layout}-{call.name}"] = call
        else:
            z, _, op = _fused_case(int(layout[1:]))
            for call in fused_calls(z, op):
                _FUSED[f"{layout}-{call.name}"] = call
    return _FUSED[name]


def _fused_counter(call):
    return {"fused_sweep": "LAUNCHES_SWEEP",
            "fused_substep1": "LAUNCHES_SUBSTEP1"}[call.name]


@pytest.mark.cuda
@pytest.mark.parametrize("fused_call", FUSED_CASES, indirect=True)
def test_fused_one_launch_equals_colour_by_colour_bit_for_bit(fused_call):
    """One launch, its colours ordered by the readiness flags, gives the
    bits of the same kernel launched for the opening and then once a
    colour (ordered by the launch boundaries)."""
    counter = _fused_counter(fused_call)
    n0 = getattr(gs_fused, counter)
    got = run_fused(fused_call, "kernel")
    assert getattr(gs_fused, counter) == n0 + 1
    colours = run_fused(fused_call, "colours")
    torch.cuda.synchronize()
    assert getattr(gs_fused, counter) == n0 + 2 + len(fused_call.kw[
        "windows"])
    for g, c in zip(got, colours):
        assert torch.equal(g, c)
    assert not torch.equal(got[0], fused_call.args[0])  # velocities moved


@pytest.mark.cuda
@pytest.mark.parametrize("fused_call", FUSED_CASES, indirect=True)
def test_fused_kernel_matches_its_plain_version_on_card(fused_call):
    got = run_fused(fused_call, "kernel")
    want = run_fused(fused_call, "plain")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("fused_call", FUSED_CASES, indirect=True)
def test_fused_kernel_repeats_bitwise_on_card(fused_call):
    """The order in which blocks take their chunks and meet their flags
    changes from launch to launch; the result does not."""
    first = run_fused(fused_call, "kernel")
    for _ in range(20):
        again = run_fused(fused_call, "kernel")
        assert all(torch.equal(f, a) for f, a in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("fused_call", FUSED_CASES, indirect=True)
def test_fused_padding_rows_keep_their_impulses_on_card(fused_call):
    """The rung padding (and any inactive row) returns its impulses as it
    got them (B11: scaled by the warmstart coefficient), whatever it
    read."""
    got = run_fused(fused_call, "kernel")
    torch.cuda.synchronize()
    substep = fused_call.name == "fused_substep1"
    active = fused_call.args[6 if substep else 4][0] > 0.5
    scale = fused_call.kw["scalars"][0] if substep else 1.0
    assert (~active).any()
    for out, imp in ((got[1], fused_call.args[1]),
                     (got[2], fused_call.args[2])):
        assert torch.equal(out[:, ~active], (imp * scale)[:, ~active])


@pytest.mark.cuda
def test_traced_fused_build_gives_the_untraced_bits_on_card():
    """B10 and B11 built with ``-DWG_SWEEP_TRACE=1`` (what
    ``scripts/exp_sweep_trace.py`` reads) give the untraced build's bits
    and leave five ordered marks for every active row of an occupied
    colour."""
    _need_card()
    z, _, op = _fused_case(1)
    calls = fused_calls(z, op)
    want = [run_fused(c, "kernel") for c in calls]
    with traced_sweep_kernels():
        for call, w in zip(calls, want):
            got = run_fused(call, "kernel")
            torch.cuda.synchronize()
            assert all(torch.equal(g, x) for g, x in zip(got, w))
            marks = fused_trace()
            _, offsets, _ = gs_fused.fused_layout(z["windows"], z["rung0"])
            counts = z["counts"].cpu()
            act = op["active"][0].cpu().numpy() > 0.5
            rows = np.concatenate([
                offsets[c + 1] + np.arange(w)
                for c, w in enumerate(z["windows"]) if counts[c + 1] > 0])
            m = marks[rows[act[rows]]].astype(np.int64)
            assert len(m) and (m > 0).all() and (np.diff(m, axis=1) >= 0).all()
    got = run_fused(calls[0], "kernel")  # untraced again
    torch.cuda.synchronize()
    assert all(torch.equal(g, x) for g, x in zip(got, want[0]))


@pytest.mark.cuda
def test_fused_pit_step_launches_each_kernel_once_a_substep_on_card():
    """A frame of the settled 10k pit under ``fused`` makes a B9 launch
    per solve (one, or two on a frame that regrows its rungs) and, every
    substep of a solve, one B11 and one B10 carrying B12's pose update;
    no standalone B12."""
    _need_card()
    z = dict(np.load(NPZ))
    cfg = PipelineConfig.from_dict(
        json.loads(str(np.load(NPZ_FUSED)["config_json"])))
    state = state_from_arrays(z, device="cuda")
    params = SimParams()
    counters = ((build_fused, "LAUNCHES"), (gs_fused, "LAUNCHES_SUBSTEP1"),
                (gs_fused, "LAUNCHES_SWEEP"),
                (gs_fused, "INTEGRATES_IN_SWEEP"),
                (gs_fused, "LAUNCHES_INTEGRATE"))
    for _ in range(2):
        n0 = [getattr(mod, name) for mod, name in counters]
        state, cfg = step_checked(state, params, cfg)
        torch.cuda.synchronize()
        builds, *per_kernel, standalone = (
            getattr(mod, name) - n for (mod, name), n in zip(counters, n0))
        assert builds >= 1
        assert per_kernel == [builds * params.num_solver_iterations] * 3
        assert standalone == 0


@pytest.mark.cuda
def test_fused_jointed_step_launches_b10_alone_twice_a_substep_on_card():
    """A frame of ``ball_net3(16, 16)`` under the fused solver with
    joints makes a B9 launch per solve and, every substep of a solve, two
    B10 launches alone (the biased sweep, then the unbiased one after the
    joint passes); no B11, no B12 carried or standalone."""
    _need_card()
    case, npz = "net16_fused", NPZ_LBVH_FUSED
    state = joints_case_state(case, "warmed", "cuda", npz)
    cfg = joints_case_config(f"{case}.ref.2.config_json", npz)
    params = joints_case_params(case, npz)
    counters = ((build_fused, "LAUNCHES"), (gs_fused, "LAUNCHES_SWEEP"),
                (gs_fused, "LAUNCHES_SUBSTEP1"),
                (gs_fused, "INTEGRATES_IN_SWEEP"),
                (gs_fused, "LAUNCHES_INTEGRATE"))
    for _ in range(2):
        n0 = [getattr(mod, name) for mod, name in counters]
        state, cfg = step_checked(state, params, cfg)
        torch.cuda.synchronize()
        builds, sweeps, *others = (
            getattr(mod, name) - n for (mod, name), n in zip(counters, n0))
        assert builds >= 1
        assert sweeps == 2 * builds * params.num_solver_iterations
        assert others == [0, 0, 0]
    assert int(state.pair_count[1]) > 0


# --- the linear-algebra kernels ---------------------------------------------


def _normal(seed, *shape, scale=1.0, dtype=torch.float32):
    x = np.random.default_rng(seed).normal(size=shape) * scale
    return torch.from_numpy(x.astype(np.float32)).cuda().to(dtype)


def _gemm_agrees(a, b, **kw):
    launches = gemm_ops.LAUNCHES_GEMM
    got = gemm_ops.gemm(a, b, impl="cuda", **kw)
    want = gemm_ops.gemm_torch(a, b, **kw)
    torch.cuda.synchronize()
    assert gemm_ops.LAUNCHES_GEMM == launches + 1
    assert got.dtype == a.dtype and got.shape == want.shape
    rtol, atol = GEMM_TOL[a.dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 2048, 4096])
def test_gemm_kernel_matches_plain_on_card_square(n):
    _need_card()
    _gemm_agrees(_normal(n, n, n), _normal(n + 1, n, n, scale=n ** -0.5))


@pytest.mark.cuda
@pytest.mark.parametrize("ta", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_gemm_kernel_matches_plain_on_card_transposes(tb, ta):
    _need_card()
    a = _normal(1, *((2, 256, 512) if ta else (2, 512, 256)))
    b = _normal(2, *((2, 384, 256) if tb else (2, 256, 384)))
    _gemm_agrees(a, b, transpose_a=ta, transpose_b=tb)


@pytest.mark.cuda
@pytest.mark.parametrize("shape_a,shape_b,dtype", [
    ((3, 65, 100), (3, 100, 49), torch.float32),  # ragged edges
    ((3, 65, 100), (100, 49), torch.float32),  # one b for the whole batch
    ((1, 1), (1, 1), torch.float32),
    ((2, 3, 130, 17), (2, 3, 17, 257), torch.float32),  # two batch dims
    ((4, 512, 384), (4, 384, 256), torch.bfloat16),
    ((3, 65, 100), (3, 100, 49), torch.bfloat16),
])
def test_gemm_kernel_matches_plain_on_card_shapes(shape_a, shape_b, dtype):
    _need_card()
    k = shape_a[-1]
    _gemm_agrees(_normal(3, *shape_a, dtype=dtype),
                 _normal(4, *shape_b, scale=k ** -0.5, dtype=dtype))


@pytest.mark.cuda
def test_gemm_kernel_takes_strided_rows_without_a_copy():
    _need_card()
    wide = _normal(5, 300, 200)
    _gemm_agrees(wide[:, :64], _normal(6, 64, 50))  # row stride 200


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (65, 1, 49), (65, 7, 49), (130, 9, 257), (33, 17, 100), (65, 4097, 49),
    (100, 33, 130), (1, 50, 1), (257, 300, 129)])
def test_gemm_kernel_edges_on_card(m, k, n, dtype):
    """M, N, K off the tiles' multiples (64 / 128 rows, 8 / 16 deep k
    steps, 32 / 64 deep k tiles): the ragged edge reads as 0."""
    _need_card()
    _gemm_agrees(_normal(20 + k, m, k, dtype=dtype),
                 _normal(21 + k, k, n, scale=k ** -0.5, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ta", [False, True])
@pytest.mark.parametrize("tb", [False, True])
def test_gemm_kernel_transposes_2048_on_card(tb, ta, dtype):
    _need_card()
    _gemm_agrees(_normal(22, 2048, 2048, dtype=dtype),
                 _normal(23, 2048, 2048, scale=2048 ** -0.5, dtype=dtype),
                 transpose_a=ta, transpose_b=tb)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_kernel_broadcast_and_strided_rows_transposed_on_card(dtype):
    _need_card()
    a = _normal(24, 3, 65, 100, dtype=dtype)
    _gemm_agrees(a, _normal(25, 49, 100, scale=0.1, dtype=dtype),
                 transpose_b=True)  # one b for the batch, stored [N, K]
    wide = _normal(26, 300, 200, dtype=dtype)
    # A stored [K, M] with row stride 200 (M = 70 of them read)
    _gemm_agrees(wide[:, 10:80], _normal(27, 300, 50, scale=300 ** -0.5,
                                         dtype=dtype), transpose_a=True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_default_and_highest_are_the_same_bits_on_card(dtype):
    _need_card()
    a = _normal(28, 2, 300, 200, dtype=dtype)
    b = _normal(29, 2, 200, 170, scale=200 ** -0.5, dtype=dtype)
    got = gemm_ops.gemm(a, b, precision="default", impl="cuda")
    assert torch.equal(got, gemm_ops.gemm(a, b, precision="highest",
                                          impl="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(64, 8, 128), (300, 256, 200),
                                   (1024, 1024, 1024)])
def test_gemm_kernel_matches_its_3xtf32_arithmetic_on_card(m, k, n):
    """The kernel against ``_gemm_3xtf32_torch`` (the same split and the
    same exact TF32 products, summed by torch.matmul in full f32): only
    the f32 sums differ, within 1e-5 at K <= 1024 for results of size ~1
    (the tensor cores' accumulation drifts further at K = 4096; that is
    held by GEMM_TOL above)."""
    _need_card()
    a, b = _normal(30, m, k), _normal(31, k, n, scale=k ** -0.5)
    got = gemm_ops.gemm(a, b, impl="cuda")
    want = gemm_ops._gemm_3xtf32_torch(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("n_passes", [6, 3])
@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (33, 70, 17),
                                   (129, 65, 63), (1, 1, 1), (200, 300, 70)])
def test_gemm_split_kernel_matches_plain_on_card(m, k, n, n_passes):
    """f32 sums of exact bf16 products in another order."""
    _need_card()
    a, b = _normal(7, m, k), _normal(8, k, n, scale=k ** -0.5)
    launches = gemm_ops.LAUNCHES_GEMM_SPLIT
    got = gemm_ops.gemm_split(a, b, n_passes=n_passes)
    want = gemm_ops._gemm_split_torch(gemm_ops._split3(a),
                                      gemm_ops._split3(b), n_passes)
    torch.cuda.synchronize()
    assert gemm_ops.LAUNCHES_GEMM_SPLIT == launches + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _device_kernels(fn) -> list[str]:
    """Names of the device kernels of one call of ``fn``, by the profiler
    with host and device activities, as chip_smoke.profile_window takes
    them (windows of device activity alone came back empty on the card in
    some processes). A window in which the profiler reports no device
    event at all is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.002)
        kernels = [e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            return kernels
    return []


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4_194_304, 4_194_305, 1_000_003, 1027, 1])
@pytest.mark.parametrize("op", ["sum", "prod", "min", "max", "sqnorm"])
def test_reduce_kernel_matches_plain_and_repeats_bitwise_on_card(op, n):
    """The plain version within REDUCE_TOL, the same bits every run and
    the CPU emulation's bits (the kernel's order of folds,
    ``reduce_plan``); a view that starts off the 16-byte grid takes scalar
    loads and folds in the same order."""
    _need_card()
    rng = np.random.default_rng(n)
    x = torch.from_numpy((rng.uniform(0.999, 1.001, size=n)
                          * rng.choice([-1.0, 1.0], size=n))
                         .astype(np.float32)).cuda()
    launches = reduce_ops.LAUNCHES_REDUCE
    got = reduce_ops.reduce(x, op, impl="cuda")
    again = reduce_ops.reduce(x, op)
    want = reduce_ops._reduce_torch(x, op)
    torch.cuda.synchronize()
    assert reduce_ops.LAUNCHES_REDUCE == launches + 2
    assert got.shape == () and got.dtype == torch.float32
    assert torch.equal(got, again)  # no atomics: the same bits every run
    pre = reduce_ops._OPS[op][0]
    scale = (abs(float(want)) if op in ("prod", "min", "max")
             else float(pre(x).abs().sum()))
    assert abs(float(got) - float(want)) <= REDUCE_TOL[op] * scale
    blocks = reduce_ops.grid(n, reduce_ops.max_blocks(x.get_device()))
    assert torch.equal(got.cpu(),
                       reduce_ops._reduce_emulated(x.cpu(), op, blocks))
    if n > 4:
        view = x[1:]
        assert view.data_ptr() % 16
        got_view = reduce_ops.reduce(view, op, impl="cuda")
        assert torch.equal(got_view, reduce_ops.reduce(view.clone(), op))
        blocks = reduce_ops.grid(n - 1, reduce_ops.max_blocks(
            x.get_device()))
        assert torch.equal(got_view.cpu(), reduce_ops._reduce_emulated(
            view.cpu(), op, blocks))


@pytest.mark.cuda
def test_reduce_kernel_nan_and_unaligned_views_on_card():
    """NaN on both routes, unaligned views, 20 calls back to back that
    alternate between one block and the ticket (the ticket is back at 0
    after each), and a call that is one device kernel and allocates only
    its output."""
    _need_card()
    x = _normal(9, 10_001)
    # a view that starts off the 16-byte grid takes the scalar loads
    torch.testing.assert_close(reduce_ops.reduce(x[1:], "sum", impl="cuda"),
                               reduce_ops._reduce_torch(x[1:], "sum"),
                               rtol=1e-4, atol=1e-3)
    x[77] = float("nan")
    assert torch.isnan(reduce_ops.reduce(x, "min", impl="cuda"))
    assert torch.isnan(reduce_ops.reduce(x, "max", impl="cuda"))
    # NaN in the first block, the last block, the short last group and an
    # unaligned view of the ticket route; and in a one-block call
    dev = x.get_device()
    for n, at in ((4_194_305, 5), (4_194_305, 4_000_000),
                  (4_194_305, 4_194_304), (100_003, 99_999), (1027, 1026)):
        y = _normal(at, n)
        y[at] = float("nan")
        assert (reduce_ops.grid(n, reduce_ops.max_blocks(dev)) > 1) == (
            n > reduce_ops.MIN_SHARE)
        for v in (y, y[1:]):
            assert torch.isnan(reduce_ops.reduce(v, "min", impl="cuda"))
            assert torch.isnan(reduce_ops.reduce(v, "max", impl="cuda"))
    # back to back, no sync: one block (1,027) and the ticket (100,003 and
    # 2^22 + 1), each op
    xs = [_normal(20 + i, n) for i, n in enumerate((1027, 100_003,
                                                    4_194_305))]
    assert [reduce_ops.grid(v.numel(), reduce_ops.max_blocks(dev)) > 1
            for v in xs] == [False, True, True]
    for op in ("sum", "sqnorm", "max"):
        first = [reduce_ops.reduce(v, op) for v in xs]
        launches = reduce_ops.LAUNCHES_REDUCE
        runs = [reduce_ops.reduce(xs[i % 2 + (i % 4 == 3)], op)
                for i in range(20)]
        torch.cuda.synchronize()
        assert reduce_ops.LAUNCHES_REDUCE == launches + 20
        for i, got in enumerate(runs):
            assert torch.equal(got, first[i % 2 + (i % 4 == 3)]), (op, i)
    # a repeated call allocates nothing beyond its output
    for v in xs:
        held = reduce_ops.reduce(v, "sum")  # its block is not reused below
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        out = reduce_ops.reduce(v, "sum")
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - base
        # the caching allocator rounds a block up to 512 bytes
        assert 0 <= grown - out.untyped_storage().nbytes() < 512, grown
        assert torch.equal(out, held)
        del held, out  # freed blocks would offset the next count
        kernels = _device_kernels(lambda: reduce_ops.reduce(v, "sum"))
        assert len(kernels) == 1 and "reduce" in kernels[0], kernels


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "copy",
                                "redirect"])
@pytest.mark.parametrize("shape", [(2048, 2048), (3, 5, 7)])
def test_op_assign_kernel_matches_plain_on_card(shape, op):
    _need_card()
    a = _normal(10, *shape)
    b = _normal(11, *shape).abs() + 0.5
    k_op, p_op = redirect_op() if op == "redirect" else (op, op)
    launches = elementwise_ops.LAUNCHES_OP_ASSIGN
    got = elementwise_ops.op_assign_kernel(a, b, k_op)
    want = elementwise_ops.op_assign(a, b, p_op)
    torch.cuda.synchronize()
    assert elementwise_ops.LAUNCHES_OP_ASSIGN == launches + 1
    assert got.shape == a.shape and got.dtype == a.dtype
    torch.testing.assert_close(got, want, rtol=OP_ASSIGN_RTOL, atol=0.0)


@pytest.mark.cuda
def test_op_assign_kernel_refuses_a_plain_callable_on_card():
    _need_card()
    a = _normal(12, 64)
    with pytest.raises(TypeError, match="triton.jit"):
        elementwise_ops.op_assign_kernel(a, a, lambda x, y: x + y)


@pytest.mark.cuda
def test_cuda_impl_raises_on_cpu_tensors():
    _need_card()
    a = torch.ones((4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        gemm_ops.gemm(a, a, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        reduce_ops.reduce(a, "sum", impl="cuda")
    with pytest.raises(ValueError):
        gemm_ops.gemm(a.cuda(), a.cuda(), precision="high", impl="cuda")
    with pytest.raises(ValueError):
        gemm_ops.gemm(a.cuda().double(), a.cuda().double(), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        gemv_ops.gemv(a, a[0], impl="cuda")
    # on the card gemv launches its kernel or raises: no plain route
    with pytest.raises(ValueError, match="float32"):
        gemv_ops.gemv(a.cuda().double(), a[0].cuda().double())


@pytest.mark.cuda
@pytest.mark.parametrize("mod", ["linalg.gemm", "linalg.reduce",
                                 "linalg.op_assign", "linalg.gemv"])
def test_compile_check_launches_the_kernels_on_card(mod):
    _need_card()
    counters = ((gemm_ops, "LAUNCHES_GEMM"), (reduce_ops, "LAUNCHES_REDUCE"),
                (elementwise_ops, "LAUNCHES_OP_ASSIGN"),
                (gemv_ops, "LAUNCHES_GEMV"), (gemv_ops, "LAUNCHES_GEMV_TR"))
    before = sum(getattr(m, a) for m, a in counters)
    checked = compile_check(mod)
    assert checked and sum(getattr(m, a) for m, a in counters) \
        == before + len(checked)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("case", range(len(GEMV_SHAPES[False])))
def test_gemv_kernel_matches_plain_and_repeats_bitwise_on_card(case,
                                                               transpose_a):
    """B5 / B6 at every shape of the kernel phase: within 1e-5 of the sum
    of the terms' magnitudes of each output, the same bits from two
    launches, one count per launch."""
    _need_card()
    entry = GEMV_SHAPES[transpose_a][case]
    seeds = iter((case, case + 10))  # A, then x
    a, x = gemv_case_operands(entry, lambda shape: _normal(next(seeds),
                                                           *shape))
    label = entry[0]
    name = "LAUNCHES_GEMV_TR" if transpose_a else "LAUNCHES_GEMV"
    before = getattr(gemv_ops, name)
    got = gemv_ops.gemv(a, x, transpose_a=transpose_a)
    again = gemv_ops.gemv(a, x, transpose_a=transpose_a, impl="cuda")
    want = gemv_ops.gemv_torch(a, x, transpose_a=transpose_a)
    scale = gemv_ops.gemv_torch(a.abs(), x.abs(), transpose_a=transpose_a)
    torch.cuda.synchronize()
    assert getattr(gemv_ops, name) == before + 2, label
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= GEMV_TOL * scale).all()), label
    assert torch.equal(got, again), label


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
def test_gemv_kernel_takes_strided_and_batched_operands_on_card(transpose_a):
    """A row-strided A (a column slice), a misaligned column slice with M
    not a multiple of 4, a batched x against a shared A, and a batch over
    leading dimensions, against the plain version."""
    _need_card()
    wide = _normal(3, 96, 160)
    a = wide[:, :128]  # rows 160 floats apart
    x = _normal(4, 5, 96 if transpose_a else 128)
    got = gemv_ops.gemv(a, x, transpose_a=transpose_a)
    want = gemv_ops.gemv_torch(a, x, transpose_a=transpose_a)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # rows 4 bytes past a 16-byte boundary, 95 columns and rows
    odd = wide[1:, 3:98]
    xo = _normal(7, 95)
    torch.testing.assert_close(
        gemv_ops.gemv(odd, xo, transpose_a=transpose_a),
        gemv_ops.gemv_torch(odd, xo, transpose_a=transpose_a),
        rtol=1e-5, atol=1e-5)
    a4 = _normal(5, 2, 3, 40, 24)
    x4 = _normal(6, 3, 40 if transpose_a else 24)
    torch.testing.assert_close(
        gemv_ops.gemv(a4, x4, transpose_a=transpose_a),
        gemv_ops.gemv_torch(a4, x4, transpose_a=transpose_a),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("transpose_a", [False, True])
@pytest.mark.parametrize("n", [4096, 1000])
def test_gemv_is_one_launch_and_allocates_only_its_output_on_card(
        transpose_a, n):
    """A product, transposed or not, is one device kernel, and a repeated
    call allocates nothing beyond its output (so a scratch cached at the
    first call would pass; the kernels keep none)."""
    from torch.profiler import ProfilerActivity, profile

    _need_card()
    a, x = _normal(8, n, n), _normal(9, n)
    gemv_ops.gemv(a, x, transpose_a=transpose_a)
    torch.cuda.synchronize()
    # a window in which the profiler reports no device event at all is
    # taken again, up to three times, with host and device activities (as
    # chip_smoke.profile_window does: windows of device activity alone came
    # back empty in some processes)
    for _ in range(3):
        base = torch.cuda.memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)
            y = gemv_ops.gemv(a, x, transpose_a=transpose_a)
            torch.cuda.synchronize()
            time.sleep(0.002)
        grown = torch.cuda.memory_allocated() - base
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
        del y
    assert len(kernels) == 1, [e.name for e in kernels]
    assert "gemv" in kernels[0].name
    # the caching allocator rounds a block up to 512 bytes
    assert 0 <= grown - y.untyped_storage().nbytes() < 512, grown


@pytest.mark.cuda
def test_cast_on_card_matches_the_cpu_port():
    """The bench's mixed set on 8,192 rays, with unit directions so that
    every time is well conditioned in f32: the card's cast against the
    port's on the CPU."""
    _need_card()
    z = ray_bench_arrays(8192, 3)
    z["dirs"] = z["dirs"] / np.linalg.norm(z["dirs"], axis=-1, keepdims=True)
    z["origins"] = z["translation"] + (z["origins"] - z["translation"]) / 3
    got = ray.cast(*ray_scene(z, "cuda")).cpu()
    want = ray.cast(*ray_scene(z, "cpu"))
    hit = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), hit)
    assert int(hit.sum()) > 100
    torch.testing.assert_close(got[hit], want[hit], rtol=1e-5, atol=1e-5)


# the card-against-CPU velocity limit of each jointed case, m/s (see the
# test's docstring)
JOINT_DV_LIMITS = {"drape_ladder": 1e-5, "drape_chained_ps": 1e-5,
                   "net16": 6e-5, "joint_revolute3": 4e-6}


@pytest.mark.cuda
@pytest.mark.parametrize("case,counter", [
    ("drape_ladder", "LAUNCHES_BLOCK"), ("drape_chained_ps", "LAUNCHES"),
    ("net16", "LAUNCHES_BLOCK"), ("joint_revolute3", None)])
def test_jointed_frames_on_card_match_cpu(case, counter):
    """Two frames (``step``: no regrow re-runs) of a jointed case of
    ``joints_jax.npz`` from its warmed state on the card and on the CPU:
    the same integers; translations within 1e-5 m, as the quick start's
    frames; velocities within ``JOINT_DV_LIMITS``, the card's and the CPU's
    float32 sweeps and transcendentals rounding apart (the joint passes
    add at most one non-zero delta a body in a colour, so their
    scatter-adds are exact in any order); on the card two sweep launches
    a substep (none without contacts).

    ``scripts/exp_joint_card_gap.py`` (H100 80GB HBM3, 700 W; two runs,
    the same readings) put the card's largest |dv| from the CPU's at
    3.99e-6 (drape_ladder), 4.87e-6 (drape_chained_ps), 3.00e-5 (net16)
    and 1.91e-6 m/s (joint_revolute3), |dx| at most 4.8e-7 m; each limit
    is twice its case's reading, rounded up. The same script
    breaks the CPU's joint pass one slot or one colour at a time: every
    colour skipped, and every slot that carries load in its scene,
    moves these frames by 0.33 m/s or more (drape 0.336, net16 2.85,
    joint_revolute3 0.335). A slot that carries none here moves them by
    at most 6.3e-7 m/s (the drape's z lock, slot 11: 0; the revolute
    chain's out-of-plane locks, slots 7-9: 3.0e-7 to 6.3e-7), below what
    any card-against-CPU limit can see; ``tests/test_torch_joint.py``
    holds every slot against the JAX package's on the CPU."""
    _need_card()
    params = joints_case_params(case)
    cfg = joints_case_config(f"{case}.config_json")
    out = {}
    for dev in ("cpu", "cuda"):
        state = joints_case_state(case, "warmed", device=dev)
        n0 = getattr(gs_math, counter) if counter else 0
        for _ in range(2):
            state = solver_step(state, params, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            if counter:
                assert getattr(gs_math, counter) - n0 == 2 * 2 * 4
        out[dev] = state
    sc, sg = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(sg.pair_count.cpu().numpy(),
                                  sc.pair_count.numpy())
    np.testing.assert_allclose(sg.bodies.poses.translation.cpu().numpy(),
                               sc.bodies.poses.translation.numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sg.bodies.vels.linear.cpu().numpy(),
                               sc.bodies.vels.linear.numpy(), rtol=0,
                               atol=JOINT_DV_LIMITS[case])


@pytest.mark.cuda
def test_native_colouring_builds_and_matches_its_twin_on_card_machine():
    """The port's C++ joint colouring builds with the card machine's g++
    and agrees with its plain twin, past 64 colours too."""
    _need_card()
    from wgmath_tpu_torch.native import greedy_color, greedy_color_plain

    rng = np.random.default_rng(7)
    a = rng.integers(0, 500, 3000)
    b = (a + 1 + rng.integers(0, 499, 3000)) % 500
    dyn = np.arange(500) >= 4
    valid = rng.random(3000) > 0.05
    np.testing.assert_array_equal(greedy_color(a, b, dyn, valid),
                                  greedy_color_plain(a, b, dyn, valid))
    star = greedy_color(np.zeros(70, np.int32), np.arange(1, 71),
                        np.ones(71, bool))
    np.testing.assert_array_equal(star, np.arange(1, 71))


@pytest.mark.cuda
def test_mesh_small_cases_on_card():
    """``tests/test_torch_mesh.py``'s cases on the card against the JAX
    package's stored results (``chip_smoke.mesh_small_cases``): the
    triangle ids on the dense and the clustered field exactly, the ball
    and convex contacts' ids and validity exactly, the field's ray cast."""
    _need_card()
    mesh_small_cases()


@pytest.mark.cuda
def test_standalone_scenes_rest_on_card():
    """The standalone triangle, segment and convex scenes 40 frames on the
    card: at rest on their colliders, within 1e-3 m of JAX's trail."""
    _need_card()
    standalone_checks(SimParams())


@pytest.mark.cuda
def test_trimesh3_frames_on_card_match_cpu():
    """Two frames (``step``) of ``trimesh3`` from JAX's landed state on the
    card and on the CPU: the same integers, translations within 1e-5 m;
    on the card two B2 launches a substep (the uniform windows' plan)."""
    _need_card()
    params = joints_case_params("trimesh3", NPZ_MESH)
    cfg = joints_case_config("trimesh3.config_json", NPZ_MESH)
    out = {}
    for dev in ("cpu", "cuda"):
        state = joints_case_state("trimesh3", "warmed", device=dev,
                                  npz=NPZ_MESH)
        n0 = gs_math.LAUNCHES_BLOCK
        for _ in range(2):
            state = solver_step(state, params, cfg)
        if dev == "cuda":
            torch.cuda.synchronize()
            assert gs_math.LAUNCHES_BLOCK - n0 == 2 * 2 * 4
        out[dev] = state
    sc, sg = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(sg.pair_count.cpu().numpy(),
                                  sc.pair_count.numpy())
    np.testing.assert_allclose(sg.bodies.poses.translation.cpu().numpy(),
                               sc.bodies.poses.translation.numpy(),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_mesh10k_first_frame_counts_on_card():
    """``mesh10k``'s first frame from its built state on the card against
    the JAX package's (``chip_smoke.mesh10k_frame1``): pairs and ball rows
    exactly, the convex rows row by row but where JAX's float32 GJK left
    the true distance (the port then within 1e-4 m of the float64
    referee and valid as its distance makes it, ROADMAP C13), so the
    convex rows and the contacts count JAX's with the referee's rows;
    the balls within 1e-4 m, the cuboids within the limits read on the
    card."""
    _need_card()
    from chip_smoke import _stored, mesh10k_frame1

    state = mesh10k_scene()
    cfg = mesh10k_pipeline_config(state.shapes)
    params = SimParams()
    after, cfg = step_checked(state, params, cfg)
    out = mesh10k_frame1(state, after, cfg, params, _stored(NPZ_MESH))
    assert out["max_dx_balls"] <= 1e-4


@pytest.mark.cuda
def test_mesh_gjk_graph_replays_give_the_eager_bits_on_card(monkeypatch):
    """The mesh contacts' per-triangle GJK as a CUDA graph, captured on one
    state and replayed on another, gives the eager run's bits."""
    _need_card()
    from wgmath_tpu_torch.queries import mesh_contact
    from wgmath_tpu_torch.queries import narrow_phase as narrow_mod

    from chip_smoke import grid_pairs

    state = mesh10k_scene()
    cfg = mesh10k_pipeline_config(state.shapes)
    p0 = state.bodies.poses
    moved = Sim(p0.rotation, p0.translation + torch.tensor(
        [0.0, -0.01, 0.0], device="cuda"), p0.scale)
    pairs = grid_pairs(state, cfg, SimParams())

    def contacts(poses):
        return mesh_contact.mesh_convex_contacts(
            poses, state.shapes, pairs, 0.002, pair_cap=8192, k_best=4)

    with monkeypatch.context() as m:
        m.setattr(mesh_contact, "graph_call",
                  lambda key, fn, args: fn(*args))
        eager = [contacts(p) for p in (state.bodies.poses, moved)]
    narrow_mod._GRAPHS.clear()
    graphed = [contacts(p) for p in (state.bodies.poses, moved)]
    for e, g in zip(eager, graphed):
        for f in ("normal_a", "points_a", "dist", "num_points", "valid"):
            assert torch.equal(getattr(e, f), getattr(g, f)), f
    assert not torch.equal(eager[0].dist, eager[1].dist)
    assert len(narrow_mod._GRAPHS) == 1


@pytest.mark.cuda
def test_native_bvh_builds_and_matches_its_twin_on_card_machine():
    """The port's C++ BVH build on the card machine's g++ against its
    plain twin."""
    _need_card()
    from wgmath_tpu_torch.native import build_bvh, build_bvh_plain

    c = np.random.default_rng(11).uniform(-5, 5, (300, 3)).astype(
        np.float32)
    for a, b in zip(build_bvh(c - 0.1, c + 0.2),
                    build_bvh_plain(c - 0.1, c + 0.2)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# 2D: no port kernel on the step, and the kernels refuse 2D rows
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["boxes_and_balls2", "pyramid2_jacobi",
                                  "boxes_and_balls2_chained",
                                  "joint_ball2", "polyline2"])
def test_planar_step_on_card_launches_no_port_kernel(case):
    """A 2D frame on the card from JAX's stored state: no B1 / B2 (or any
    port kernel) launch, the CPU step's pair and contact counts, and
    translations within 1e-5 m of the CPU's."""
    _need_card()
    from chip_smoke import PIT_COUNTERS, _pit_counts
    from tests.planar_inputs import (
        case_mode,
        config_of,
        params_of,
        planar_state,
    )

    cfg = config_of(f"{case}.config_json")
    params = params_of(case_mode(case))
    cpu, _ = step_checked(planar_state(case, 0), params, cfg)
    for mod, attr in PIT_COUNTERS.values():
        setattr(mod, attr, 0)
    card, _ = step_checked(planar_state(case, 0, device="cuda"), params, cfg)
    torch.cuda.synchronize()
    assert not any(_pit_counts().values()), _pit_counts()
    assert torch.equal(card.pair_count.cpu()[:8], cpu.pair_count[:8])
    err = (card.bodies.poses.translation.cpu()
           - cpu.bodies.poses.translation).abs().max()
    assert float(err) <= 1e-5


@pytest.mark.cuda
def test_sweep_kernels_refuse_2d_rows():
    """B1 / B2 take 6-wide velocity rows: a 3-wide (2D) buffer raises
    before any launch, on a whole sweep of the pit's plans (chained_ps for
    B1, the ladder for B2) and on one rung."""
    _need_card()
    calls = pit_sweeps(NPZ, "cuda", 1) + pit_sweeps(NPZ_LADDER, "cuda", 1)
    before = (gs_math.LAUNCHES, gs_math.LAUNCHES_BLOCK)
    for call in calls:
        pf2d, pf_meta = call.fields
        buf3 = torch.zeros((call.buf.shape[0], 3), device="cuda")
        kw = call.kw
        with pytest.raises(ValueError, match="buf"):
            if kw.get("rhs_mode") is not None:
                gs_math.gs_sweep_rhs(
                    call.plan, pf2d, pf_meta, call.cons.num_points, buf3,
                    call.imp, mode=kw["rhs_mode"], consts=kw["rhs_consts"],
                    p_max=kw["p_max"], s_len=kw["s_len"], pose=kw["pose"])
            else:
                gs_math.gs_sweep_block(
                    call.plan, pf2d, pf_meta, call.cons.cfm_factor,
                    call.cons.n_rhs, call.cons.t_rhs, call.cons.num_points,
                    buf3, call.imp, p_max=kw["p_max"], s_len=kw["s_len"])
    args, kw = gs_block_inputs(np.random.default_rng(3), 64, 4, "cuda")
    args = list(args)
    args[4], args[5] = (a[:, :3].contiguous() for a in args[4:6])
    with pytest.raises(ValueError):
        gs_math.gs_math_block(*args, **kw)
    assert (gs_math.LAUNCHES, gs_math.LAUNCHES_BLOCK) == before


@pytest.mark.cuda
def test_planar_pfm_graph_replays_give_the_eager_bits_on_card():
    """The 2D support-mapped kernel's CUDA graph (``_pfm2_call``) on
    ``capsules2``'s three stored states gives its eager run's bits, and
    the eager run on the card the CPU's rows within 1e-6 m (float64)."""
    _need_card()
    from wgmath_tpu_torch.queries import narrow_phase as narrow_mod
    from tests.planar_inputs import planar_state

    narrow_mod._GRAPHS.clear()
    for i in range(3):
        st = planar_state("capsules2", i, device="cuda")
        b, sh = st.bodies, st.shapes
        n = b.num_bodies
        ia, ib = torch.triu_indices(n, n, 1, device="cuda")
        keep = (sh.tag[ia] == 2) | (sh.tag[ib] == 2)
        a, bb = ia[keep][:2048], ib[keep][:2048]
        args = (b.poses.take(a), b.poses.take(bb), sh.tag[a],
                sh.params[a], sh.tag[bb], sh.params[bb],
                torch.ones_like(a, dtype=torch.bool))
        eager = narrow_mod._pfm2(*args)
        graphed = narrow_mod._pfm2_call(*args)
        for e, g in zip(eager, graphed):
            assert torch.equal(e, g)
        cpu = narrow_mod._pfm2(*(x.cpu() if torch.is_tensor(x) else
                                 type(x)(*(t.cpu() for t in (
                                     x.rotation, x.translation, x.scale)))
                                 for x in args))
        assert float((eager[2].cpu() - cpu[2]).abs().max()) <= 1e-6
    assert len([k for k in narrow_mod._GRAPHS if k[0] == "pfm2"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("p_max", [1, 4])
def test_b2_on_a_ranks_slice_matches_the_rung_bit_for_bit(p_max):
    """Sharding does not change B2's arithmetic: the one-rung launch on
    each rank's slice of a rung (``solver._sweep_torch`` under a shard of
    2 and 3 ranks) gives the whole rung's rows bit for bit, and its plain version
    on the same slice within the kernel's tolerance (B2 and its plain
    version do not sum in one order: not bit for bit, sharded or not)."""
    _need_card()
    (win, meta, view, active, p1, p2, prev_n, prev_t), kw = gs_block_inputs(
        np.random.default_rng(19 + p_max), 4096, p_max, "cuda")
    whole = gs_math.gs_math_block(win, meta, view, active, p1, p2, prev_n,
                                  prev_t, **kw)
    for ranks in (2, 3):
        lw = -(-4096 // ranks)
        for k in range(ranks):
            sl = slice(k * lw, min((k + 1) * lw, 4096))
            v = SimpleNamespace(**{f: getattr(view, f)[sl] for f in (
                "cfm_factor", "n_rhs", "t_rhs", "num_points")})
            args = (win[sl], meta, v, active[sl], p1[sl], p2[sl],
                    prev_n[sl], prev_t[sl])
            launches = gs_math.LAUNCHES_BLOCK
            part = gs_math.gs_math_block(*args, **kw)
            assert gs_math.LAUNCHES_BLOCK == launches + 1
            plain = gs_block_plain(*args, **kw)
            torch.cuda.synchronize()
            for g, w, p in zip(part, whole, plain):
                assert torch.equal(g, w[sl])
                torch.testing.assert_close(g, p, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_sharded_step_is_replicated_bit_for_bit_on_card():
    """Two gloo ranks on the card, each running the sharded pipeline
    twice from one stored state (``balls(192)`` after JAX's 25 warm
    frames, with contacts in every colour): every rank's state after every
    frame is the same bits, in both runs, and B2 ran one-rung on the
    ranks' slices."""
    _need_card()
    from chip_smoke import NPZ_PARALLEL
    from tests.parallel_ranks import run_ranks
    from wgmath_tpu_torch.convert import load_arrays

    z = load_arrays(NPZ_PARALLEL)
    arrays = {k[len("ladder.state."):]: v for k, v in z.items()
              if k.startswith("ladder.state.")}
    cfg = PipelineConfig.from_dict(json.loads(str(z["ladder.config_json"])))
    cfg = dataclasses.replace(cfg, bp_force="miss")
    job = ("pipeline", dict(arrays=arrays, params=SimParams(), config=cfg,
                            frames=3, timed=2))
    res = run_ranks([job, job], 2, "gloo", device="cuda")
    digests = {(tuple(r[i]["digest"]), r[i]["timed"]["digest"])
               for r in res for i in range(2)}
    assert len(digests) == 1
    assert all(r[i]["timed"]["b2_launches_per_step"] > 0
               for r in res for i in range(2))


# --- static pair slots and the small-matrix geometry (no kernel of their
# own: B1 on the static plan, and plain tensor code card against CPU) ---


def _static_balls(device):
    """``balls(256)`` from the JAX package's warmed state under its
    ``chained_ss`` configuration (``static_slots_jax.npz.xz``)."""
    from wgmath_tpu_torch.convert import load_arrays

    z = load_arrays(NPZ_STATIC)
    arrays = {k[len("balls.warmed."):]: v for k, v in z.items()
              if k.startswith("balls.warmed.")}
    cfg = PipelineConfig.from_dict(json.loads(str(z["balls.config_json"])))
    return state_from_arrays(arrays, device=device), cfg


@pytest.mark.cuda
def test_chained_ss_step_on_card_matches_cpu():
    """One checked ``chained_ss`` frame of ``balls(256)`` on the card and
    on the CPU: counts, the cached pairs' static slots, colours and flag
    exactly, translations within 1e-5 m, and B1 launched on the card."""
    _need_card()
    from wgmath_tpu_torch.dynamics.solver import static_offsets

    got_s, cfg = _static_balls("cuda")
    want_s, _ = _static_balls("cpu")
    n0 = gs_math.LAUNCHES
    got, got_cfg = step_checked(got_s, SimParams(), cfg)
    torch.cuda.synchronize()
    assert gs_math.LAUNCHES > n0
    want, want_cfg = step_checked(want_s, SimParams(), cfg)
    assert got_cfg == want_cfg
    assert torch.equal(got.pair_count.cpu(), want.pair_count)
    for f in ("body_a", "body_b", "valid"):
        assert torch.equal(getattr(got.bp_pairs, f).cpu(),
                           getattr(want.bp_pairs, f))
    assert torch.equal(got.bp_colors[0].cpu(), want.bp_colors[0])
    assert got.bp_colors[1:] == want.bp_colors[1:] and got.bp_colors[3] != 1
    assert torch.equal(got.solve_cache[1].cpu(), torch.tensor(static_offsets(
        tuple(cfg.gs_windows[:cfg.max_colors]))))
    torch.testing.assert_close(got.bodies.poses.translation.cpu(),
                               want.bodies.poses.translation, rtol=0,
                               atol=1e-5)


DECOMP_CASES = [f"{k}{n}" for n in (2, 3, 4) for k in (
    "lu", "lu_solve", "qr", "cholesky", "cholesky_solve", "eig", "inv",
    "det")] + ["svd2", "svd3"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DECOMP_CASES)
def test_small_matrix_geometry_on_card_matches_cpu(case):
    """Each decomposition, solve, inverse and determinant on 4,096 seeded
    matrices on the card against the same call on the CPU, within
    ``chip_smoke.DECOMP_CPU_TOL`` (LU's pivots exactly)."""
    _need_card()
    import importlib

    from chip_smoke import DECOMP_CPU_TOL
    from wgmath_tpu_torch.geometry import decomp

    inv_mod = importlib.import_module("wgmath_tpu_torch.geometry.inv")
    name, n = case[:-1], int(case[-1])
    rng = np.random.default_rng(len(case) * 10 + n)
    a = rng.normal(size=(4096, n, n)).astype(np.float32)
    b = rng.normal(size=(4096, n)).astype(np.float32)
    eye = np.eye(n, dtype=np.float32)
    inputs = {
        "lu": (a + eye,), "qr": (a,), "svd": (a,),
        "cholesky": (np.einsum("nki,nkj->nij", a, a) + 0.5 * eye,),
        "eig": ((a + np.swapaxes(a, 1, 2)) / 2,),
        "inv": (a + n * eye,), "det": (a + n * eye,)}
    fns = {"lu": decomp.lu, "qr": decomp.qr, "svd": decomp.svd,
           "cholesky": decomp.cholesky, "eig": decomp.symmetric_eigen,
           "inv": getattr(inv_mod, f"inv{n}"),
           "det": getattr(inv_mod, f"det{n}")}
    if name == "lu_solve":
        fn = decomp.lu_solve
        args = decomp.lu(torch.from_numpy(a + eye)) + (torch.from_numpy(b),)
    elif name == "cholesky_solve":
        fn = decomp.cholesky_solve
        args = (decomp.cholesky(torch.from_numpy(inputs["cholesky"][0])),
                torch.from_numpy(b))
    else:
        fn = fns[name]
        args = tuple(torch.from_numpy(x) for x in inputs[name])
    got = fn(*(x.cuda() for x in args))
    want = fn(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    rtol, atol = DECOMP_CPU_TOL[name]
    for g, w in zip(got, want):
        assert g.is_cuda
        if w.is_floating_point():
            torch.testing.assert_close(g.cpu(), w, rtol=rtol, atol=atol)
        else:
            assert torch.equal(g.cpu(), w)
