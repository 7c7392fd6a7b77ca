"""The sweep plan of the port's Gauss-Seidel sweeps
(``solver.build_sweep_plan``) and its plain sweep (``solver._sweep_torch``),
on the CPU and without JAX.

A small pit built by the port (``scenes.builders.ball_pit``, squeezed so
that every ball touches its neighbours at once) is stepped once under the
ladder, chained, chained_rr and chained_ps configurations, and each
configuration's first two sweeps are recorded. The plan is held against
the per-rung loop's own definitions (which rows a rung runs, which row a
side reads, which earlier write it needs), and the plain sweep against
that loop, kept below as it ran before one launch per sweep, bit for bit.
The sweep kernels themselves run on the card (``tests/test_torch_cuda.py``).
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from wgmath_tpu_torch.dynamics import gs_math, solver
from wgmath_tpu_torch.dynamics.body import Velocity
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from wgmath_tpu_torch.pipeline import PipelineConfig, step_checked
from wgmath_tpu_torch.scenes.builders import ball_pit
from tests.torch_threads import one_torch_thread  # noqa: F401

BASE = PipelineConfig(pair_capacity=2048, contact_capacity=1024,
                      max_colors=16, gs_cmax=512, bp_slack=0.03,
                      bp_algo="grid", manifold_points=1,
                      gs_windows=(256,) * 16)
CONFIGS = {
    "ladder": {},
    "chained": dict(gs_chained=True),
    "chained_rr": dict(gs_chained=True, gs_rhs_in_rung=True),
    "chained_ps": dict(gs_chained=True, gs_rhs_in_rung=True,
                       gs_pair_slots=True),
}
N_STATIC = 5


def _squeezed_pit():
    """160 balls whose lattice is pulled in to 0.93 of its spacing: every
    ball overlaps its neighbours and the bottom layer the ground, so the
    first frame has a full colour ladder."""
    state = ball_pit(160, device="cpu")
    tr = state.bodies.poses.translation
    tr[N_STATIC:, [0, 2]] *= 0.93
    tr[N_STATIC:, 1] = (tr[N_STATIC:, 1] - 1.0) * 0.93 + 0.49
    return state


@pytest.fixture(scope="module")
def passes():
    """name → the first two ``gs_color_major_pass`` calls (args, kwargs)
    of one frame under that configuration."""
    out = {}
    real = solver.gs_color_major_pass
    for name, change in CONFIGS.items():
        calls = []

        def record(*args, **kw):
            if len(calls) < 2:
                calls.append((args, kw))
            return real(*args, **kw)

        solver.gs_color_major_pass = record
        try:
            step_checked(_squeezed_pit(), SimParams(),
                         dataclasses.replace(BASE, **change))
        finally:
            solver.gs_color_major_pass = real
        out[name] = calls
    return out


def _class_sides(plan):
    """Per rung: (rung index, the rung, the side indices of its class
    slots, a-sides then b-sides)."""
    out = []
    for k, r in enumerate(plan.rungs):
        slot = np.arange(r.rows)
        out.append((k, r, np.concatenate([2 * r.w_off + slot,
                                          2 * r.w_off + r.window + slot])))
    return out


def _side_bodies(plan, cons):
    """Body of every side of the plan, from the constraints."""
    body = np.zeros(plan.sides.shape[0], np.int64)
    ba, bb = cons.body_a.numpy(), cons.body_b.numpy()
    for r in plan.rungs:
        a, w, rows = 2 * r.w_off, r.window, slice(r.start, r.start + r.window)
        body[a:a + w] = ba[rows]
        body[a + w:a + 2 * w] = bb[rows]
    return body


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sides_wait_on_the_body_table_or_an_earlier_rung(passes, name):
    """Every side a rung runs waits on nothing (it reads the body table,
    or no earlier rung wrote its body) or on a side of a strictly earlier
    rung that writes; chunks never cross a rung and hold only class
    slots, in ladder order; a chained side reads the chain's row."""
    args, kw = passes[name][0]
    cons, vels = args[0], args[1]
    n = vels.linear.shape[0]
    plan = kw["sweep_plan"]
    sides = plan.sides.numpy()
    read, write, wait = sides[:, 0], sides[:, 1], sides[:, 2]
    assert plan.chunks.dtype == torch.int32 and plan.p_max == 1
    chunks = plan.chunks.numpy()
    assert sum(r.rows for r in plan.rungs) > 100  # a real ladder
    assert len([r for r in plan.rungs if r.rows]) >= 4
    end = 0
    for _, r, idx in _class_sides(plan):
        start, w, w_off, m = r.start, r.window, r.w_off, r.rows
        c0, c1 = r.chunk0, r.chunk1
        assert c0 == end and c1 - c0 == -(-m // 128)
        end = c1
        ch = chunks[c0:c1]
        np.testing.assert_array_equal(ch[:, 0], start + 128 * np.arange(
            c1 - c0))
        assert ch[:, 1].sum() == m and (ch[:, 1] <= 128).all()
        np.testing.assert_array_equal(ch[:, 2] - ch[:, 0],
                                      2 * w_off - start)
        np.testing.assert_array_equal(ch[:, 3] - ch[:, 2], w)
        deps = wait[idx]
        waited = deps[deps >= 0]
        assert (waited < 2 * w_off).all()  # an earlier rung's side
        assert (write[waited] >= 0).all()  # that writes
        for dep in waited:  # and runs
            rung = next(r for r in plan.rungs
                        if 2 * r.w_off <= dep < 2 * (r.w_off + r.window))
            assert (dep - 2 * rung.w_off) % rung.window < rung.rows
    assert end == chunks.shape[0]
    body = _side_bodies(plan, cons)
    np.testing.assert_array_equal(sides[:, 3] >> 1, body)
    if args[6] is not None:
        src, last_writer = (x.numpy() for x in args[6])
        np.testing.assert_array_equal(read, src)
        np.testing.assert_array_equal(wait >= 0, src >= n)
        np.testing.assert_array_equal(wait[src >= n], src[src >= n] - n)
        # on the sides a rung runs, the chain's src is each body's previous
        # writer, as the ladder's wait side is
        prev = solver._prev_writer(torch.from_numpy(body),
                                   torch.from_numpy(write >= 0)).numpy()
        run = np.concatenate([idx for _, _, idx in _class_sides(plan)])
        np.testing.assert_array_equal(prev[run], wait[run])
        writers = np.flatnonzero(write >= 0)
        assert set(writers) == set(src[src >= n] - n) | set(
            last_writer[last_writer >= n] - n)
        np.testing.assert_array_equal(write[writers], writers + n)
    else:
        np.testing.assert_array_equal(read, body)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_each_row_runs_in_at_most_one_rung(passes, name):
    """The in-place writes rely on it: a row is run (and written) by one
    rung at most, the rung of its class; its active flag is the loop's
    (slot inside the class, contact live)."""
    args, kw = passes[name][0]
    cons, plan = args[0], kw["sweep_plan"]
    offsets, counts = args[4]
    rows, act = [], []
    sides = plan.sides.numpy()
    valid = cons.valid.numpy()
    for _, r, idx in _class_sides(plan):
        start, m = r.start, r.rows
        assert start == offsets[r.colour] and m == min(counts[r.colour],
                                                        r.window)
        rows += list(range(start, start + m))
        np.testing.assert_array_equal(sides[idx[:m], 3] & 1,
                                      valid[start:start + m])
        np.testing.assert_array_equal(sides[idx[m:], 3] & 1,
                                      valid[start:start + m])
        act += [r for r in range(start, start + m) if valid[r]]
    assert len(rows) == len(set(rows)) and len(act) == len(set(act))
    assert 0 < len(act) <= len(rows)


def test_ladder_waits_order_each_bodys_updates_as_the_loop_does(passes):
    """Walking the rungs in order, as the per-rung loop did: a side of the
    ladder reads its body and waits for the last earlier side that added
    to that body (an active row's dynamic side); the sides that write are
    exactly those."""
    args, kw = passes["ladder"][0]
    cons, plan = args[0], kw["sweep_plan"]
    sides = plan.sides.numpy()
    dyn = torch.cat(solver._dyn_sides(cons)).numpy()
    c_rows = cons.body_a.shape[0]
    body = _side_bodies(plan, cons)
    last = {}
    checked = 0
    for _, r, idx in _class_sides(plan):
        m = r.rows
        rows = np.concatenate([np.arange(r.start, r.start + m)] * 2)
        side_dyn = dyn[rows + np.repeat([0, c_rows], m)]
        writes = (sides[idx, 3] & 1 != 0) & side_dyn
        for s, b, wr in zip(idx, body[idx], writes):
            assert sides[s, 2] == last.get(b, -1)
            assert sides[s, 1] == (b if wr else -1)
            checked += sides[s, 2] >= 0
        for s, b, wr in zip(idx, body[idx], writes):
            if wr:
                last[b] = s
    assert checked > 50  # bodies updated by several rungs


# ---------------------------------------------------------------------------
# the per-rung loop as it ran before one launch per sweep (the reference)
# ---------------------------------------------------------------------------


def _loop_sweep(sorted_cons, vels, n_imp_s, t_imp_s, layout_host, windows,
                chain=None, *, packed_fields, rhs_mode=None, rhs_consts=None,
                rhs_store=None, pose_tab=None, sweep_plan=None):
    offsets, counts = layout_host
    p_max = n_imp_s.shape[1]
    s_len = sorted_cons.tangent_a.shape[-2]
    pf2d, pf_meta = packed_fields
    n_bodies = vels.linear.shape[0]
    total = pf2d.shape[0]
    dyn_a, dyn_b = solver._dyn_sides(sorted_cons)
    packed0 = torch.cat([vels.linear, vels.angular], dim=-1)
    if rhs_mode == "biased":
        packed0 = torch.cat([packed0, pose_tab], dim=-1)
    pad_rows = 2 * sum(windows) if chain is not None else 2 * max(windows)
    buf = torch.cat([packed0, torch.zeros((pad_rows, packed0.shape[-1]))])
    pt = p_max * s_len
    imp_cols = [n_imp_s, t_imp_s.reshape(t_imp_s.shape[0], -1)]
    if rhs_mode is not None:
        imp_cols.append(rhs_store)
    imp = torch.cat(imp_cols, dim=1)
    w_off = 0
    for ci, w in enumerate(windows, start=1):
        if w == 0:
            continue
        start = solver._rung_start(offsets, ci, w, total)
        rows = slice(start, start + w)
        active = ((torch.arange(w) < counts[ci])
                  & sorted_cons.valid[start:start + w])
        win_i = imp[rows]
        prev_n = win_i[:, :p_max]
        prev_t = win_i[:, p_max:p_max + pt].reshape(w, p_max, s_len)
        ba, bb = sorted_cons.body_a[rows], sorted_cons.body_b[rows]
        if chain is not None:
            pp = buf[chain[0][2 * w_off:2 * w_off + 2 * w]]
        else:
            pp = buf[torch.cat([ba, bb])]
        p1, p2 = pp[:w], pp[w:]
        if rhs_mode is not None:
            kw = dict(mode=rhs_mode, consts=rhs_consts, p_max=p_max,
                      s_len=s_len)
            num_pts = sorted_cons.num_points[rows]
            if rhs_mode == "biased":
                new_n, new_t, d1, d2, rhs_wo = gs_math.gs_math_block_rhs(
                    pf2d[rows], pf_meta, num_pts, active, p1[:, :6],
                    p2[:, :6], prev_n, prev_t, pose1=p1[:, 6:],
                    pose2=p2[:, 6:], **kw)
            else:
                rhs_wo = win_i[:, p_max + pt:]
                new_n, new_t, d1, d2 = gs_math.gs_math_block_rhs(
                    pf2d[rows], pf_meta, num_pts, active, p1[:, :6],
                    p2[:, :6], prev_n, prev_t, n_rhs_wo=rhs_wo, **kw)
            new_cols = [new_n, new_t.reshape(w, -1), rhs_wo]
        else:
            view = SimpleNamespace(
                cfm_factor=sorted_cons.cfm_factor[rows],
                n_rhs=sorted_cons.n_rhs[rows], t_rhs=sorted_cons.t_rhs[rows],
                num_points=sorted_cons.num_points[rows])
            new_n, new_t, d1, d2 = gs_math.gs_math_block(
                pf2d[rows], pf_meta, view, active, p1, p2, prev_n, prev_t,
                p_max=p_max, s_len=s_len)
            new_cols = [new_n, new_t.reshape(w, -1)]
        if chain is not None:
            seg0 = n_bodies + 2 * w_off
            seg = buf[seg0:seg0 + 2 * w]
            seg.copy_(pp)
            seg[:w, :6] += d1
            seg[w:, :6] += d2
        else:
            trash = n_bodies + torch.arange(w)
            scatter = torch.cat([torch.where(active & dyn_a[rows], ba, trash),
                                 torch.where(active & dyn_b[rows], bb,
                                             trash + w)])
            buf.index_add_(0, scatter, torch.cat([d1, d2]))
        imp[rows] = torch.cat(new_cols, dim=1)
        w_off += w
    packed = buf[chain[1]] if chain is not None else buf[:n_bodies]
    out = (Velocity(packed[:, :3], packed[:, 3:6]), imp[:, :p_max],
           imp[:, p_max:p_max + pt].reshape(t_imp_s.shape))
    if rhs_mode is not None:
        return out + (imp[:, p_max + pt:],)
    return out


def _class_rows(args) -> np.ndarray:
    """Rows some rung runs: each class's rows inside its window."""
    offsets, counts = args[4]
    rows = [np.arange(offsets[ci], offsets[ci] + min(counts[ci], w))
            for ci, w in enumerate(args[5], start=1) if w]
    return np.concatenate(rows)


def _assert_plain_sweep_is_the_loop(args, kw):
    got = solver.gs_color_major_pass(*args, **kw)
    want = _loop_sweep(*args, **kw)
    for g, w in ((got[0].linear, want[0].linear),
                 (got[0].angular, want[0].angular), (got[1], want[1]),
                 (got[2], want[2])):
        assert torch.equal(g, w)
    assert not torch.equal(got[1], args[2])  # the impulses moved
    if len(got) == 4:
        # rhs_wo_bias: the loop also rewrote rows no rung runs (slots past
        # a class, padding) from whatever their fields were; nothing reads
        # them. The sweep leaves them as they came.
        rows = _class_rows(args)
        assert torch.equal(got[3][rows], want[3][rows])
        rest = np.setdiff1d(np.arange(got[3].shape[0]), rows)
        assert torch.equal(got[3][rest], kw["rhs_store"][rest])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("which", [0, 1], ids=["biased", "unbiased"])
def test_plain_sweep_equals_the_per_rung_loop_bit_for_bit(passes, name,
                                                          which):
    args, kw = passes[name][which]
    _assert_plain_sweep_is_the_loop(args, kw)


@pytest.mark.parametrize("chained, mode", [(True, "biased"),
                                           (True, "unbiased"), (True, None),
                                           (False, None)],
                         ids=["chained-biased", "chained-unbiased",
                              "chained", "ladder"])
def test_plain_sweep_equals_the_loop_at_p4_on_a_synthetic_layout(chained,
                                                                 mode):
    """P = 4 on ``chip_smoke.synthetic_pass``'s layout: static b-sides,
    invalid class rows, an empty class, windows wider than their classes."""
    args, kw = chip_smoke.synthetic_pass(np.random.default_rng(3), 4,
                                         chained=chained, rhs_mode=mode,
                                         device="cpu")
    assert kw.get("sweep_plan") is None
    _assert_plain_sweep_is_the_loop(args, kw)


def test_sweep_wrappers_refuse_cpu_tensors_and_uninstantiated_shapes(
        passes):
    """The one-launch sweeps run on the card only, at P in {1, 4} and
    S = 2; both refuse before touching a device."""
    for name, which, mode in (("chained_ps", 0, "biased"),
                              ("chained", 0, None)):
        args, kw = passes[name][which]
        cons, vels, n_imp, t_imp = args[:4]
        plan = kw["sweep_plan"]
        pf2d, meta = kw["packed_fields"]
        buf = torch.zeros((vels.linear.shape[0], 6))
        imp = torch.zeros((pf2d.shape[0], 4 if mode else 3))
        if mode:
            call = lambda p: gs_math.gs_sweep_rhs(  # noqa: E731
                plan, pf2d, meta, cons.num_points, buf, imp, mode=mode,
                consts=kw["rhs_consts"], p_max=p, s_len=2,
                pose=kw["pose_tab"])
        else:
            call = lambda p: gs_math.gs_sweep_block(  # noqa: E731
                plan, pf2d, meta, cons.cfm_factor, cons.n_rhs, cons.t_rhs,
                cons.num_points, buf, imp, p_max=p, s_len=2)
        launches = (gs_math.LAUNCHES, gs_math.LAUNCHES_BLOCK)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call(1)
        with pytest.raises(ValueError, match="not instantiated"):
            call(2)
        assert (gs_math.LAUNCHES, gs_math.LAUNCHES_BLOCK) == launches
