"""How B10 and B11 (``csrc/gs_fused.cu``) order one launch, on the CPU and
without JAX.

The kernels cut a launch into chunks taken from a ticket
(``gs_fused.fused_chunks``) and let a row wait only for its bodies'
previous writers (``gs_fused.prev_writers`` is the plain version of the
lookup each row makes) or, in B11, for its lanes' warmstart. Here the
lookup is held against a walk of the colour loop, the tickets against the
rows and lanes they must cover, and an emulation of the chunks' rows, run
in random waves that respect only those waits, against the plain versions
(``_fused_sweep_torch``, ``_substep1_torch``) bit for bit; B10's opening
lanes, which also carry B12's pose update when the launch has integrate
operands, run in those waves too, and the poses are ``_cm_integrate``'s
bit for bit. The layouts are
``chip_smoke.fused_inputs``'s: a proper colouring with static bodies, a
residue rung, two empty colours, and the same with one colour skipped
for its count though its tables name rows. The kernels themselves run on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from wgmath_tpu_torch.dynamics import build_fused, gs_fused
from wgmath_tpu_torch.dynamics.gs_math import _point_updates, rows_per_chunk
from wgmath_tpu_torch.dynamics.sim_params import SimParams
from tests.torch_threads import one_torch_thread  # noqa: F401

N_BODIES, WINDOWS, RUNG0 = 2000, (256,) * 12, 64
KERNELS = ("fused_sweep", "fused_substep1")
_CASES = {}


def _case(p_max):
    """(z, B10 and B11 as recorded calls) on the CPU, B9's matrix from its
    plain version; built once per p_max."""
    if p_max not in _CASES:
        rng = np.random.default_rng(90 + p_max)
        counts = [40] + [int(x) for x in rng.integers(0, 257, len(WINDOWS))]
        counts[-2:] = [0, 0]
        counts[3] = 256  # one colour as full as its window
        z = chip_smoke.fused_inputs(rng, N_BODIES, WINDOWS, RUNG0, counts,
                                    p_max, "cpu")
        meta, k_all = build_fused.field_meta(p_max, 2)
        p = SimParams()
        big = build_fused._build_torch(
            build_fused._packed_bodies(z["poses"], z["vels"], z["mprops"]),
            z["contacts"], (p.restitution, p.inv_dt, p.friction,
                            p.contact_cfm_factor), meta, k_all, p_max)
        op = chip_smoke.fused_operands(z, big, rng)
        calls = {c.name: c for c in chip_smoke.fused_calls(z, op)}
        calls["fused_sweep_integrate"] = chip_smoke.carrying_integrate(
            calls["fused_sweep"], op)
        _CASES[p_max] = z, calls
    return _CASES[p_max]


def _skipping(call, colour):
    """``call`` with colour ``colour``'s (0-based) count set to 0: the
    kernels skip it, whatever its tables name."""
    counts = call.args[-1].clone()
    assert counts[colour + 1] > 0
    counts[colour + 1] = 0
    return type(call)(name=call.name, kw=call.kw,
                      args=call.args[:-1] + (counts,))


def _walk_writers(idx, inv, counts, windows):
    """The colour loop walked row by row: before colour c, each body's
    latest writer so far (-1: none); a row writes its side's body where
    the inverse permutation names that row. Row C: after every colour."""
    c_n, w_g = inv.shape
    last = np.full(w_g, -1)
    out = []
    for c, rung in enumerate(windows):
        out.append(last.copy())
        if counts[c + 1] <= 0:
            continue
        for lane in range(2 * rung):
            b = idx[c, lane]
            if inv[c, b] == lane:
                last[b] = c
    out.append(last)
    return np.stack(out)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("p_max", [1, 4])
def test_prev_writers_equal_a_walk_of_the_colour_loop(p_max, skip):
    z, calls = _case(p_max)
    call = _skipping(calls["fused_sweep"], 1) if skip else \
        calls["fused_sweep"]
    idx, inv, counts = call.args[-3:]
    got = gs_fused.prev_writers(inv, counts, z["windows"]).numpy()
    want = _walk_writers(idx.numpy(), inv.numpy(), counts.numpy(),
                         z["windows"])
    np.testing.assert_array_equal(got, want)
    # the layout has what the lookup must get right: bodies written by
    # several colours, colours skipped for their counts, lanes never
    # written (static bodies, the trash lane)
    assert (got[-1] >= 0).any() and (got[-1] < 0).any()
    assert (got[1:-1] >= 0).sum() > (got[-1] >= 0).sum()
    assert (got[1] != got[2]).any() != skip  # colour 1 writes, or is skipped


@pytest.mark.parametrize("p_max", [1, 4])
@pytest.mark.parametrize("kernel", KERNELS)
def test_tickets_cover_every_row_and_lane_once_in_dependency_order(
        kernel, p_max):
    z, calls = _case(p_max)
    w_g = calls[kernel].args[0].shape[1]
    substep = kernel == "fused_substep1"
    t = gs_fused.fused_chunks(z["windows"], z["rung0"], w_g, p_max, substep)
    r = rows_per_chunk(p_max)
    _, offsets, ctot = gs_fused.fused_layout(z["windows"], z["rung0"])
    ranges = [t.deltas, t.opening] + list(zip(t.first, t.first[1:]))
    spans = sorted((a, b) for a, b in ranges if b > a)
    assert spans[0][0] == 0 and all(
        x[1] == y[0] for x, y in zip(spans, spans[1:]))  # disjoint, no gap
    rows = np.zeros(ctot, int)
    for c, w in enumerate(z["windows"]):
        for i in range(t.first[c + 1] - t.first[c]):
            j = np.arange(i * r, min((i + 1) * r, w))
            rows[offsets[c + 1] + j] += 1
    rows[:z["rung0"]] += 1  # the opening's residue rows
    assert (rows == 1).all()
    n_open = t.opening[1] - t.opening[0]
    assert n_open * r >= max(w_g, z["rung0"]) > (n_open - 1) * r
    if substep:  # deltas, the opening, then the colours
        assert t.deltas[1] * r * gs_fused.DELTA_ROWS >= ctot - z["rung0"]
        assert t.deltas[1] == t.opening[0] and t.opening[1] == t.first[0]
    else:  # the colours, then the opening; no delta chunk
        assert t.first[0] == 0 and t.opening[0] == t.first[-1]
        assert t.deltas[0] == t.deltas[1]


def _emulate(call, rng):
    """The rows and lanes of one launch's chunks, each run once its waits
    are met, in waves of random membership (every read of a wave before
    its writes, as on the card); returns the outputs, with NaN wherever no
    chunk wrote, and checks that each impulse element is written once and
    that every wait points at a lower ticket. B11's delta chunks read
    inputs only and come first (every lane waits on their count), so
    their deltas are taken as given: ``_ws_color``'s per lane. B10's
    opening lanes have no wait; with integrate operands they return the
    new poses too."""
    substep = call.name == "fused_substep1"
    kw = dict(call.kw)
    integrate = kw.pop("integrate", None)
    windows, rung0, p_max = kw["windows"], kw["rung0"], kw["p_max"]
    s_len, meta = kw["s_len"], kw["meta"]
    if substep:
        (vt, n_imp, t_imp, win, src, pose, active, nump, idx, inv,
         counts) = call.args
        ws, cfm = kw["scalars"][0], kw["scalars"][1]
        inv_dt, erp_inv_dt, allowed, max_corr = kw["scalars"][2:]
        n_in, t_in = n_imp * ws, t_imp * ws
    else:
        (vt, n_imp, t_imp, win, active, nump, cfm, n_rhs, t_rhs, idx, inv,
         counts) = call.args
        n_in, t_in = n_imp, t_imp
    w_g = vt.shape[1]
    _, offsets, ctot = gs_fused.fused_layout(windows, rung0)
    tickets = gs_fused.fused_chunks(windows, rung0, w_g, p_max, substep)
    r = rows_per_chunk(p_max)
    prev = gs_fused.prev_writers(inv, counts, windows).numpy()
    idx_h, inv_h = idx.numpy(), inv.numpy()
    act = active[0].numpy() > 0.5
    occupied = [int(counts[c + 1]) > 0 for c in range(len(windows))]

    vout = torch.full_like(vt, float("nan"))
    nout = torch.full((p_max, ctot), float("nan"))
    tout = torch.full((p_max * s_len, ctot), float("nan"))
    nwo = torch.full((p_max, ctot), float("nan"))
    written = np.zeros(ctot, int)

    def copy_rows(cols):
        nout[:, cols], tout[:, cols] = n_in[:, cols], t_in[:, cols]
        nwo[:, cols] = 0.0
        written[cols] += 1

    # the rows no sweep runs: the residue (opening), unoccupied colours
    copy_rows(np.arange(rung0))
    for c, w in enumerate(windows):
        if not occupied[c]:
            copy_rows(offsets[c + 1] + np.arange(w))
    if substep:
        # B11's warmstart per lane: the deltas of the rows each colour's
        # inverse permutation names, in colour order (_ws_color's
        # arithmetic); its rhs (_rhs_color), which reads inputs only
        ws_tables, rhs = [], {}
        for c, w in enumerate(windows):
            if not occupied[c]:
                continue
            off = int(offsets[c + 1])
            ws_tables.append(gs_fused._ws_color(
                off, w, w_g, n_in, t_in, win, active, nump, inv[c], meta,
                p_max, s_len))
            rhs[c] = gs_fused._rhs_color(
                off, w, pose, idx[c], win, src, kw["src_meta"], meta, p_max,
                s_len, w_g, inv_dt=inv_dt, erp_inv_dt=erp_inv_dt,
                allowed_err=allowed, max_corr=max_corr)
    else:
        # B10's opening lanes copy rows 6-7 and the rows 0-5 no colour
        # writes, and integrate from the input velocities
        free = prev[-1] < 0
        pose_out = torch.full((8, w_g), float("nan"))

    def ticket(c, j):
        return tickets.first[c] + j // r

    # every row of an occupied colour, with its waits
    tasks, deps = [], {}
    for c, w in enumerate(windows):
        if not occupied[c]:
            continue
        for j in range(w):
            col = int(offsets[c + 1]) + j
            ba, bb = int(idx_h[c, j]), int(idx_h[c, w + j])
            own = (inv_h[c, ba] == j, inv_h[c, bb] == w + j)
            need = bool(act[col] or own[0] or own[1])
            task = ("row", c, j, col, ba, bb, own, need)
            waits = []
            for b in (ba, bb) if need else ():
                p = prev[c, b]
                if p >= 0:
                    jj = int(inv_h[p, b])
                    jw = jj if jj < windows[p] else jj - windows[p]
                    waits.append(("row", p, jw))
                    assert ticket(p, jw) < ticket(c, j)
                elif substep:
                    waits.append(("lane", b))
                    assert (tickets.opening[0] + b // r) < ticket(c, j)
            tasks.append(task)
            deps[("row", c, j)] = waits
    for b in range(w_g):
        tasks.append(("lane", b))
        deps[("lane", b)] = []

    def key(task):
        return task[:3] if task[0] == "row" else task

    def run_wave(wave):
        lanes = [t[1] for t in wave if t[0] == "lane"]
        rows = [t for t in wave if t[0] == "row"]
        # reads first
        if lanes:
            v = vt[:, lanes]
            if substep:
                for table in ws_tables:
                    v = v + table[:, lanes]
            elif integrate is not None:
                pose, com, dt = integrate
                poses = gs_fused._cm_integrate(pose, vt, com, dt)[:, lanes]
        if rows:
            cols = [t[3] for t in rows]
            reads = []
            for side in (4, 5):
                v_side = torch.zeros((6, len(rows)))
                for i, t in enumerate(rows):
                    b = t[side]
                    if not t[7]:
                        continue
                    c_prev = prev[t[1], b]
                    v_side[:, i] = (vout if c_prev >= 0 or substep
                                    else vt)[0:6, b]
                reads.append(v_side)
            m = len(rows)
            if substep:
                n_r = torch.stack([rhs[t[1]][0][:, t[2]] for t in rows], 1)
                n_wo = torch.stack([rhs[t[1]][1][:, t[2]] for t in rows], 1)
                t_r = torch.stack([rhs[t[1]][2][:, t[2]] for t in rows], 1)
            else:
                n_r, t_r = n_rhs[:, cols], t_rhs[:, cols]
            f = gs_fused._fields_cm(
                win[:, cols], meta,
                (torch.full((1, m), float(cfm)), n_r.reshape(p_max, m),
                 t_r.reshape(p_max, s_len, m), nump[:, cols],
                 active[:, cols]), p_max, s_len)
            rm = {nm: f[nm].movedim(-1, 0) for nm in gs_fused.UPDATE_FIELDS}
            rm["limit"] = f["limit"].reshape(m)
            new_n, new_t, d1, d2 = _point_updates(
                rm, f["cfm"].reshape(m), f["n_rhs"].movedim(-1, 0),
                f["t_rhs"].movedim(-1, 0), f["nump"].reshape(m),
                f["active"].reshape(m) > 0.5, reads[0].T, reads[1].T,
                n_in[:, cols].T, t_in[:, cols].T.reshape(m, p_max, s_len),
                p_max)
        # then writes
        if lanes and substep:
            vout[:, lanes] = v
        elif lanes:
            vout[6:8, lanes] = v[6:8]
            mine = [b for b in lanes if free[b]]
            vout[0:6, mine] = vt[0:6, mine]
            if integrate is not None:
                pose_out[:, lanes] = poses
        if rows:
            nout[:, cols] = new_n.T
            tout[:, cols] = new_t.reshape(m, p_max * s_len).T
            if substep:
                nwo[:, cols] = n_wo
            written[cols] += 1
            for i, t in enumerate(rows):
                for side, d in ((4, d1), (5, d2)):
                    if t[6][side - 4]:
                        vout[0:6, t[side]] = reads[side - 4][:, i] + d[i]

    done, todo = set(), list(tasks)
    while todo:
        ready = [t for t in todo if all(d in done for d in deps[key(t)])]
        assert ready, "a wait that nothing releases"
        pick = rng.random(len(ready)) < 0.5
        pick[rng.integers(len(ready))] = True
        wave = [t for t, p in zip(ready, pick) if p]
        run_wave(wave)
        done.update(key(t) for t in wave)
        taken = {key(t) for t in wave}
        todo = [t for t in todo if key(t) not in taken]
    assert (written == 1).all()
    if substep:
        return vout, nout, tout, nwo
    return (vout, nout, tout) + ((pose_out,) if integrate is not None else ())


@pytest.mark.parametrize("seed,skip", [(0, False), (1, False), (2, True)])
@pytest.mark.parametrize("p_max", [1, 4])
@pytest.mark.parametrize("kernel", KERNELS + ("fused_sweep_integrate",))
def test_chunks_in_any_order_the_waits_allow_give_the_plain_bits(
        kernel, p_max, seed, skip):
    _, calls = _case(p_max)
    call = _skipping(calls[kernel], 1) if skip else calls[kernel]
    plain = {"fused_sweep": gs_fused._fused_sweep_plain,
             "fused_substep1": gs_fused._substep1_torch}[call.name]
    want = plain(*call.args, **call.kw)
    got = _emulate(call, np.random.default_rng(seed))
    assert len(got) == len(want) == (
        3 if kernel == "fused_sweep" else 4)
    if "integrate" in call.kw:
        pose, com, dt = call.kw["integrate"]
        assert torch.equal(got[3], gs_fused._cm_integrate(
            pose, call.args[0], com, dt))
    for g, w in zip(got, want):
        assert not torch.isnan(g).any()
        assert torch.equal(g, w)
