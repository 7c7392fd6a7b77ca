"""Uniform-grid broad phase by sorted cell keys (counterpart of
``wgmath_tpu/broad_phase/grid.py:find_pairs_grid``).

1. Outliers (extent > 3× the median) go to a dense global list of at most
   ``global_cap`` bodies; the cell size is the largest remaining extent.
2. Bodies sort by packed cell key (stable); each scans its 27 (3D) or 9
   (2D) neighbour cells, reading up to ``cell_cap`` occupants per cell.
3. The first ``cand_budget`` occupied slots per body are kept, the global
   columns appended, and exact AABB (plus sphere, for ball pairs) tests
   run on them.
4. Up to ``max_per_body`` hits per body compact into the output buffer.

Any exceeded budget makes the count negative (host regrows the budgets).
"""

from __future__ import annotations

import torch

from wgmath_tpu_torch.broad_phase.brute_force import PairList, compact_hits


def _neighbor_offsets(dim: int, device) -> torch.Tensor:
    r = torch.arange(-1, 2, device=device)
    g = torch.stack(torch.meshgrid(*([r] * dim), indexing="ij"), -1)
    return g.reshape(3 ** dim, dim)


def _pack_key(cells: torch.Tensor) -> torch.Tensor:
    """10 bits per axis in 3D, 15 in 2D; wraparound only adds
    candidates."""
    if cells.shape[-1] == 2:
        c = cells & 32767
        return c[..., 0] | (c[..., 1] << 15)
    c = cells & 1023
    return c[..., 0] | (c[..., 1] << 10) | (c[..., 2] << 20)


def top_k_desc(x: torch.Tensor, k: int):
    """``lax.top_k`` over the last axis: values descending, ties broken
    toward the lower index (a stable descending sort)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def find_pairs_grid(mins: torch.Tensor, maxs: torch.Tensor, *,
                    capacity: int, max_per_body: int = 16, cell_cap: int = 8,
                    global_cap: int = 64, cand_budget: int = 48,
                    active=None, ball_radius=None, margin: float = 0.0,
                    dynamic=None, row_offset=None,
                    row_count: int | None = None) -> PairList:
    """All overlapping AABB pairs (i < j) via the sorted uniform grid.

    ``active``: an optional [N] bool mask; inactive bodies enter neither
    the grid nor the global list. The median extent is then, as in the JAX
    package, entry ``N // 2`` of the extents sorted with the inactive ones
    as +inf (not the median of the active bodies).

    ``row_offset`` / ``row_count``: an optional row block; only rows in
    [offset, offset + count) emit pairs (each pair from its higher index,
    so disjoint blocks partition the pair set). The cell table stays
    global; rows past N are inactive, so any block partition is exact.
    ``row_offset`` is an int or a device scalar."""
    n, dim = mins.shape
    dev = mins.device
    n_off = 3 ** dim
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    ext_max = torch.amax(maxs - mins, dim=-1)
    inf = torch.full_like(ext_max, float("inf"))
    med = torch.sort(torch.where(active, ext_max, inf)).values[n // 2]
    glob_thr = torch.where(torch.isfinite(med), 3.0 * med, inf[0])
    is_global = active & (ext_max > glob_thr)
    cell = (torch.amax(torch.where(active & ~is_global, ext_max,
                                   torch.zeros_like(ext_max)))
            * 1.0001 + 1e-6)
    center = 0.5 * (mins + maxs)
    glob_overflow = is_global.sum() > global_cap
    gcap = min(global_cap, n)
    ids = torch.arange(n, device=dev)
    gscore = torch.where(is_global, n - ids, torch.zeros_like(ids))
    gtop = top_k_desc(gscore, gcap)[0]
    g_ids = torch.where(gtop > 0, n - gtop, torch.full_like(gtop, n - 1))
    g_valid = gtop > 0

    cells = torch.floor(center / cell).to(torch.int64)
    key = torch.where(active & ~is_global, _pack_key(cells),
                      torch.full_like(ids, 0x7FFFFFFF))
    skey, sid = torch.sort(key, stable=True)

    if row_count is None:
        nr, r_ids = n, ids
        r_active = active

        def rsl(x):
            return x
    else:
        nr = row_count
        r_ids = row_offset + torch.arange(nr, device=dev)
        r_clamp = torch.clamp(r_ids, max=n - 1)
        r_active = active[r_clamp] & (r_ids < n)

        def rsl(x):
            return x[r_clamp]
    r_mins, r_maxs, r_center = rsl(mins), rsl(maxs), rsl(center)
    nkeys = _pack_key(rsl(cells)[:, None, :]
                      + _neighbor_offsets(dim, dev)[None, :, :])  # [NR, 3^dim]
    dup = nkeys[:, :, None] == nkeys[:, None, :]
    earlier = torch.tril(torch.ones((n_off, n_off), dtype=torch.bool,
                                    device=dev), diagonal=-1)
    fresh = ~torch.any(dup & earlier[None], dim=-1)

    lo = torch.searchsorted(skey, nkeys.reshape(-1)).reshape(nr, n_off)
    spos = torch.arange(n, device=dev)
    is_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          skey[1:] != skey[:-1]])
    start_of_run = torch.cummax(
        torch.where(is_start, spos, torch.zeros_like(spos)), 0).values
    is_end = torch.cat([skey[1:] != skey[:-1],
                        torch.ones(1, dtype=torch.bool, device=dev)])
    end_of_run = torch.flip(torch.cummin(torch.flip(
        torch.where(is_end, spos, torch.full_like(spos, n - 1)), [0]),
        0).values, [0])
    run_len = end_of_run - start_of_run + 1
    lo_c = torch.clamp(lo, max=n - 1)
    found = skey[lo_c] == nkeys
    cnt = torch.where(found, run_len[lo_c], torch.zeros_like(lo_c))
    cell_overflow = torch.any(cnt > cell_cap)

    slots = torch.arange(cell_cap, device=dev)
    pos = torch.clamp(lo[:, :, None] + slots[None, None, :], max=n - 1)
    in_cell = (slots[None, None, :] < cnt[:, :, None]) & fresh[:, :, None]

    # the first cand_budget occupied slots, in slot order
    wide = n_off * cell_cap
    c_budget = min(cand_budget, wide)
    in_cell = in_cell.reshape(nr, wide)
    slot_ids = torch.arange(wide, device=dev)
    occ_score = torch.where(in_cell, wide - slot_ids,
                            torch.zeros_like(slot_ids))
    otop, osel = top_k_desc(occ_score, c_budget)
    cand_valid = otop > 0
    cand_overflow = torch.any(in_cell.sum(-1) > c_budget)
    pos_sel = torch.gather(pos.reshape(nr, wide), 1, osel)
    cand_sel = sid[pos_sel]

    cand_f = torch.cat([cand_sel, g_ids[None, :].expand(nr, gcap)], dim=1)
    mask_f = torch.cat([cand_valid, g_valid[None, :].expand(nr, gcap)],
                       dim=1)
    w = cand_f.shape[1]
    rows = r_ids[:, None]
    is_glob_row = rsl(is_global)[:, None]
    grid_cols = torch.arange(w, device=dev) < c_budget
    is_glob_col = ~grid_cols[None, :]
    # grid-grid pairs from the higher index; grid-global from the grid side
    order_ok = torch.where(is_glob_col & ~is_glob_row, True, rows > cand_f)
    mask_f = mask_f & order_ok & (cand_f != rows) & r_active[:, None]
    mask_f = mask_f & ~(is_glob_row & grid_cols[None, :])
    if dynamic is not None:
        mask_f = mask_f & (rsl(dynamic)[:, None] | dynamic[cand_f])
    c_mins, c_maxs = mins[cand_f], maxs[cand_f]
    overlap = torch.ones_like(mask_f)
    for a in range(dim):
        overlap &= ((r_mins[:, a:a + 1] <= c_maxs[..., a])
                    & (c_mins[..., a] <= r_maxs[:, a:a + 1]))
    if ball_radius is not None:
        c_center = center[cand_f]
        d2 = torch.zeros_like(c_center[..., 0])
        for a in range(dim):
            da = r_center[:, a:a + 1] - c_center[..., a]
            d2 = d2 + da * da
        lim = rsl(ball_radius)[:, None] + ball_radius[cand_f] + margin
        overlap = torch.where(torch.isfinite(lim), overlap & (d2 <= lim * lim),
                              overlap)
    mask_f = mask_f & overlap

    row_counts = mask_f.sum(-1)
    kk = min(max_per_body, w)
    row_overflow = torch.any(row_counts > kk) | cand_overflow
    if kk * 4 >= w * 3:
        hit, b_ids = mask_f, cand_f
        kk = w
    else:
        top = top_k_desc(torch.where(mask_f, n - cand_f,
                                     torch.zeros_like(cand_f)), kk)[0]
        hit, b_ids = top > 0, n - top
    a_ids = rows.expand(nr, kk)
    out_a, out_b, emit = compact_hits(hit, a_ids, b_ids, capacity)
    true_count = row_counts.sum()
    overflow = row_overflow | cell_overflow | glob_overflow
    count = torch.where(overflow, -torch.clamp(true_count, min=1),
                        true_count)
    valid = torch.arange(capacity, device=dev) < torch.clamp(emit,
                                                             max=capacity)
    return PairList(torch.minimum(out_a, out_b), torch.maximum(out_a, out_b),
                    valid, count)
