"""Brute-force broad phase (counterpart of
``wgmath_tpu/broad_phase/brute_force.py``: ``PairList`` and ``find_pairs``).

Row-blocked pairwise overlap tests with a cumsum + scatter compaction into
a fixed-capacity pair buffer. Each unordered pair is emitted by its higher
index row, in ascending column order; a row with more than
``max_per_row`` hits flips the count negative (host regrows the budget).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class PairList:
    """Fixed-capacity collision pair buffer + true overlap count."""

    body_a: torch.Tensor  # i64 [C]
    body_b: torch.Tensor  # i64 [C]
    valid: torch.Tensor  # bool [C]
    count: torch.Tensor  # i64 [] (negative on a budget overflow)

    @property
    def capacity(self) -> int:
        return self.body_a.shape[0]


def compact_hits(hit: torch.Tensor, a_ids: torch.Tensor, b_ids: torch.Tensor,
                 capacity: int, start=0):
    """Scatter the set entries of ``hit`` (row-major order) into
    ``capacity`` slots starting at ``start``; overflow is dropped.
    Returns (out_a, out_b, n_hits)."""
    flat = hit.reshape(-1)
    local = torch.cumsum(flat.to(torch.int64), 0) - 1 + start
    pos = torch.where(flat, local, torch.full_like(local, capacity))
    pos = torch.clamp(pos, max=capacity)
    dev = hit.device
    out_a = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    out_b = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    out_a.scatter_(0, pos, a_ids.reshape(-1).to(torch.int64))
    out_b.scatter_(0, pos, b_ids.reshape(-1).to(torch.int64))
    return out_a[:capacity], out_b[:capacity], flat.sum()


def find_pairs(mins: torch.Tensor, maxs: torch.Tensor, *, capacity: int,
               active=None, block: int = 256, max_per_row: int = 64,
               ball_radius=None, margin: float = 0.0,
               dynamic=None) -> PairList:
    """All overlapping AABB pairs (i < j) compacted into ``capacity`` slots.
    ``ball_radius`` (NaN for non-balls) switches ball-ball candidates to the
    exact sphere test; ``dynamic`` drops static-static pairs."""
    n = mins.shape[0]
    dev = mins.device
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=dev)
    cols = torch.arange(n, device=dev)
    kk = min(max_per_row, n)
    if ball_radius is not None:
        centers = 0.5 * (mins + maxs)
    out_a = torch.zeros(capacity, dtype=torch.int64, device=dev)
    out_b = torch.zeros(capacity, dtype=torch.int64, device=dev)
    emit = torch.zeros((), dtype=torch.int64, device=dev)
    true_count = torch.zeros((), dtype=torch.int64, device=dev)
    row_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    for r0 in range(0, n, block):
        rows = torch.arange(r0, min(r0 + block, n), device=dev)
        overlap = torch.all((mins[rows][:, None, :] <= maxs[None])
                            & (mins[None] <= maxs[rows][:, None, :]), dim=-1)
        if ball_radius is not None:
            d2 = torch.sum((centers[rows][:, None, :] - centers[None]) ** 2,
                           dim=-1)
            lim = ball_radius[rows][:, None] + ball_radius[None] + margin
            overlap = torch.where(torch.isfinite(lim),
                                  overlap & (d2 <= lim * lim), overlap)
        m = overlap & (rows[:, None] > cols[None, :])
        m &= active[rows][:, None] & active[None, :]
        if dynamic is not None:
            m &= dynamic[rows][:, None] | dynamic[None, :]
        row_counts = m.sum(-1)
        row_overflow |= torch.any(row_counts > kk)
        # the first kk hits of each row, in ascending column order
        hit = m & (torch.cumsum(m.to(torch.int64), -1) <= kk)
        a_ids = rows[:, None].expand_as(hit)
        b_ids = cols[None, :].expand_as(hit)
        blk_a, blk_b, n_hit = compact_hits(hit, a_ids, b_ids, capacity,
                                           start=emit)
        slots = torch.arange(capacity, device=dev)
        written = (slots >= emit) & (slots < emit + n_hit)
        out_a = torch.where(written, blk_a, out_a)
        out_b = torch.where(written, blk_b, out_b)
        emit = emit + n_hit
        true_count = true_count + row_counts.sum()
    valid = torch.arange(capacity, device=dev) < torch.clamp(emit,
                                                             max=capacity)
    count = torch.where(row_overflow, -torch.clamp(true_count, min=1),
                        true_count)
    return PairList(torch.minimum(out_a, out_b), torch.maximum(out_a, out_b),
                    valid, count)
