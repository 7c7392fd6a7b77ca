"""LBVH broad phase: a Karras-2012 linear BVH (counterpart of
``wgmath_tpu/broad_phase/lbvh.py``; plain PyTorch, as it is XLA there).

- Morton codes of the box centres in the domain box, a stable argsort;
- every internal node's range and split computed independently by
  common-prefix searches (equal codes tie-break on the index: 32 plus the
  leading zeros of ``i ^ j``), in fixed loops that need no host read
  (grow 31, shrink 32, split 32 rounds);
- refit: ``refit_rounds`` rounds of "internal box = union of children";
- traversal: the JAX package's per-leaf stack walk, one tree level a round
  over every (query, node) pair still open (:func:`_traverse`), with one
  host read a round; it finds the nodes the stack walk visits, and orders
  each leaf's pairs as that walk emits them.

Tree layout (n leaves): nodes 0..n-2 are internal; a child id below n-1 is
an internal node, else leaf ``id - (n-1)``. ``node_min`` / ``node_max``
hold the internal nodes, then the leaves in sorted order.
"""

from __future__ import annotations

import dataclasses

import torch

from wgmath_tpu_torch.broad_phase.brute_force import PairList
from wgmath_tpu_torch.broad_phase.morton import clz32, morton_codes
from wgmath_tpu_torch.core.dispatch import host_int

_PER_LEAF_CAP = 64
_BIG = 3.0e38


@dataclasses.dataclass
class Lbvh:
    """A built tree over n leaves."""

    left: torch.Tensor  # i64 [n-1] child id (internal < n-1, else leaf+n-1)
    right: torch.Tensor  # i64 [n-1]
    node_min: torch.Tensor  # [2n-1, dim]: internal nodes, then leaves
    node_max: torch.Tensor  # [2n-1, dim]
    order: torch.Tensor  # i64 [n]: leaf k -> body index

    @property
    def num_leaves(self) -> int:
        return self.order.shape[0]


def _delta_fn(codes: torch.Tensor):
    """delta(i, j): the common prefix length of the keys (code, index),
    -1 where j lies outside [0, n)."""
    n = codes.shape[0]

    def delta(i, j):
        valid = (j >= 0) & (j < n)
        j_c = torch.clamp(j, 0, n - 1)
        x = codes[i] ^ codes[j_c]
        # equal codes: 32 plus the leading zeros of i ^ j
        tie = x == 0
        d = clz32(torch.where(tie, i ^ j_c, x)) + 32 * tie
        return torch.where(valid, d, -1)

    return delta


def build(mins: torch.Tensor, maxs: torch.Tensor, *,
          refit_rounds: int = 48) -> Lbvh:
    """Build the LBVH from the leaf boxes."""
    n, dim = mins.shape
    dev = mins.device
    centers = 0.5 * (mins + maxs)
    codes = morton_codes(centers, torch.amin(mins, dim=0),
                         torch.amax(maxs, dim=0))
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    smin, smax = mins[order], maxs[order]

    delta = _delta_fn(codes)
    i = torch.arange(n - 1, device=dev)
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    delta_min = delta(i, i - d)

    # doubling upper bound of the range length
    lmax = torch.full_like(i, 2)
    for _ in range(31):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2,
                           lmax)
    # binary search of the range end: lmax/2, lmax/4, ..., 1
    l, step = torch.zeros_like(i), lmax >> 1
    for _ in range(32):
        grow = (step >= 1) & (delta(i, i + (l + step) * d) > delta_min)
        l = torch.where(grow, l + step, l)
        step = torch.clamp(step >> 1, min=0)
    j = i + l * d
    delta_node = delta(i, j)
    # split: the largest s with delta(i, i + s*d) > delta_node
    s, step = torch.zeros_like(i), l
    for _ in range(32):
        step = (step + 1) >> 1
        s = torch.where(delta(i, i + (s + step) * d) > delta_node, s + step,
                        s)
    gamma = i + s * d + torch.clamp(d, max=0)
    lo, hi = torch.minimum(i, j), torch.maximum(i, j)
    left = torch.where(lo == gamma, gamma + (n - 1), gamma)
    right = torch.where(hi == gamma + 1, gamma + n, gamma + 1)

    # refit: a fixed number of "internal = union of children" rounds
    node_min = torch.cat([torch.full((n - 1, dim), _BIG, dtype=mins.dtype,
                                     device=dev), smin])
    node_max = torch.cat([torch.full((n - 1, dim), -_BIG, dtype=maxs.dtype,
                                     device=dev), smax])
    for _ in range(refit_rounds):
        new_min = torch.minimum(node_min[left], node_min[right])
        new_max = torch.maximum(node_max[left], node_max[right])
        node_min = torch.cat([new_min, node_min[n - 1:]])
        node_max = torch.cat([new_max, node_max[n - 1:]])
    return Lbvh(left, right, node_min, node_max, order)


def _traverse(tree: Lbvh, qmin: torch.Tensor, qmax: torch.Tensor):
    """The later-ranked leaves each leaf's box overlaps, as the JAX
    package's stack walk finds them.

    That walk (a 64-entry stack a leaf, the right child pushed last)
    visits a node when every ancestor's box overlaps the query, and emits
    a leaf's pairs in a right-first preorder: in descending leaf rank,
    since a node's right subtree holds the higher ranks. Here every open
    (query, node) pair of one tree level is tested in one round, children
    of the overlapping internal nodes forming the next round, so the
    rounds are the tree's depth and not a walk's length. Its stack cannot
    overflow: a child's common prefix is longer than its parent's, and a
    prefix is 2 to 63 bits, so a walk holds at most 63 entries. Returns
    (the exact count a leaf [n], its first ``_PER_LEAF_CAP`` partners'
    ranks in walk order [n, cap], zeros past the count)."""
    n = tree.num_leaves
    dev = qmin.device
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    window = torch.zeros((n, _PER_LEAF_CAP), dtype=torch.int64, device=dev)
    if n < 2:
        return counts, window
    kids = torch.stack([tree.left, tree.right], dim=1)
    q_box = torch.cat([qmax, -qmin], dim=1)
    n_box = torch.cat([tree.node_min, -tree.node_max], dim=1)
    lane = torch.arange(n, device=dev)
    node = torch.zeros_like(lane)  # every query starts at the root
    hit_lane, hit_leaf = [], []
    while True:
        overlap = torch.all(n_box[node] <= q_box[lane], dim=1)
        # a leaf after the query's own (node ids past n - 1 are leaves)
        emit = overlap & (node > lane + (n - 1))
        hit_lane.append(torch.where(emit, lane, n))
        hit_leaf.append(node - (n - 1))
        push = overlap & (node < n - 1)
        m = host_int(push.sum())
        if m == 0:
            break
        keep = torch.argsort((~push).to(torch.int8), stable=True)[:m]
        lane = lane[keep][:, None].expand(m, 2).reshape(-1)
        node = kids[node[keep]].reshape(-1)
    hit_lane, hit_leaf = torch.cat(hit_lane), torch.cat(hit_leaf)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, hit_lane, torch.ones_like(hit_lane))[:n]
    # each query's hits, its highest partner rank first (the walk's order);
    # misses (lane n) last
    order = torch.argsort(hit_lane * n + (n - 1 - hit_leaf))
    lane_s, leaf_s = hit_lane[order], hit_leaf[order]
    first = torch.cumsum(counts, 0) - counts
    hit = lane_s < n
    slot = torch.arange(lane_s.shape[0], device=dev) - first[
        torch.clamp(lane_s, max=n - 1)]
    slot = torch.where(hit & (slot < _PER_LEAF_CAP), slot, _PER_LEAF_CAP)
    window = torch.cat([window, window[:, :1]], dim=1)  # a trash column
    window[torch.clamp(lane_s, max=n - 1), slot] = leaf_s
    return counts, window[:, :_PER_LEAF_CAP]


def find_pairs_lbvh(mins: torch.Tensor, maxs: torch.Tensor, *,
                    capacity: int) -> PairList:
    """Overlapping box pairs (a < b) through the LBVH.

    Each leaf keeps at most ``_PER_LEAF_CAP`` pairs, and the windows pack
    by an exclusive scan into ``capacity`` slots. ``count`` is the exact
    pair count; where a leaf overflowed its window it is at least
    ``capacity + 1``, so the host regrows the capacity."""
    n = mins.shape[0]
    dev = mins.device
    tree = build(mins, maxs)
    counts, window = _traverse(tree, tree.node_min[n - 1:],
                               tree.node_max[n - 1:])
    total = counts.sum()
    counts_c = torch.clamp(counts, max=_PER_LEAF_CAP)
    emitted = counts_c.sum()
    offsets = torch.cumsum(counts_c, 0) - counts_c
    slot = torch.arange(_PER_LEAF_CAP, device=dev)
    pos = offsets[:, None] + slot[None, :]
    keep = (slot[None, :] < counts_c[:, None]) & (pos < capacity)
    pos = torch.where(keep, pos, torch.full_like(pos, capacity)).reshape(-1)
    a_flat = tree.order[:, None].expand_as(window).reshape(-1)
    b_flat = tree.order[window.reshape(-1)]
    out_a = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    out_b = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    out_a.scatter_(0, pos, a_flat)
    out_b.scatter_(0, pos, b_flat)
    out_a, out_b = out_a[:capacity], out_b[:capacity]
    total = torch.where(torch.any(counts > _PER_LEAF_CAP),
                        torch.clamp(total, min=capacity + 1), total)
    valid = torch.arange(capacity, device=dev) < torch.clamp(emitted,
                                                             max=capacity)
    return PairList(torch.minimum(out_a, out_b), torch.maximum(out_a, out_b),
                    valid, total)
