"""Two-level cluster acceleration for mesh queries (counterpart of
``wgmath_tpu/queries/mesh_accel.py``).

The tree has exactly two levels with wide leaves. The build (host numpy,
once a mesh) Morton-sorts the primitives by centroid, pads each mesh's
index range to a multiple of ``MESH_LEAF`` and keeps one AABB a run of
``MESH_LEAF`` primitives, a *cluster*: cluster id = primitive id //
``MESH_LEAF``, with no pointers. A query tests every cluster's AABB at
once, then expands the K best remaining clusters a round until a lower
bound proves the running best exact (:func:`point_topk_prims`; the ray
loop in ``queries/ray.py``).

The JAX package's rounds are a ``lax.while_loop``; here each round ends
with one counted host read of its exit test (``core.dispatch.host_int``),
and every row runs every round, as in the JAX loop, so the ids are the
same. ``lax.top_k`` orders equal values by the lower index; so does
:func:`smallest_k`, which the rounds select with (``torch.topk`` promises
no order among ties, and cluster distances tie at 0 routinely). The
cluster distances are plain float32 (the [P, C] passes): they order the
rounds' expansions and bound what is left, and an ulp there moves no
certified triangle but one tied with the k-th to the ulp; the triangle
scores carry the JAX package's CPU rounding (``gjk.norm_fma``), so equal
ones tie alike."""

from __future__ import annotations

import numpy as np
import torch

from wgmath_tpu_torch.core.dispatch import host_int
from wgmath_tpu_torch.queries.gjk import _norm3

MESH_LEAF = 32  # primitives a cluster (index ranges pad to this multiple)
# below this primitive count the dense [queries, primitives] sweep is taken
ACCEL_MIN_PRIMS = 2048


def _morton3(x: np.ndarray) -> np.ndarray:
    """10-bit quantized coordinates interleaved into Morton codes."""
    q = np.clip((x * 1024.0), 0, 1023).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    out = np.zeros(len(x), np.uint32)
    for axis in range(x.shape[1]):
        out |= spread(q[:, axis]) << axis
    return out


def build_clusters(vertices: np.ndarray, indices: np.ndarray,
                   margin: float = 0.0):
    """Morton-order ``indices`` and cut them into MESH_LEAF clusters.

    Returns ``(indices_out, cluster_min, cluster_max)`` (numpy): the
    reordered index buffer padded to a multiple of MESH_LEAF (pad rows
    repeat the last primitive; every query masks them out by the shape's
    ``num_idx``) and the AABBs of each cluster's real primitives, dilated
    by ``margin``."""
    vertices = np.asarray(vertices, np.float32)
    indices = np.asarray(indices, np.int32)
    t = len(indices)
    if t == 0:
        dim = vertices.shape[1] if vertices.ndim == 2 else 3
        return (indices, np.zeros((0, dim), np.float32),
                np.zeros((0, dim), np.float32))
    prim = vertices[indices]  # [T, k, dim]
    cent = prim.mean(axis=1)
    lo, hi = cent.min(0), cent.max(0)
    norm = (cent - lo) / np.maximum(hi - lo, 1e-9)
    order = np.argsort(_morton3(norm), kind="stable")
    indices = indices[order]

    pad = (-t) % MESH_LEAF
    if pad:
        indices = np.concatenate([indices, np.repeat(indices[-1:], pad, 0)])
    c = len(indices) // MESH_LEAF
    prim = vertices[indices].reshape(c, MESH_LEAF, *prim.shape[1:])
    valid = (np.arange(c * MESH_LEAF) < t).reshape(c, MESH_LEAF)
    big = np.float32(3e38)
    pmin = np.where(valid[..., None, None], prim, big).min(axis=(1, 2))
    pmax = np.where(valid[..., None, None], prim, -big).max(axis=(1, 2))
    return indices, pmin - margin, pmax + margin


def cluster_range(first_idx, num_idx):
    """Each shape's first cluster and cluster count from its (aligned)
    index range."""
    return first_idx // MESH_LEAF, -(-num_idx // MESH_LEAF)


def use_clusters(shapes, min_prims: int = ACCEL_MIN_PRIMS) -> bool:
    """Static predicate: the shape set takes the clustered route."""
    return (shapes.cluster_min.shape[0] > 0
            and shapes.indices.shape[0] >= min_prims)


def gather_prims(shapes, cand: torch.Tensor) -> tuple:
    """Vertices of candidate primitives: ids [P, M] → one [P, M, dim]
    array a corner."""
    idx = torch.clamp(cand, 0, max(shapes.indices.shape[0] - 1, 0))
    prim = shapes.indices[idx]
    return tuple(shapes.vertices[prim[..., i]]
                 for i in range(shapes.indices.shape[1]))


def smallest_k(x: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row of ``x`` [R, M] and their
    columns, ascending, equal values by the lower column first: the order
    of ``lax.top_k(-x, k)``. ``torch.topk`` gives the k-th value; the
    entries below it and the first ones equal to it are kept, then sorted
    stably. A few passes over ``x``, where a stable sort of every row
    would be one sort of R x M."""
    if k >= x.shape[-1]:
        v, i = torch.sort(x, dim=-1, stable=True)
        return v[..., :k], i[..., :k]
    kth = torch.topk(x, k, dim=-1, largest=False).values.amax(
        dim=-1, keepdim=True)
    below = x < kth
    tie = x == kth
    need = k - below.sum(-1, keepdim=True)
    keep = below | (tie & (torch.cumsum(tie.to(torch.int32), -1) <= need))
    slot = torch.where(keep, torch.cumsum(keep.to(torch.int32), -1) - 1, k)
    cols = torch.arange(x.shape[-1], device=x.device).expand_as(x)
    idx = torch.zeros(x.shape[:-1] + (k + 1,), dtype=torch.int64,
                      device=x.device)
    idx.scatter_(-1, slot.to(torch.int64), cols)
    idx = idx[..., :k]
    v, order = torch.sort(torch.gather(x, -1, idx), dim=-1, stable=True)
    return v, torch.gather(idx, -1, order)


def point_topk_prims(shapes, first_idx, num_idx, point, k_best: int,
                     score_fn, offset=None, k_clusters: int = 4,
                     max_score=1e8, rounds: list | None = None):
    """The exact ``k_best`` best primitives by ``score_fn`` around
    ``point`` (mesh-local [P, dim]) by rounds of cluster expansion.

    A round expands the ``k_clusters`` nearest remaining clusters of every
    row, scores their primitives and merges them into a running top-k. The
    rounds end when no row has a remaining cluster whose point-to-AABB
    distance minus ``offset`` is below both its k-th best score and
    ``max_score`` (a scalar or one value a row): exact whenever ``score >=
    dist(point, cluster AABB) - offset`` for every primitive of a cluster.
    ``score_fn(point[:, None, :], *prim_verts) -> [P, M]`` (smaller is
    better; rows out of range are masked to 1e9). Returns ``(ids,
    scores)``: global primitive ids [P, k_best] and their scores (1e9
    padding). ``rounds``, if given, gets the number of rounds appended
    (each ends with one host read)."""
    cmin, cmax = shapes.cluster_min, shapes.cluster_max
    dev = point.device
    n_q = point.shape[0]
    fc, nc = cluster_range(first_idx, num_idx)
    cid = torch.arange(cmin.shape[0], device=dev)
    in_range = ((cid[None, :] >= fc[:, None])
                & (cid[None, :] < (fc + nc)[:, None]))
    d_cl = _norm3(torch.clamp(torch.maximum(
        cmin[None] - point[:, None, :], point[:, None, :] - cmax[None]),
        min=0.0))
    d_rem = torch.where(in_range, d_cl, torch.inf)  # [P, C]
    offset = torch.broadcast_to(
        torch.as_tensor(0.0 if offset is None else offset,
                        dtype=point.dtype, device=dev), (n_q,))
    lane = torch.arange(MESH_LEAF, device=dev)
    last = (first_idx + num_idx)[:, None]
    best_s = torch.full((n_q, k_best), 1e9, device=dev)
    best_i = torch.zeros((n_q, k_best), dtype=torch.int64, device=dev)
    n_rounds = 0
    while True:
        limit = (torch.clamp(best_s[:, -1], max=max_score)
                 if not torch.is_tensor(max_score)
                 else torch.minimum(best_s[:, -1], max_score))
        frontier = torch.amin(d_rem, dim=-1) - offset
        if not host_int(torch.any(frontier < limit)):
            break
        n_rounds += 1
        neg, sel = smallest_k(d_rem, k_clusters)
        cand = (sel[:, :, None] * MESH_LEAF + lane).reshape(
            n_q, k_clusters * MESH_LEAF)
        s = score_fn(point[:, None, :], *gather_prims(shapes, cand))
        ok = ((cand >= first_idx[:, None]) & (cand < last)
              & torch.isfinite(neg).repeat_interleave(MESH_LEAF, dim=1))
        s = torch.where(ok, s, 1e9)
        best_s, pick = smallest_k(torch.cat([best_s, s], dim=1), k_best)
        best_i = torch.gather(torch.cat([best_i, cand], dim=1), 1, pick)
        d_rem = d_rem.scatter(1, sel, torch.inf)
    if rounds is not None:
        rounds.append(n_rounds)
    return best_i, best_s
