"""Host-side scene-build kernels (counterpart of ``wgmath_tpu/native``):
greedy colouring of the joint graph and a median-split BVH over
primitive AABBs, through the library ``wgnative.cpp`` that
``core/native_build.py`` builds at first use.

:func:`greedy_color` is the library's ``wg_greedy_color``;
:func:`greedy_color_plain` is its plain Python twin. Past 64 colours the
library gives up (it keeps one 64-bit mask a body) and the colouring is
finished by the twin, which has no cap, as the JAX package does.
:func:`build_bvh` is ``wg_build_bvh`` and :func:`build_bvh_plain` its
twin: the same tree wherever no two primitives tie on a split axis (the
library partitions with ``nth_element``, the twin sorts stably)."""

from __future__ import annotations

import ctypes

import numpy as np

from wgmath_tpu_torch.core import native_build


def _inputs(body_a, body_b, dynamic, valid):
    body_a = np.ascontiguousarray(body_a, np.int32)
    body_b = np.ascontiguousarray(body_b, np.int32)
    if valid is None:
        valid = np.ones(len(body_a), np.uint8)
    dynamic = np.ascontiguousarray(dynamic, np.uint8)
    valid = np.ascontiguousarray(valid, np.uint8)
    if not (len(body_b) == len(valid) == len(body_a)):
        raise ValueError("body_a, body_b and valid differ in length")
    return body_a, body_b, dynamic, valid


def greedy_color_plain(body_a, body_b, dynamic, valid=None) -> np.ndarray:
    """1-based greedy colouring in joint order: two valid joints sharing a
    dynamic body get different colours; invalid joints get 0. A body index
    outside ``dynamic`` counts as static, as in the library."""
    body_a, body_b, dynamic, valid = _inputs(body_a, body_b, dynamic, valid)
    n_bodies = len(dynamic)
    colors = np.zeros(len(body_a), np.int32)
    masks: dict[int, int] = {}
    for j in range(len(body_a)):
        if not valid[j]:
            continue
        ends = [int(b) for b in (body_a[j], body_b[j])
                if 0 <= b < n_bodies and dynamic[b]]
        used = 0
        for b in ends:
            used |= masks.get(b, 0)
        c = 1
        while used & (1 << (c - 1)):
            c += 1
        colors[j] = c
        for b in ends:
            masks[b] = masks.get(b, 0) | (1 << (c - 1))
    return colors


def greedy_color(body_a, body_b, dynamic, valid=None) -> np.ndarray:
    """1-based greedy colouring of the joint graph (int32 [J]) by the
    native library; where it needs more than 64 colours, by
    :func:`greedy_color_plain` (no cap). Raises if the library does not
    build or load."""
    body_a, body_b, dynamic, valid = _inputs(body_a, body_b, dynamic, valid)
    colors = np.zeros(len(body_a), np.int32)
    rc = native_build.load().wg_greedy_color(
        body_a.ctypes.data_as(ctypes.c_void_p),
        body_b.ctypes.data_as(ctypes.c_void_p),
        dynamic.ctypes.data_as(ctypes.c_void_p),
        valid.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(len(body_a)), ctypes.c_int32(len(dynamic)),
        colors.ctypes.data_as(ctypes.c_void_p))
    if rc < 0:
        return greedy_color_plain(body_a, body_b, dynamic, valid)
    return colors


def _bvh_buffers(mins, maxs):
    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    n, dim = mins.shape
    if n == 0 or dim not in (2, 3) or maxs.shape != mins.shape:
        raise ValueError(f"build_bvh: {n} boxes of dim {dim}; at least one "
                         "box of dim 2 or 3 expected, mins and maxs alike")
    return (mins, maxs, np.zeros(max(n - 1, 1), np.int32),
            np.zeros(max(n - 1, 1), np.int32),
            np.zeros((2 * n - 1, dim), np.float32),
            np.zeros((2 * n - 1, dim), np.float32), np.zeros(n, np.int32))


def build_bvh_plain(mins, maxs):
    """The twin of :func:`build_bvh` in Python: each node splits its
    primitives at the median of their sorted centroids along the widest
    centroid axis. Returns ``(left, right, node_min, node_max, order)``:
    internal nodes 0..n-2 (root 0), leaf k at node k + n - 1 holding
    primitive ``order[k]``."""
    mins, maxs, left, right, node_min, node_max, order = _bvh_buffers(
        mins, maxs)
    n = len(mins)
    prims = list(range(n))
    count = {"internal": 0, "leaf": 0}

    def rec(lo, hi):
        if hi - lo == 1:
            k = count["leaf"]
            count["leaf"] += 1
            order[k] = prims[lo]
            node = k + (n - 1)
            node_min[node] = mins[prims[lo]]
            node_max[node] = maxs[prims[lo]]
            return node
        cents = (mins[prims[lo:hi]] + maxs[prims[lo:hi]]) / 2
        axis = int(np.argmax(cents.max(0) - cents.min(0)))
        prims[lo:hi] = sorted(prims[lo:hi],
                              key=lambda p: mins[p, axis] + maxs[p, axis])
        mid = (lo + hi) // 2
        node = count["internal"]
        count["internal"] += 1
        lo_node, hi_node = rec(lo, mid), rec(mid, hi)
        left[node], right[node] = lo_node, hi_node
        node_min[node] = np.minimum(node_min[lo_node], node_min[hi_node])
        node_max[node] = np.maximum(node_max[lo_node], node_max[hi_node])
        return node

    if n == 1:
        node_min[0], node_max[0] = mins[0], maxs[0]
    else:
        rec(0, n)
    return left, right, node_min, node_max, order


def build_bvh(mins, maxs):
    """A flattened median-split BVH over the boxes ``mins`` / ``maxs``
    [n, dim] by the native library (the layout of
    :func:`build_bvh_plain`). Raises if the library does not build or
    load."""
    bufs = _bvh_buffers(mins, maxs)
    n, dim = bufs[0].shape
    rc = native_build.load().wg_build_bvh(
        bufs[0].ctypes.data_as(ctypes.c_void_p),
        bufs[1].ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int32(n), ctypes.c_int32(dim),
        *(b.ctypes.data_as(ctypes.c_void_p) for b in bufs[2:]))
    if rc != 0:
        raise RuntimeError(f"wg_build_bvh returned {rc}")
    return bufs[2:]
