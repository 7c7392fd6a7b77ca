"""Host-side scene-build kernels (counterpart of ``wgmath_tpu/native``):
greedy colouring of the joint graph, through the library
``wgnative.cpp`` that ``core/native_build.py`` builds at first use.

:func:`greedy_color` is the library's ``wg_greedy_color``;
:func:`greedy_color_plain` is its plain Python twin. Past 64 colours the
library gives up (it keeps one 64-bit mask a body) and the colouring is
finished by the twin, which has no cap, as the JAX package does."""

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
