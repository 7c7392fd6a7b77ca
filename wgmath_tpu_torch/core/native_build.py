"""Build the host-side C++ library ``native/wgnative.cpp`` at first use and
load it with ctypes (the counterpart of ``core/cuda_build.py`` for code
that runs on the CPU: the scene-build kernels that colour the joints and
build a median-split BVH).

``g++ -O3 -shared -fPIC`` compiles it into
``wgmath_tpu_torch/_build/wgnative-<source hash>.so`` (a directory git
ignores), so a changed source rebuilds and an unchanged one loads at once.
A failed build or load raises: nothing falls back to another route.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

from wgmath_tpu_torch.core.cuda_build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native",
                      "wgnative.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_LIB: list = []  # the loaded library, once


def target() -> str:
    """The library's path for the current source and flags."""
    h = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"wgnative-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless this source's build exists; returns its
    path. Raises with the compiler's output when ``g++`` fails."""
    out = target()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: wgmath_tpu_torch's native library "
                           "builds with the host C++ compiler")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library with ``wg_greedy_color`` and ``wg_build_bvh``
    bound, built on first use."""
    if not _LIB:
        lib = ctypes.CDLL(build())
        fn = lib.wg_greedy_color
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int32] * 2 + [
            ctypes.c_void_p]
        fn = lib.wg_build_bvh
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int32] * 2 + [
            ctypes.c_void_p] * 5
        _LIB.append(lib)
    return _LIB[0]
