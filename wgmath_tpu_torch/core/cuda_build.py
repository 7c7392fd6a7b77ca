"""Build the hand-written CUDA kernels at first use and load them with
ctypes.

Each ``csrc/*.cu`` file has a plain C interface and is compiled on its own
by ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into
``wgmath_tpu_torch/_build/<name>-<source hash>.so`` (a directory git
ignores), so a changed source rebuilds and an unchanged one loads at once.
The hash covers the shared ``csrc/*.cuh`` headers too.
:func:`build_all` starts one ``nvcc`` per source, all together.
No fast-math flags: the kernels' epsilon tests must behave as in the
reference. ``--fmad=false`` keeps every product rounded on its own, as in
the plain PyTorch versions: the GS rhs rebuild subtracts two world points
of the size of the pit (~20 m) to get a millimetre drift, and contracting
either side into a fused multiply-add moves that drift by ~1e-6, which
the 1/dt factor turns into a visible impulse difference. The flag is one
for every source; the product kernels (``gemm.cu``, ``gemm_split.cu``)
write ``fmaf()`` where they want the fused operation, which the flag does
not touch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for path in [src] + [os.path.join(CSRC, f) for f in headers]:
        with open(path, "rb") as fh:
            h.update(fh.read())
    digest = h.hexdigest()[:12]
    return src, os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def _start(name: str):
    src, out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, started) -> None:
    if started is None:
        BUILD_SECONDS.setdefault(name, 0.0)
        return
    proc, tmp, out, t0 = started
    log, _ = proc.communicate()
    BUILD_LOG[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_SECONDS[name] = time.perf_counter() - t0


def build_all(names) -> None:
    """Compile every named source in parallel (no-op for built ones)."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        _finish(n, s)


def drop_loaded() -> None:
    """Forget every loaded library, so the next :func:`load` hashes its
    source again and an edited ``.cu`` is rebuilt and picked up."""
    _LIBS.clear()


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_target(name)[1])
        _LIBS[name] = lib
    return lib
