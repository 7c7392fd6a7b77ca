"""How much does each way of fetching tiles give the tensor-core GEMM kernel?

``csrc/gemm.cu`` copies every operand tile into a raw shared-memory stage
before it splits and transposes it for the tensor cores, by one of three
routes: TMA (one thread per tile, where the operand's rows are 16-byte
aligned), ``cp.async`` of 16 bytes by every thread, or element by element.
This script builds the kernel with the compile-time cap
``WG_GEMM_MAX_FETCH`` at each route (0, 1, 2) and prints, for each build,
the registers and spills ptxas reports, agreement with ``torch.matmul`` and
the device time per launch at the bench's f32 sizes, plain and with A
transposed, beside ``torch.matmul`` in full f32.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_gemm_tiles.py
"""

from __future__ import annotations

import importlib
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import device_times_ms, nvidia_smi_line  # noqa: E402
from wgmath_tpu_torch.core import cuda_build  # noqa: E402

gemm_ops = importlib.import_module("wgmath_tpu_torch.ops.gemm")

ROUTES = {0: "element by element", 1: "cp.async 16 B", 2: "TMA"}
CASES = [(1024, False), (2048, False), (4096, False), (4096, True)]


def _ms(fn) -> float:
    return statistics.median(device_times_ms(fn))


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_gemm_tiles: needs a CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    data = {}
    for n in sorted({n for n, _ in CASES}):
        data[n] = tuple(
            torch.from_numpy(x.astype(np.float32)).cuda() for x in
            (rng.normal(size=(n, n)), rng.normal(size=(n, n)) / np.sqrt(n)))
    print("torch.matmul f32: " + "; ".join(
        f"n={n} {_ms(lambda: torch.matmul(*data[n])):.4f} ms"
        for n in sorted(data)))
    base = list(cuda_build.NVCC_FLAGS)
    for cap, route in ROUTES.items():
        cuda_build.NVCC_FLAGS[:] = base + [f"-DWG_GEMM_MAX_FETCH={cap}"]
        cuda_build.drop_loaded()
        cuda_build.load("gemm")
        log = cuda_build.BUILD_LOG["gemm"].splitlines()
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in log if "Used " in line})
        spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                     for line in log if "spill stores" in line)
        out = []
        for n, ta in CASES:
            a, b = data[n]
            got = gemm_ops.gemm(a, b, transpose_a=ta)
            want = torch.matmul(a.T if ta else a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ms = _ms(lambda: gemm_ops.gemm(a, b, transpose_a=ta))
            out.append(f"n={n}{' tn' if ta else ' nn'} {ms:.4f} ms "
                       f"{2 * n ** 3 / ms / 1e9:.2f} TFLOP/s |d| {err:.1e}")
        print(f"fetch at most {cap} ({route}): registers {regs} spill "
              f"stores {spills} B: " + "; ".join(out))
    cuda_build.NVCC_FLAGS[:] = base
    cuda_build.drop_loaded()
    return 0


if __name__ == "__main__":
    sys.exit(main())
