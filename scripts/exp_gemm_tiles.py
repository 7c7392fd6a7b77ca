"""Which tile depth and occupancy suit the hand-written GEMM kernel?

``csrc/gemm.cu`` keeps an 8 x 8 patch of sums per thread on a 128 x 128
tile. This script builds it with other values of two compile-time knobs,
``WG_TILE_BK`` (depth of a staged tile; 16 values a thread prefetches at
depth 16, 8 at depth 8) and ``WG_GEMM_MIN_BLOCKS`` (blocks per SM the
compiler must make room for: 2 caps a thread at 128 registers), and prints
for each build the registers and spills ptxas reports, agreement with
``torch.matmul`` and the device time per launch at the bench's sizes.

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

BUILDS = [(16, 1), (16, 2), (8, 1), (8, 2), (32, 1), (16, 1)]
CASES = [(1024, False), (2048, False), (2048, True), (4096, False)]


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_gemm_tiles: needs a CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    rng = np.random.default_rng(0)
    data = {}
    for n in sorted({n for n, _ in CASES}):
        data[n] = tuple(
            torch.from_numpy(x.astype(np.float32)).cuda() for x in
            (rng.normal(size=(n, n)), rng.normal(size=(n, n)) / np.sqrt(n)))
    base = list(cuda_build.NVCC_FLAGS)
    for bk, min_blocks in BUILDS:
        cuda_build.NVCC_FLAGS[:] = base + [f"-DWG_TILE_BK={bk}",
                                           f"-DWG_GEMM_MIN_BLOCKS={min_blocks}"]
        cuda_build.drop_loaded()
        cuda_build.load("gemm")
        regs = sorted({int(line.split("Used ")[1].split()[0])
                       for line in cuda_build.BUILD_LOG["gemm"].splitlines()
                       if "Used " in line})
        spills = sum(int(line.split("bytes spill stores")[0].split(",")[-1])
                     for line in cuda_build.BUILD_LOG["gemm"].splitlines()
                     if "spill stores" in line)
        out = []
        for n, ta in CASES:
            a, b = data[n]
            got = gemm_ops.gemm(a, b, transpose_a=ta)
            want = torch.matmul(a.T if ta else a, b)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            ms = statistics.median(device_times_ms(
                lambda: gemm_ops.gemm(a, b, transpose_a=ta)))
            out.append(f"n={n}{' tn' if ta else ' nn'} {ms:.4f} ms "
                       f"{2 * n ** 3 / ms / 1e9:.2f} TFLOP/s |d| {err:.1e}")
        print(f"BK={bk:2d} min_blocks={min_blocks} registers {regs} spill "
              f"stores {spills} B: " + "; ".join(out))
    cuda_build.NVCC_FLAGS[:] = base
    cuda_build.drop_loaded()
    return 0


if __name__ == "__main__":
    sys.exit(main())
