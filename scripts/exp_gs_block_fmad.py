"""Does multiply-add contraction move the ``gs_math_block`` kernel away from
its plain PyTorch version?

The port builds every kernel with ``--fmad=false``: the rhs rebuild inside
``gs_math.cu`` needs it (a millimetre drift taken as the difference of two
world points, times 1/dt). ``gs_math_block.cu`` has no rhs rebuild, so this
script builds it both ways and prints, for each way, the worst
|kernel - plain| / (atol + rtol |plain|) over the ladder's rung sizes
(allclose holds at <= 1) and the time per launch.

Run from the repository root on a machine with a CUDA card and ``nvcc``::

    python3 scripts/exp_gs_block_fmad.py
"""

from __future__ import annotations

import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    ATOL,
    RTOL,
    device_times_ms,
    gs_block_inputs,
    gs_block_plain,
    nvidia_smi_line,
)
from wgmath_tpu_torch.core import cuda_build  # noqa: E402
from wgmath_tpu_torch.dynamics import gs_math  # noqa: E402

SHAPES = [(4096, 1), (2048, 1), (768, 1), (128, 1), (1024, 4)]


def main() -> int:
    if not torch.cuda.is_available():
        print("exp_gs_block_fmad: needs a CUDA device", file=sys.stderr)
        return 1
    print(nvidia_smi_line())
    base = list(cuda_build.NVCC_FLAGS)
    for label, flags in (("--fmad=false", base),
                         ("--fmad=true", [f for f in base
                                          if f != "--fmad=false"])):
        cuda_build.NVCC_FLAGS[:] = flags
        cuda_build._LIBS.pop("gs_math_block", None)
        rng = np.random.default_rng(20260)
        worst, times = 0.0, []
        for L, p_max in SHAPES:
            args, kw = gs_block_inputs(rng, L, p_max, "cuda")
            got = gs_math.gs_math_block(*args, **kw)
            want = gs_block_plain(*args, **kw)
            torch.cuda.synchronize()
            worst = max(worst, max(
                float(((g - w).abs() / (ATOL + RTOL * w.abs())).max())
                for g, w in zip(got, want)))
            times.append(statistics.median(device_times_ms(
                lambda: gs_math.gs_math_block(*args, **kw))))
        print(f"gs_math_block {label:13s} worst tolerance ratio "
              f"{worst:.4f} (rtol {RTOL}, atol {ATOL}); us/launch "
              + " ".join(f"{1e3 * t:.2f}" for t in times))
    cuda_build.NVCC_FLAGS[:] = base
    cuda_build._LIBS.pop("gs_math_block", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
