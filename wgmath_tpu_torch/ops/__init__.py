"""Dense batched linear algebra (counterpart of ``wgmath_tpu/ops``).

GEMM, GEMV and the full reductions are hand-written CUDA kernels, the
op-assign family a hand-written Triton kernel; each has a plain PyTorch version that
runs for CPU tensors.
"""

from wgmath_tpu_torch.ops.gemm import gemm, gemm_torch  # noqa: F401
from wgmath_tpu_torch.ops.gemv import gemv, gemv_torch, gemv_xla  # noqa: F401
from wgmath_tpu_torch.ops.elementwise import (  # noqa: F401
    op_assign,
    op_assign_kernel,
    VARIANTS,
)
from wgmath_tpu_torch.ops.reduce import reduce, eval_cpu  # noqa: F401
