"""PyTorch/CUDA port of ``wgmath_tpu`` for one NVIDIA H100.

The port does what the JAX package does, with the same module paths and
public names, and each of the JAX package's TPU kernels rewritten by hand
for Hopper (CUDA C++ in ``csrc/``, one Triton kernel in
``ops/elementwise.py``), each with a plain PyTorch twin that CPU tensors
take:

- ``core``: the kernel-module registry, dispatch helpers, profiling,
  strided views and the builds of the CUDA and native sources;
- ``ops``: GEMM, GEMV, reductions and the op-assign family;
- ``geometry``: quaternions, 2D rotations, similarities and the
  small-matrix decompositions;
- ``shapes``, ``queries``, ``broad_phase``: shapes, ray casts, point
  projection, GJK / EPA, SAT, contact manifolds, meshes, and the grid,
  brute-force and LBVH broad phases;
- ``dynamics``: bodies, contact constraints, joints and the solvers (the
  Gauss-Seidel impulse kernels of the window ladder and the fused solver);
- ``pipeline``: ``step``, ``multi_step`` and ``step_checked`` in 3D and
  2D, on one card or over ``torch.distributed`` ranks (``parallel``);
- ``scenes``, ``testbed``: the scene builders and the CLI runner.

What it leaves out, and why, is listed in ``tests/test_torch_api_parity.py``
(TPU-only helpers such as ``core/hostmem.py``, ``on_tpu`` and the Pallas
switches).

Entry points run on the card unless the caller passes CPU tensors or
``device="cpu"``:

    from wgmath_tpu_torch.dynamics import SimParams
    from wgmath_tpu_torch.pipeline import PipelineConfig, multi_step, step
    from wgmath_tpu_torch.scenes.builders import ball_pit
    from wgmath_tpu_torch.ops import gemm, reduce, op_assign_kernel

The package imports neither JAX nor the JAX package, and Triton and the
CUDA builds only when a kernel first launches.
"""

__version__ = "0.1.0"

from wgmath_tpu_torch.core import module as module  # noqa: F401
from wgmath_tpu_torch.core.module import (  # noqa: F401
    KernelModule,
    get_module,
    register_module,
)
