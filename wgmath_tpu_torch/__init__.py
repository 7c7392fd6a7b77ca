"""PyTorch/CUDA port of ``wgmath_tpu`` for one NVIDIA H100.

Two parts of the JAX package are ported so far, each with its TPU kernels
rewritten by hand for Hopper:

- the rigid-body pipeline on ball/cuboid scenes under the ``gs_windows``
  ladder configurations (Gauss-Seidel impulse kernels ``csrc/gs_math.cu``
  and ``csrc/gs_math_block.cu``);
- the linear-algebra layer: the kernel-module registry and strided views
  (``core/module.py``, ``core/tensor.py``) and ``ops`` (GEMM in
  ``csrc/gemm.cu`` and ``csrc/gemm_split.cu``, reductions in
  ``csrc/reduce.cu``, the op-assign family as a Triton kernel).

Entry points run on the card unless the caller passes a CPU tensor or
``device="cpu"``:

    from wgmath_tpu_torch.pipeline import step, step_checked
    from wgmath_tpu_torch.scenes.builders import ball_pit
    from wgmath_tpu_torch.convert import state_from_arrays
    from wgmath_tpu_torch.ops import gemm, reduce, op_assign_kernel
    from wgmath_tpu_torch.core import compose, compile_check, view_of

The package imports neither JAX nor the JAX package.
"""
