"""PyTorch/CUDA port of ``wgmath_tpu`` for one NVIDIA H100.

This slice covers one frame of the rigid-body pipeline on ball/cuboid
scenes under the chained pair-slot solver configuration; its Gauss-Seidel
impulse kernel is hand-written CUDA (``csrc/gs_math.cu``). Entry points run
on the card unless the caller passes ``device="cpu"``:

    from wgmath_tpu_torch.pipeline import step, step_checked
    from wgmath_tpu_torch.scenes.builders import ball_pit
    from wgmath_tpu_torch.convert import state_from_arrays

The package imports neither JAX nor the JAX package.
"""
