"""Core runtime: kernel-module registry, dispatch helpers, views, and the
build of the hand-written CUDA kernels (counterpart of ``wgmath_tpu/core``)."""

from wgmath_tpu_torch.core.module import (  # noqa: F401
    KernelModule,
    register_module,
    get_module,
    compose,
    flat_source,
    compile_check,
    all_modules,
)
from wgmath_tpu_torch.core.dispatch import (  # noqa: F401
    cdiv,
    round_up,
    next_power_of_two,
    capacity_bucket,
    resolve_device,
)
from wgmath_tpu_torch.core.profiling import RunStats, PhaseTimer  # noqa: F401
from wgmath_tpu_torch.core.tensor import View, view_of  # noqa: F401
