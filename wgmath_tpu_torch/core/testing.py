"""Golden-test utilities (counterpart of ``wgmath_tpu/core/testing.py``).

:func:`assert_close` — numeric compare against a CPU reference at the
reference's f32 tolerance (rel 1e-3 for GEMM-class kernels). The JAX
package's ``check_lowers`` has no counterpart: eager PyTorch lowers nothing,
and ``core.module.compile_check`` runs the entry points instead.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def assert_close(actual, expected, *, rtol: float = 1e-3, atol: float = 1e-5,
                 msg: str = ""):
    np.testing.assert_allclose(_to_numpy(actual), _to_numpy(expected),
                               rtol=rtol, atol=atol, err_msg=msg)
