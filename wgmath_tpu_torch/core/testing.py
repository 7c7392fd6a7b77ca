"""Golden-test utilities (counterpart of ``wgmath_tpu/core/testing.py``).

:func:`assert_close` — numeric compare against a CPU reference at the
reference's f32 tolerance (rel 1e-3 for GEMM-class kernels).
:func:`random_sim3` — seeded random similarities as numpy arrays. The JAX
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


def random_sim3(rng: np.random.Generator, n: int):
    """``n`` random similarities as float32 numpy arrays: unit quaternions
    [n, 4] (xyzw), translations [n, 3] and scales [n] in [0.5, 2), drawn
    from ``rng`` in the JAX package's order (the same values for the same
    seed)."""
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32)
    s = rng.uniform(0.5, 2.0, size=(n,)).astype(np.float32)
    return q, t, s
