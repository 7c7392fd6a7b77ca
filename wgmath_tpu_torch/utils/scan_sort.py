"""Prefix sums and a stable key/value sort (counterpart of
``wgmath_tpu/utils/scan_sort.py``).

In the JAX package each is one XLA op; here each is one PyTorch call
(``cumsum``, a stable ``sort``), with the same API and the numpy oracle.
Keys are the JAX package's uint32 / int32 values held in int64.
"""

from __future__ import annotations

import numpy as np
import torch

from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive scan along the last axis."""
    return torch.cumsum(x, dim=-1)


def prefix_sum_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive scan along the last axis (0 first)."""
    inc = torch.cumsum(x, dim=-1)
    return torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]], dim=-1)


def prefix_sum_cpu(x) -> np.ndarray:
    """NumPy oracle."""
    return np.cumsum(np.asarray(x), axis=-1)


def radix_sort(keys: torch.Tensor, values: torch.Tensor):
    """Stable key/value sort along the last axis: equal keys keep their
    values' order (``lax.sort_key_val``). Returns (keys, values)."""
    sorted_keys, perm = torch.sort(keys, dim=-1, stable=True)
    return sorted_keys, torch.gather(values, -1, perm)


def argsort_u32(keys: torch.Tensor) -> torch.Tensor:
    """Stable argsort (``jnp.argsort``)."""
    return torch.argsort(keys, dim=-1, stable=True)


def _ones(device):
    return torch.ones(4096, dtype=torch.int64, device=device)


register_module(
    KernelModule(
        "utils.scan_sort",
        provides={
            "prefix_sum": prefix_sum,
            "prefix_sum_exclusive": prefix_sum_exclusive,
            "radix_sort": radix_sort,
            "argsort_u32": argsort_u32,
        },
        entries={
            "prefix_sum": EntryPoint(fn=prefix_sum,
                                     example_args=lambda d: (_ones(d),)),
            "radix_sort": EntryPoint(fn=radix_sort,
                                     example_args=lambda d: (_ones(d),
                                                           _ones(d))),
        },
        doc="Scan + sort primitives (cumsum, stable key/value sort).",
    )
)
