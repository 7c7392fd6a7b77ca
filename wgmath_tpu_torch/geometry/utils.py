"""Numeric helpers: the stable atan2 / atanh and the min / max helpers
(counterpart of ``wgmath_tpu/geometry/utils.py``, the reference's trig and
min-max utilities). The stable forms guard the (0, 0) pole of atan2 and
clip atanh's argument inside (-1, 1), as in the JAX package."""

from __future__ import annotations

import torch

from wgmath_tpu_torch.core.module import KernelModule, register_module


def stable_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 that returns 0 at the (0, 0) pole (|x|, |y| < 1e-38)."""
    both_zero = (torch.abs(x) < 1e-38) & (torch.abs(y) < 1e-38)
    return torch.where(both_zero, torch.zeros_like(y),
                       torch.atan2(y, torch.where(both_zero,
                                                  torch.ones_like(x), x)))


def stable_atanh(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, -1.0 + 1e-7, 1.0 - 1e-7)
    return 0.5 * torch.log((1 + x) / (1 - x))


def vec_min(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.minimum(a, b)


def vec_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.maximum(a, b)


def component_min(v: torch.Tensor) -> torch.Tensor:
    return torch.amin(v, dim=-1)


def component_max(v: torch.Tensor) -> torch.Tensor:
    return torch.amax(v, dim=-1)


register_module(
    KernelModule(
        "geometry.utils",
        provides={
            "stable_atan2": stable_atan2,
            "stable_atanh": stable_atanh,
            "vec_min": vec_min,
            "vec_max": vec_max,
            "component_min": component_min,
            "component_max": component_max,
        },
        doc="Trig + min/max helpers (the reference's utils/trig.rs, "
            "utils/min_max.rs).",
    )
)
