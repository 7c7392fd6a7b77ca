"""Batched 2D rotations as (cos, sin) pairs on ``[..., 2]`` tensors
(counterpart of ``wgmath_tpu/geometry/rot2.py``)."""

from __future__ import annotations

import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)


def identity(batch_shape=(), *, device=None) -> torch.Tensor:
    """Identity rotations; ``device`` None means the card."""
    r = torch.zeros(tuple(batch_shape) + (2,), dtype=torch.float32,
                    device=resolve_device(device))
    r[..., 0] = 1.0
    return r


def from_angle(theta: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)


def angle(r: torch.Tensor) -> torch.Tensor:
    return torch.atan2(r[..., 1], r[..., 0])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ca, sa = a[..., 0], a[..., 1]
    cb, sb = b[..., 0], b[..., 1]
    return torch.stack([ca * cb - sa * sb, sa * cb + ca * sb], dim=-1)


def inv(r: torch.Tensor) -> torch.Tensor:
    return torch.stack([r[..., 0], -r[..., 1]], dim=-1)


def normalize(r: torch.Tensor) -> torch.Tensor:
    return r * torch.rsqrt(torch.sum(r * r, dim=-1, keepdim=True) + 1e-30)


def mul_vec(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    c, s = r[..., 0], r[..., 1]
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], dim=-1)


def inv_mul_vec(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return mul_vec(inv(r), v)


def to_matrix(r: torch.Tensor) -> torch.Tensor:
    c, s = r[..., 0], r[..., 1]
    return torch.stack([torch.stack([c, -s], dim=-1),
                        torch.stack([s, c], dim=-1)], dim=-2)


register_module(
    KernelModule(
        "geometry.rot2",
        provides={
            "rot2_identity": identity,
            "rot2_from_angle": from_angle,
            "rot2_angle": angle,
            "rot2_mul": mul,
            "rot2_inv": inv,
            "rot2_normalize": normalize,
            "rot2_mul_vec": mul_vec,
            "rot2_inv_mul_vec": inv_mul_vec,
            "rot2_to_matrix": to_matrix,
        },
        entries={
            "rotate2_batch": EntryPoint(
                fn=lambda r, v: mul_vec(normalize(r), v),
                example_args=lambda device: (
                    torch.ones((1024, 2), device=device),
                    torch.ones((1024, 2), device=device),
                ),
            )
        },
        doc="Composable 2D rotation ops.",
    )
)
