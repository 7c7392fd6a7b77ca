"""Batched quaternion algebra on ``[..., 4]`` tensors in xyzw order
(counterpart of ``wgmath_tpu/geometry/quat.py``: the functions the step
uses)."""

from __future__ import annotations

import torch


def identity(batch_shape=(), *, device=None) -> torch.Tensor:
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=torch.float32,
                    device=device)
    q[..., 3] = 1.0
    return q


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis (same term order as ``jnp.cross``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def norm(v: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=keepdim))


def from_scaled_axis(v: torch.Tensor) -> torch.Tensor:
    """Exponential map: rotation of angle |v| about axis v/|v| (3 → 4)."""
    angle = norm(v, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-6
    sinc_half = torch.where(small, 0.5 - angle * angle / 48.0,
                            torch.sin(half) / torch.clamp(angle, min=1e-30))
    return torch.cat([v * sinc_half, torch.cos(half)], dim=-1)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b."""
    ax, ay, az, aw = (a[..., i] for i in range(4))
    bx, by, bz, bw = (b[..., i] for i in range(4))
    return torch.stack([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ], dim=-1)


def conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


def normalize(q: torch.Tensor) -> torch.Tensor:
    return q * torch.rsqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-30)


def mul_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by unit q: v + 2 w (u×v) + 2 u×(u×v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def inv_mul_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return mul_vec(conj(q), v)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion → rotation matrix ``[..., 3, 3]``."""
    x, y, z, w = (q[..., i] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    rows = [
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ]
    return torch.stack(rows, dim=-2)
