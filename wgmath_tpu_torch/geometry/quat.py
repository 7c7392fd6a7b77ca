"""Batched quaternion algebra on ``[..., 4]`` tensors in xyzw order
(counterpart of ``wgmath_tpu/geometry/quat.py``).

The ``*_soa`` functions take tuples of ``[N]`` component rows, the layout
the bench chains (``split_soa`` once, the ops K times, ``merge_soa`` at the
end). The JAX package also routes flat batches of 32,768 and more through
a transposed ``[4, N]`` layout, which only fills the TPU's 128 lanes and
computes the same terms; the port has no such route.
"""

from __future__ import annotations

import torch

from wgmath_tpu_torch.core.dispatch import resolve_device
from wgmath_tpu_torch.core.module import (
    EntryPoint,
    KernelModule,
    register_module,
)


def identity(batch_shape=(), *, device=None) -> torch.Tensor:
    """Unit quaternions; ``device`` None means the card."""
    q = torch.zeros(tuple(batch_shape) + (4,), dtype=torch.float32,
                    device=resolve_device(device))
    q[..., 3] = 1.0
    return q


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis (same term order as ``jnp.cross``)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a · b over the last axis, summed left to right (``torch.sum``'s order
    on the CPU depends on the buffers' alignment, so it can differ between
    two runs)."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = out + a[..., i] * b[..., i]
    return out


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
    """(-x, -y, -z, w): the same bits as a product with (-1, -1, -1, 1),
    with no constant made on the host (a CUDA graph may capture it)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def inv(q: torch.Tensor) -> torch.Tensor:
    """Inverse for unit quaternions (= conjugate)."""
    return conj(q)


def to_scaled_axis(q: torch.Tensor) -> torch.Tensor:
    """Logarithmic map (inverse of from_scaled_axis), for unit quaternions."""
    w = torch.clamp(q[..., 3:4], -1.0, 1.0)
    xyz = q[..., :3]
    n = norm(xyz, keepdim=True)
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(n < 1e-9, torch.full_like(n, 2.0),
                        angle / torch.clamp(n, min=1e-30))
    return xyz * scale


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


def from_matrix(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix ``[..., 3, 3]`` → unit quaternion (Shepperd's method:
    the four candidate constructions, the best one picked per element)."""
    m = r
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2

    s = root(1.0 + t)
    cand_w = torch.stack([(m[..., 2, 1] - m[..., 1, 2]) / s,
                          (m[..., 0, 2] - m[..., 2, 0]) / s,
                          (m[..., 1, 0] - m[..., 0, 1]) / s,
                          0.25 * s], dim=-1)
    s = root(1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2])
    cand_x = torch.stack([0.25 * s,
                          (m[..., 0, 1] + m[..., 1, 0]) / s,
                          (m[..., 0, 2] + m[..., 2, 0]) / s,
                          (m[..., 2, 1] - m[..., 1, 2]) / s], dim=-1)
    s = root(1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2])
    cand_y = torch.stack([(m[..., 0, 1] + m[..., 1, 0]) / s,
                          0.25 * s,
                          (m[..., 1, 2] + m[..., 2, 1]) / s,
                          (m[..., 0, 2] - m[..., 2, 0]) / s], dim=-1)
    s = root(1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2])
    cand_z = torch.stack([(m[..., 0, 2] + m[..., 2, 0]) / s,
                          (m[..., 1, 2] + m[..., 2, 1]) / s,
                          0.25 * s,
                          (m[..., 1, 0] - m[..., 0, 1]) / s], dim=-1)
    d = torch.stack([m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]], dim=-1)
    big = torch.argmax(d, dim=-1)
    by_diag = torch.where((big == 0)[..., None], cand_x,
                          torch.where((big == 1)[..., None], cand_y, cand_z))
    return normalize(torch.where((t > 0.0)[..., None], cand_w, by_diag))


def slerp(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation (shortest arc)."""
    d = dot(a, b)[..., None]
    b = torch.where(d < 0, -b, b)
    d = torch.abs(d)
    theta = torch.arccos(torch.clamp(d, -1.0, 1.0))
    sin_theta = torch.sin(theta)
    lin = normalize(a * (1 - t) + b * t)  # fallback when nearly parallel
    wa = torch.sin((1 - t) * theta) / torch.clamp(sin_theta, min=1e-30)
    wb = torch.sin(t * theta) / torch.clamp(sin_theta, min=1e-30)
    sph = a * wa + b * wb
    return torch.where(sin_theta < 1e-5, lin, sph)


# --- tuple-of-rows (SoA) storage ---------------------------------------------


def _mul_soa(a: tuple, b: tuple) -> tuple:
    """Hamilton product on tuples of component rows."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz)


def _mul_vec_soa(q: tuple, v: tuple) -> tuple:
    """Rotate a tuple-of-rows vector by a tuple-of-rows unit quaternion."""
    ux, uy, uz, w = q
    vx, vy, vz = v
    cx = uy * vz - uz * vy
    cy = uz * vx - ux * vz
    cz = ux * vy - uy * vx
    dx = uy * cz - uz * cy
    dy = uz * cx - ux * cz
    dz = ux * cy - uy * cx
    return (vx + 2.0 * (w * cx + dx),
            vy + 2.0 * (w * cy + dy),
            vz + 2.0 * (w * cz + dz))


def _conj_soa(q: tuple) -> tuple:
    ux, uy, uz, w = q
    return (-ux, -uy, -uz, w)


def split_soa(arr: torch.Tensor) -> tuple:
    """``[N, C]`` → tuple of C ``[N]`` component rows (contiguous copies, so
    every later op streams dense rows)."""
    return tuple(arr[:, i].contiguous() for i in range(arr.shape[1]))


def merge_soa(rows: tuple) -> torch.Tensor:
    """Inverse of :func:`split_soa`."""
    return torch.stack(rows, dim=-1)


def mul_vec_soa(q: tuple, v: tuple) -> tuple:
    """SoA rotate: tuple-of-rows quaternion x tuple-of-rows vectors."""
    return _mul_vec_soa(q, v)


def mul_soa(a: tuple, b: tuple) -> tuple:
    """SoA Hamilton product on tuples of component rows."""
    return _mul_soa(a, b)


def normalize_soa(q: tuple) -> tuple:
    x, y, z, w = q
    inv_n = torch.rsqrt(x * x + y * y + z * z + w * w + 1e-30)
    return (x * inv_n, y * inv_n, z * inv_n, w * inv_n)


register_module(
    KernelModule(
        "geometry.quat",
        provides={
            "quat_identity": identity,
            "quat_from_scaled_axis": from_scaled_axis,
            "quat_to_scaled_axis": to_scaled_axis,
            "quat_mul": mul,
            "quat_conj": conj,
            "quat_inv": inv,
            "quat_normalize": normalize,
            "quat_mul_vec": mul_vec,
            "quat_inv_mul_vec": inv_mul_vec,
            "quat_to_matrix": to_matrix,
            "quat_from_matrix": from_matrix,
            "quat_slerp": slerp,
        },
        entries={
            "rotate_batch": EntryPoint(
                fn=lambda q, v: mul_vec(normalize(q), v),
                example_args=lambda device: (
                    torch.ones((1024, 4), device=device),
                    torch.ones((1024, 3), device=device),
                ),
            )
        },
        doc="Composable quaternion ops.",
    )
)
